"""Fused SASA occlusion counts: no neighbor lists, no top-k, no gathers.

The list-based path pays for an [N,N] distance matrix, a top-k sort and a
large irregular gather.  This module replaces the whole neighbor pipeline
with a tiled direct evaluation (the analog of the reference's cell list,
reference: src/structures/spatial_grid.rs):

  * atoms are Morton-sorted per structure (host side) so spatial locality
    maps to tile locality;
  * culling happens at TWO granularities - 128-atom tile pairs, plus a
    16-bit mask of which 8-atom j-groups are in reach (the analog of the
    reference's half-shell cell iteration, spatial_grid.rs:174-192).
    The production path computes the j-lists on the device
    (build_jlist_banded: the host only centers/sorts/quantizes); the host
    packers (pack_structures) produce the same format for structures the
    banded path can't take (>127 tiles, non-unique gids, >1300 A extent).
    Each j-list entry is a u32: (group_mask << 16) | j_tile_id;
  * the counts stage (_occlusion_counts_kernel) evaluates, for every
    admitted j-atom, the occlusion margin of each (sphere point, i-atom)
    pair in exact f32:
        margin = (thr_j - |v|^2 - r_eff_i^2)/(2 r_eff_i) - dot(s_p, v)
    and a point is occluded iff margin > 0 for any neighbor.  The margin
    self-masks out-of-reach pairs (limit < -|v| whenever
    |v| > r_eff_i + r_j + probe), so no per-pair cutoff test is needed.

The counts stage is a Pallas kernel on the Triton route.  The work per
i-tile depends on the data (each tile has its own j-list length, each
admitted j-tile its own group mask), which plain XLA can only run at the
full band and every group: counts_xla is that plain version, kept as the
reference the kernel is tested against.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

ATOM_TILE = 128
_NEG_BIG = np.float32(-1e30)

# planes rows: x, y, z, r_eff, gid(+1, 0=padding), unused*3
N_PLANES = 8
# j-list column layout (u32): col 0 = count, cols 1..count = entries
# (group_mask << 16) | j_tile_id.  Mask bit g covers j-atoms
# [8g, 8g+8) of that tile.
JLIST_ROWS = 128
JLIST_CAP = JLIST_ROWS - 1
# j-atoms per masked group.
J_GROUP = 8
GROUPS_PER_TILE = ATOM_TILE // J_GROUP

# Kernel block sizes (powers of two, as the Triton route requires).  A
# program owns ATOM_BLOCK i-atoms (inside one 128-atom j-list tile) and
# POINT_BLOCK sphere points; the occlusion margins of the block live in
# registers for the whole j-list walk.  Chosen by a sweep on an H100 at a
# 2M-slot chunk: 100 points pad to 112 in blocks of 16 (to 128 in blocks
# of 32), and [64, 128] margin blocks spill registers at 4 warps.
ATOM_BLOCK = 128
POINT_BLOCK = 16
_NUM_WARPS = 4


class JListOverflow(ValueError):
    """An i-tile has more than JLIST_CAP in-reach j-tiles."""


def _occlusion_counts_kernel(
    sphere_ref,  # [4, POINT_BLOCK] f32: sx, sy, sz, point_valid
    planes_ref,  # [N_PLANES, ATOM_BLOCK] f32: this block's i-atoms
    jlist_ref,  # [1, JLIST_ROWS] i32: the j-list row of the i-atoms' tile
    atoms_ref,  # [M, N_PLANES] f32: every atom, atom-major
    out_ref,  # [1, ATOM_BLOCK] f32: accessible-point counts
):
    xi = planes_ref[0, :]
    yi = planes_ref[1, :]
    zi = planes_ref[2, :]
    reffi = planes_ref[3, :]
    gidi = planes_ref[4, :]
    r2i = reffi * reffi
    inv2ri = 0.5 / jnp.maximum(reffi, 1e-6)
    sx = sphere_ref[0, :][:, None]
    sy = sphere_ref[1, :][:, None]
    sz = sphere_ref[2, :][:, None]
    point_valid = sphere_ref[3, :][:, None] > 0.0

    def j_atom(row, occ):
        # Scalars load straight from the ref: a dynamic index into a
        # loaded block does not lower on this route.
        xk = atoms_ref[row, 0]
        yk = atoms_ref[row, 1]
        zk = atoms_ref[row, 2]
        rk = atoms_ref[row, 3]
        gk = atoms_ref[row, 4]
        vx = xi - xk
        vy = yi - yk
        vz = zi - zk
        v2 = vx * vx + vy * vy + vz * vz
        lim = (rk * rk - v2 - r2i) * inv2ri
        lim = jnp.where((gidi == gk) | (gk == 0.0), _NEG_BIG, lim)
        dots = sx * vx[None, :] + (sy * vy[None, :] + sz * vz[None, :])
        return jnp.maximum(occ, lim[None, :] - dots)

    def entry(e, occ):
        ent = jlist_ref[0, e + 1]
        j_base = jax.lax.bitwise_and(ent, 0xFFFF) * ATOM_TILE
        mask = jax.lax.shift_right_logical(ent, 16)

        # Walk the set bits of the group mask: clear groups cost nothing,
        # and the loop condition is uniform across the program.
        def group(carry):
            mask, occ = carry
            low = jax.lax.bitwise_and(mask, -mask)
            g = jax.lax.population_count(low - 1)
            base = j_base + g * J_GROUP
            for k in range(J_GROUP):
                occ = j_atom(base + k, occ)
            return jax.lax.bitwise_xor(mask, low), occ

        return jax.lax.while_loop(lambda c: c[0] != 0, group, (mask, occ))[1]

    occ0 = jnp.full((sx.shape[0], xi.shape[0]), _NEG_BIG, jnp.float32)
    occ = jax.lax.fori_loop(0, jlist_ref[0, 0], entry, occ0)
    # Occluded iff the accumulated margin is strictly positive
    # (matches the reference's `dot < limit` strict comparison, lib.rs:146).
    out_ref[0, :] = jnp.sum(
        jnp.where((occ <= 0.0) & point_valid, 1.0, 0.0), axis=0
    )


# Rows of the host->device transfer format: x, y, z, r_eff, gid(+1).
# The kernel works on N_PLANES(=8)-row blocks; the 3 spare rows are
# zero-padded on device so they never ride the host link.
N_XFER_PLANES = 5


def _jlist_i32(jlist):
    if jlist.dtype == jnp.uint32:
        # Bit-preserving: entries with group-mask bit 15 set would
        # overflow a value cast; the decoders use logical shifts.
        return jax.lax.bitcast_convert_type(jlist, jnp.int32)
    return jlist.astype(jnp.int32)


def _counts_call(planes, jlist, sphere, *, interpret):
    """Occlusion counts kernel: planes [8, M] f32 -> counts [M] f32.

    sphere: [P, 4] f32 (x, y, z, point_valid).  Points are a grid axis,
    so any n_points works; each point block's partial counts are summed
    here.
    """
    m = planes.shape[1]
    jlist = _jlist_i32(jlist)
    p = sphere.shape[0]
    n_pblocks = -(-p // POINT_BLOCK)
    # [4, P_pad]: rows x, y, z, valid; padding points are invalid.
    sphere4 = jnp.pad(sphere.T, ((0, 0), (0, n_pblocks * POINT_BLOCK - p)))
    tiles_per_block = ATOM_TILE // ATOM_BLOCK
    counts = pl.pallas_call(
        _occlusion_counts_kernel,
        grid=(n_pblocks, m // ATOM_BLOCK),
        in_specs=[
            pl.BlockSpec((4, POINT_BLOCK), lambda p, i: (0, p)),
            pl.BlockSpec((N_PLANES, ATOM_BLOCK), lambda p, i: (0, i)),
            pl.BlockSpec(
                (1, JLIST_ROWS), lambda p, i: (i // tiles_per_block, 0)
            ),
            pl.BlockSpec(),  # every atom: j-atoms are read by index
        ],
        out_specs=pl.BlockSpec((1, ATOM_BLOCK), lambda p, i: (p, i)),
        out_shape=jax.ShapeDtypeStruct((n_pblocks, m), jnp.float32),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=_NUM_WARPS),
        interpret=interpret,
        name="sasa_occlusion_counts",
    )(sphere4, planes, jlist, planes.T)
    return jnp.sum(counts, axis=0)


@jax.jit
def counts_xla(planes, jlist, sphere):
    """Plain XLA occlusion counts over the same j-lists (the reference).

    Scans the j-list entries; each step gathers every tile's j-tile, sets
    masked-out groups to -inf and takes the max over j.  It runs every
    tile to the longest row and every group of each admitted j-tile, so
    it does the work the kernel skips.  Same inputs and result as
    _counts_call.
    """
    m = planes.shape[1]
    t = m // ATOM_TILE
    jlist = _jlist_i32(jlist)
    atoms = planes.T.reshape(t, ATOM_TILE, N_PLANES)
    xi, yi, zi, reffi, gidi = (
        planes[r].reshape(t, 1, ATOM_TILE) for r in range(5)
    )
    r2i = reffi * reffi
    inv2ri = 0.5 / jnp.maximum(reffi, 1e-6)
    sx, sy, sz = (sphere[:, c] for c in range(3))
    point_valid = sphere[:, 3] > 0.0
    cnt = jlist[:, 0]
    group_of = jnp.arange(ATOM_TILE, dtype=jnp.int32) // J_GROUP

    def step(e, occluded):
        ent = jax.lax.dynamic_index_in_dim(jlist, e + 1, axis=1,
                                           keepdims=False)
        jt = jax.lax.bitwise_and(ent, 0xFFFF)
        mask = jax.lax.shift_right_logical(ent, 16)
        ja = atoms[jt]  # [T, 128 j, 8]
        xk, yk, zk, rk, gk = (ja[:, :, r:r + 1] for r in range(5))
        admitted = (
            (e < cnt)[:, None]
            & ((mask[:, None] >> group_of[None, :]) & 1 == 1)
        )[:, :, None]
        vx = xi - xk  # [T, j, i]
        vy = yi - yk
        vz = zi - zk
        v2 = vx * vx + vy * vy + vz * vz
        lim = (rk * rk - v2 - r2i) * inv2ri
        lim = jnp.where(
            admitted & (gidi != gk) & (gk != 0.0), lim, _NEG_BIG
        )
        dots = sx * vx[..., None] + (sy * vy[..., None] + sz * vz[..., None])
        return occluded | (jnp.max(lim[..., None] - dots, axis=1) > 0.0)

    occluded = jax.lax.fori_loop(
        0, jnp.max(cnt), step,
        jnp.zeros((t, ATOM_TILE, sphere.shape[0]), dtype=bool),
    )
    counts = jnp.sum(~occluded & point_valid, axis=-1, dtype=jnp.float32)
    return counts.reshape(m)


@functools.partial(
    jax.jit, static_argnames=("n_points", "out_dtype", "interpret")
)
def fused_sasa(
    planes5: jnp.ndarray,  # [N_XFER_PLANES, M] f32
    jlist: jnp.ndarray,  # [T, JLIST_ROWS] u32 (mask<<16)|tile_id
    sphere: jnp.ndarray,  # [P, 4] f32: x, y, z, point_valid
    *,
    n_points: int,
    out_dtype=jnp.float32,
    interpret: bool = False,
) -> jnp.ndarray:
    """Legacy f32-planes entry (fallback path: non-unique gids etc.)."""
    m = planes5.shape[1]
    # Everything derivable from the 5 transfer planes is computed on
    # device: the host link moves 20B/atom-slot, not 44.
    planes = jnp.zeros((N_PLANES, m), dtype=jnp.float32)
    planes = planes.at[0:N_XFER_PLANES].set(planes5)
    r_eff = planes5[3]
    area = jnp.where(
        planes5[4] > 0.0,
        np.float32(4.0 * np.pi / n_points) * r_eff * r_eff,
        0.0,
    )
    counts = _counts_call(planes, jlist, sphere, interpret=interpret)
    return (counts.reshape(m) * area).astype(out_dtype)


# Fixed radius dequant scale: r_eff = qr * 2^-13 (exact in f32); covers
# r_eff < 8 A at 1.2e-4 A resolution.  qr == 0 marks padding slots.
R_QUANT = 8192.0

# q13 wire format (6 B/atom-slot vs q16's 8, a quarter fewer bytes over
# the host link).  Coordinates ride as 13-bit against the structure box
# (step = extent/8191 <= 0.0122 A at the 100 A cap; structures above
# the cap keep the noise-free q16 wire) and r_eff as an 8-bit
# index into a per-chunk palette of EXACT f32 values (ProtOr + probe
# resolve to ~21 distinct radii), so dequantized radii are bit-identical
# to the f32 path.  Layout (3x13 + 8 = 47 of 48 bits):
#   wire_a u32[M]: qx(13) | qy(13) | qz_hi(6)
#   wire_b u16[M]: qz_lo(7) | palette_index(8) | spare(1)
# palette[0] = 0 is reserved: index 0 marks padding slots.
# Quality gate (88-PDB, deterministic): residue-chain RMSE 43.64
# (q16-only) -> 45.92 (limit 63.99).  Quantization biases SASA slightly
# upward (example.cif: +16 A^2 over the f32 path's 20096.6).
MAX_Q13_EXTENT = 100.0

# Band widths for the DEVICE-side culling path: a chunk whose largest
# structure has <= w tiles builds its j-lists on the device (see
# build_jlist_banded).  127 = JLIST_CAP, so a full band can never
# overflow a j-list row; chunks with bigger structures use the host
# culling path.  The ladder is finer at the small end: the banded
# build's cost is proportional to the band width nd = 2w-1, and typical
# AlphaFold-scale proteins (1-4k atoms = 8-32 tiles) otherwise pay a
# 32-tile band - w=16/24 cut the per-chunk build ~25-50% for them.
W_BUCKETS = (16, 24, 32, 64, 127)

# Slack for the device-side AABB cull.  Unlike the host cull (which must
# stay conservative across u16 quantization, CULL_SLACK=0.08), the
# device cull and the kernel read the SAME dequantized f32 coordinates,
# so only f32 rounding of the separation test needs covering (~1e-4 on
# protein-scale values).
DEVICE_CULL_SLACK = 0.01
# Conservative reach slack added during tile-pair culling so the cull
# stays valid for coordinates quantized at up to ~1300 A structure extent
# (u16 step <= 0.02 A; see quantize_packed).  Larger structures use the
# legacy f32 path.
CULL_SLACK = 0.08
MAX_Q_EXTENT = 1300.0


@functools.partial(jax.jit, static_argnames=("n_points", "interpret"))
def fused_sasa_q16(
    planes4: jnp.ndarray,  # [4, M] u16: qx, qy, qz, qr
    tparams: jnp.ndarray,  # [T, 4] f32: ox, oy, oz, cscale per tile
    jlist: jnp.ndarray,  # [T, JLIST_ROWS] u32 (mask<<16)|tile_id
    sphere: jnp.ndarray,  # [P, 4] f32: x, y, z, point_valid
    *,
    n_points: int,
    interpret: bool = False,
) -> jnp.ndarray:
    """Quantized-wire entry: 8B/atom-slot over the host link, occlusion
    COUNTS back (u8, or u16 when n_points > 255).

    Coordinates ride as u16 against a per-structure box (step <=
    extent/65535, <= 0.002 A for typical proteins) and radii as u16 * 2^-13.  Gids are synthesized on device
    as the slot index - valid whenever the structure's gids are unique
    per atom (the packer verifies; others use the legacy path).  SASA is
    reconstructed on host as counts * 4*pi*r_eff^2/n, which is EXACT
    f32 - unlike the old f16 area readback.
    """
    m = planes4.shape[1]
    q = planes4.astype(jnp.float32)  # [4, M]
    par = jnp.repeat(tparams, ATOM_TILE, axis=0)  # [M, 4]
    planes = jnp.zeros((N_PLANES, m), dtype=jnp.float32)
    planes = planes.at[0].set(q[0] * par[:, 3] + par[:, 0])
    planes = planes.at[1].set(q[1] * par[:, 3] + par[:, 1])
    planes = planes.at[2].set(q[2] * par[:, 3] + par[:, 2])
    planes = planes.at[3].set(q[3] * np.float32(1.0 / R_QUANT))
    slot_gid = jnp.arange(m, dtype=jnp.float32) + 1.0
    planes = planes.at[4].set(jnp.where(q[3] > 0.0, slot_gid, 0.0))
    counts = _counts_call(planes, jlist, sphere, interpret=interpret)
    out_dtype = jnp.uint8 if n_points <= 255 else jnp.uint16
    return counts.reshape(m).astype(out_dtype)


def planes_q13(wire_a, wire_b, palette, tparams):
    """Dequantize the q13 wire -> (planes [8, M] f32, qvalid [M] bool)."""
    m = wire_a.shape[0]
    wa = wire_a.astype(jnp.uint32)
    wb = wire_b.astype(jnp.uint32)
    qx = (wa & 0x1FFF).astype(jnp.float32)
    qy = ((wa >> 13) & 0x1FFF).astype(jnp.float32)
    qz = (((wa >> 26) & 0x3F) << 7 | (wb & 0x7F)).astype(jnp.float32)
    ridx = ((wb >> 7) & 0xFF).astype(jnp.int32)
    # Gather-free palette lookup: the iota-compare select-sum fuses into
    # one elementwise pass and is EXACT (picks the f32 palette value,
    # adds only zeros).
    r_eff = jnp.sum(
        jnp.where(
            ridx[:, None]
            == jnp.arange(palette.shape[0], dtype=jnp.int32)[None, :],
            palette[None, :],
            0.0,
        ),
        axis=1,
    )
    par = jnp.repeat(tparams, ATOM_TILE, axis=0)
    planes = jnp.zeros((N_PLANES, m), dtype=jnp.float32)
    planes = planes.at[0].set(qx * par[:, 3] + par[:, 0])
    planes = planes.at[1].set(qy * par[:, 3] + par[:, 1])
    planes = planes.at[2].set(qz * par[:, 3] + par[:, 2])
    planes = planes.at[3].set(r_eff)
    qvalid = ridx > 0
    slot_gid = jnp.arange(m, dtype=jnp.float32) + 1.0
    planes = planes.at[4].set(jnp.where(qvalid, slot_gid, 0.0))
    return planes, qvalid


@functools.partial(jax.jit, static_argnames=("n_points", "w", "interpret"))
def fused_sasa_q13_banded(
    wire_a: jnp.ndarray,  # [M] u32: qx|qy|qz_hi
    wire_b: jnp.ndarray,  # [M] u16: qz_lo|palette_idx
    palette: jnp.ndarray,  # [256] f32 r_eff values, [0] = 0 (padding)
    tparams: jnp.ndarray,  # [T, 4] f32: ox, oy, oz, cscale per tile
    tmeta: jnp.ndarray,  # [T, 2] i32: (tile_start, ts_len) per tile
    sphere: jnp.ndarray,  # [P, 4] f32: x, y, z, point_valid
    *,
    n_points: int,
    w: int,
    interpret: bool = False,
) -> jnp.ndarray:
    """6 B/slot wire + device-side culling (see MAX_Q13_EXTENT note)."""
    planes, qvalid = planes_q13(wire_a, wire_b, palette, tparams)
    jlist = build_jlist_banded(planes, qvalid, tmeta, w=w)
    counts = _counts_call(planes, jlist, sphere, interpret=interpret)
    out_dtype = jnp.uint8 if n_points <= 255 else jnp.uint16
    return counts.astype(out_dtype)


def pack_structures_q13(structures: list, probe: float):
    """Host packing for the 6 B/slot q13 wire (numpy spec).

    Same contract as pack_structures_q16 but returns
    (wire_a [M] u32, wire_b [M] u16, palette [256] f32, tparams, tmeta,
    offsets), or None when any structure is ineligible (extent >
    MAX_Q13_EXTENT, or more than 255 distinct r_eff values in the chunk
    — e.g. occupancy-column radii) — the caller falls back to q16.
    The native C++ packer (fastpack_q13) implements the same layout.
    """
    from ..native import fastpack_q13

    out = fastpack_q13(structures, float(probe))
    if out is not None:
        return out if out != "ineligible" else None
    return _pack_structures_q13_numpy(structures, probe)


def _pack_structures_q13_numpy(structures: list, probe: float):
    tiles_per = [-(-s[0].shape[0] // ATOM_TILE) for s in structures]
    total_tiles = sum(tiles_per)
    if total_tiles > 65535:
        raise ValueError(
            f"chunk too large for u16 tile ids: {total_tiles} tiles"
        )
    m = total_tiles * ATOM_TILE
    wire_a = np.zeros(m, dtype=np.uint32)
    wire_b = np.zeros(m, dtype=np.uint16)
    tparams = np.zeros((total_tiles, 4), dtype=np.float32)
    tparams[:, 3] = 1.0
    tmeta = np.zeros((total_tiles, 2), dtype=np.int32)

    # Chunk-global radius palette, keyed by the exact qr bucket (1/8192 A
    # grid — ProtOr radii are spaced >= 0.01 A so buckets never collide).
    # Index 0 is reserved to mark padding slots.
    qr_to_idx = np.zeros(65536, dtype=np.uint16)
    palette = np.zeros(256, dtype=np.float32)
    n_pal = 1

    offsets = []
    tile0 = 0
    pos = 0
    for coords, radii, _gids in structures:
        n = coords.shape[0]
        nt = -(-n // ATOM_TILE)
        center = np.round(
            coords.mean(axis=0, dtype=np.float64) * 256.0
        ) / 256.0
        c = coords - center.astype(np.float32)
        order = np.argsort(_morton_codes(c), kind="stable")
        inv = np.empty(n, dtype=np.int64)
        inv[order] = np.arange(n)
        c = c[order]
        r_eff = (radii[order] + np.float32(probe)).astype(np.float32)

        cmin = c.min(axis=0)
        extent = float((c.max(axis=0) - cmin).max())
        if not extent <= MAX_Q13_EXTENT:  # NaN-safe negation
            return None
        scale = np.float32(max(extent, 1e-6) / 8191.0)
        q = np.clip(
            np.rint((c - cmin[None, :]) / scale), 0, 8191
        ).astype(np.uint32)

        qr = np.rint(r_eff * R_QUANT)
        if not (
            float(qr.max(initial=0.0)) <= 65535.0
            and float(qr.min(initial=1.0)) >= 1.0
        ):  # NaN-safe negation
            return None
        qr = qr.astype(np.int64)
        # Palette registration in INPUT-atom order (first-seen), exactly
        # like the native packer's prescan, so both emit identical bytes.
        r_in = (np.asarray(radii, dtype=np.float32) + np.float32(probe))
        qr_in = np.rint(r_in * R_QUANT).astype(np.int64)
        uniq, first = np.unique(qr_in, return_index=True)
        for u in uniq[np.argsort(first)]:
            if qr_to_idx[u] == 0:
                if n_pal >= 256:
                    return None
                # Exact f32 value for this bucket (first occurrence).
                palette[n_pal] = r_in[qr_in == u][0]
                qr_to_idx[u] = n_pal
                n_pal += 1
        ridx = qr_to_idx[qr].astype(np.uint32)

        sl = slice(pos, pos + n)
        wire_a[sl] = q[:, 0] | (q[:, 1] << 13) | ((q[:, 2] >> 7) << 26)
        wire_b[sl] = ((q[:, 2] & 0x7F) | (ridx << 7)).astype(np.uint16)
        t0, t1 = tile0, tile0 + nt
        tparams[t0:t1, 0:3] = cmin
        tparams[t0:t1, 3] = scale
        tmeta[t0:t1, 0] = tile0
        tmeta[t0:t1, 1] = nt
        offsets.append((pos, n, inv))
        tile0 += nt
        pos += nt * ATOM_TILE
    return wire_a, wire_b, palette, tparams, tmeta, offsets


def build_jlist_banded(
    planes: jnp.ndarray,  # [N_PLANES, M] f32 dequantized
    qvalid: jnp.ndarray,  # [M] bool (real atom slots)
    tmeta: jnp.ndarray,  # [T, 2] i32: (first tile of own structure, n tiles)
    *,
    w: int,
) -> jnp.ndarray:
    """Tile-pair culling ON DEVICE -> [T, JLIST_ROWS] i32 j-lists.

    The host culling path (pack_structures) spends most of its CPU on the
    [nt x nt] AABB tests, group masks and nearest-first sort, and ships
    512B/tile of j-lists over the host link, so the banded path moves
    that work to the device: tiles of one structure occupy a contiguous
    index band (tile_start .. tile_start+ts_len), so each i-tile tests exactly the
    `w`-wide band of its own structure (w static, >= max tiles/structure
    in the chunk).  AABBs are reduced from the SAME dequantized
    coordinates the kernel reads; the 16-bit 8-atom-group masks use
    per-i-atom point-to-box admission (tighter than the host packer's
    box-box test - the kernel's result is admission-order- and
    admission-set-invariant as long as culling stays conservative), and
    w <= JLIST_CAP makes row overflow impossible by construction.
    Nearest-first (AABB separation) row order kept for determinism.
    """
    m = planes.shape[1]
    t = m // ATOM_TILE
    ng = t * GROUPS_PER_TILE
    big = jnp.float32(3e4)
    c = planes[0:3].T  # [M, 3]
    r = planes[3]
    cmin_src = jnp.where(qvalid[:, None], c, big)
    cmax_src = jnp.where(qvalid[:, None], c, -big)
    rmasked = jnp.where(qvalid, r, 0.0)
    gmin = cmin_src.reshape(ng, J_GROUP, 3).min(axis=1)
    gmax = cmax_src.reshape(ng, J_GROUP, 3).max(axis=1)
    gmaxr = rmasked.reshape(ng, J_GROUP).max(axis=1)
    tmin = gmin.reshape(t, GROUPS_PER_TILE, 3).min(axis=1)
    tmax = gmax.reshape(t, GROUPS_PER_TILE, 3).max(axis=1)
    tmaxr = gmaxr.reshape(t, GROUPS_PER_TILE).max(axis=1)

    start = tmeta[:, 0]
    ts_len = tmeta[:, 1]
    slack = jnp.float32(DEVICE_CULL_SLACK)
    iidx = jnp.arange(t, dtype=jnp.int32)
    end = start + ts_len

    # Candidates are indexed by RELATIVE tile offset d = j - i, d in
    # (-w, w): a gather-free formulation.  The shifted j-tile
    # views come from static slices of a padded array, stacked into ONE
    # [2w-1, T, ...] tensor so every test below is a single wide op (a
    # 63-step python loop of tiny ops was overhead-bound).  Per-row
    # validity (j inside the structure's own band) caps actives at
    # ts_len <= w <= JLIST_CAP, so overflow stays impossible.
    nd = 2 * w - 1

    def shifted(x):
        """[T, ...] -> [nd, T, ...]: window d holds x[i + d - (w-1)]."""
        pad = [(w - 1, w - 1)] + [(0, 0)] * (x.ndim - 1)
        xp = jnp.pad(x, pad)
        return jnp.stack(
            [jax.lax.slice_in_dim(xp, d, d + t, axis=0) for d in range(nd)]
        )

    offs = jnp.arange(-(w - 1), w, dtype=jnp.int32)  # [nd]
    j = iidx[None, :] + offs[:, None]  # [nd, T]
    valid = (j >= start[None, :]) & (j < end[None, :])

    jt_min = shifted(tmin)  # [nd, T, 3]
    jt_max = shifted(tmax)
    jt_maxr = shifted(tmaxr)  # [nd, T]
    gap = jnp.maximum(
        jnp.maximum(tmin[None] - jt_max, jt_min - tmax[None]), 0.0
    )
    sep2 = jnp.sum(gap * gap, axis=-1)  # [nd, T]
    reach = tmaxr[None] + jt_maxr + slack
    act = valid & (sep2 <= reach * reach)

    # Fine granularity: every i-ATOM (point + its own r_eff) vs the
    # j-tile's 16 8-atom-group AABBs.  A 128-atom Morton range is often
    # L-shaped; any box drawn around parts of it covers empty space and
    # falsely admits j-groups no i-atom can reach.  Point-to-box
    # admission is the tightest i-side test available without pair
    # distances and stays conservative: the point-box gap lower-bounds
    # every (i-atom, j-atom) distance and r_i + jg_max_r upper-bounds
    # pair reach.  On 60 real structures it admits about 911 j-atoms
    # per atom against a 733 group-granularity floor, where 4x32-atom
    # i-sub-boxes admitted 1185 and 16x8-atom boxes 1141.  Kernel counts
    # do not depend on it: culling only has to stay conservative.
    c_t = jnp.where(qvalid[:, None], c, big).reshape(t, ATOM_TILE, 3)
    r_t = rmasked.reshape(t, ATOM_TILE)
    jg_min = shifted(gmin.reshape(t, GROUPS_PER_TILE, 3))  # [nd, T, 16, 3]
    jg_max = shifted(gmax.reshape(t, GROUPS_PER_TILE, 3))
    jg_maxr = shifted(gmaxr.reshape(t, GROUPS_PER_TILE))  # [nd, T, 16]

    def one_shift(args):
        mn, mx, mr = args  # [T, 16, 3] x2, [T, 16]
        g = jnp.maximum(
            jnp.maximum(
                mn[:, :, None, :] - c_t[:, None, :, :],
                c_t[:, None, :, :] - mx[:, :, None, :],
            ),
            0.0,
        )  # [T, 16, A, 3]
        pb2 = jnp.sum(g * g, axis=-1)  # [T, 16, A]
        rr = r_t[:, None, :] + mr[:, :, None] + slack
        # Float max-reduce + one compare instead of bool any-reduce:
        # identical admissions (rr^2 - pb2 >= 0 <=> pb2 <= rr^2; padding
        # slots have r_t = 0 and far-away coords, so their margins are
        # hugely negative).
        return jnp.max(rr * rr - pb2, axis=-1) >= 0.0  # [T, 16]

    bits = jax.lax.map(one_shift, (jg_min, jg_max, jg_maxr))  # [nd, T, 16]
    mask = jnp.sum(
        jnp.where(bits, jnp.int32(1), jnp.int32(0))
        << jnp.arange(GROUPS_PER_TILE, dtype=jnp.int32)[None, None, :],
        axis=-1,
    )  # [nd, T] i32, 16 low bits used
    act = act & (mask > 0)

    # Nearest-first compaction: sort each band row by masked separation;
    # inactive entries sink to the end with +inf keys.
    key = jnp.where(act, sep2, jnp.float32(np.inf)).T  # [T, nd]
    entries = (jax.lax.shift_left(mask, 16) | j).T
    key_s, ent_s = jax.lax.sort((key, entries), num_keys=1, dimension=1)
    count = jnp.sum(act, axis=0).astype(jnp.int32)
    nkeep = min(nd, JLIST_CAP)
    jlist = jnp.zeros((t, JLIST_ROWS), dtype=jnp.int32)
    jlist = jlist.at[:, 0].set(count)
    jlist = jlist.at[:, 1:1 + nkeep].set(ent_s[:, :nkeep])
    return jlist


@functools.partial(
    jax.jit, static_argnames=("n_points", "w", "interpret")
)
def fused_sasa_q16_banded(
    planes4: jnp.ndarray,  # [4, M] u16: qx, qy, qz, qr
    tparams: jnp.ndarray,  # [T, 4] f32: ox, oy, oz, cscale per tile
    tmeta: jnp.ndarray,  # [T, 2] i32: (tile_start, ts_len) per tile
    sphere: jnp.ndarray,  # [P, 4] f32: x, y, z, point_valid
    *,
    n_points: int,
    w: int,
    interpret: bool = False,
) -> jnp.ndarray:
    """Quantized wire + DEVICE-side culling: 8B/atom-slot in (no j-lists
    ride the link), occlusion counts (u8/u16) back.  One jit: dequant,
    banded AABB culling (build_jlist_banded) and the Pallas kernel fuse
    into a single dispatch.
    """
    m = planes4.shape[1]
    q = planes4.astype(jnp.float32)  # [4, M]
    par = jnp.repeat(tparams, ATOM_TILE, axis=0)  # [M, 4]
    planes = jnp.zeros((N_PLANES, m), dtype=jnp.float32)
    planes = planes.at[0].set(q[0] * par[:, 3] + par[:, 0])
    planes = planes.at[1].set(q[1] * par[:, 3] + par[:, 1])
    planes = planes.at[2].set(q[2] * par[:, 3] + par[:, 2])
    planes = planes.at[3].set(q[3] * np.float32(1.0 / R_QUANT))
    slot_gid = jnp.arange(m, dtype=jnp.float32) + 1.0
    qvalid = q[3] > 0.0
    planes = planes.at[4].set(jnp.where(qvalid, slot_gid, 0.0))
    jlist = build_jlist_banded(planes, qvalid, tmeta, w=w)
    counts = _counts_call(planes, jlist, sphere, interpret=interpret)
    out_dtype = jnp.uint8 if n_points <= 255 else jnp.uint16
    return counts.reshape(m).astype(out_dtype)


def pack_structures_q16(structures: list, probe: float):
    """Host packing for the banded device-cull path (numpy spec).

    Per structure: center (f64 mean rounded to a 1/256 A grid), Morton
    sort, quantize coordinates to u16 against the structure's own box and
    r_eff to u16/8192 - NO neighbor work; culling happens on device
    (build_jlist_banded).  Returns
    (planes4 [4, M] u16, tparams [T, 4] f32, tmeta [T, 2] i32, offsets)
    with offsets[i] = (slot, n, inv), or None when any structure is
    unquantizable (extent > MAX_Q_EXTENT or r_eff >= 8 A) - the caller
    falls back to the f32/host-cull path.  The native C++ packer
    (fastpack_q16) implements the same layout bit-identically.
    """
    from ..native import fastpack_q16

    out = fastpack_q16(structures, float(probe))
    if out is not None:
        return out
    return _pack_structures_q16_numpy(structures, probe)


def _pack_structures_q16_numpy(structures: list, probe: float):
    tiles_per = [-(-s[0].shape[0] // ATOM_TILE) for s in structures]
    total_tiles = sum(tiles_per)
    if total_tiles > 65535:
        raise ValueError(
            f"chunk too large for u16 tile ids: {total_tiles} tiles"
        )
    m = total_tiles * ATOM_TILE
    planes4 = np.zeros((4, m), dtype=np.uint16)
    tparams = np.zeros((total_tiles, 4), dtype=np.float32)
    tparams[:, 3] = 1.0
    tmeta = np.zeros((total_tiles, 2), dtype=np.int32)

    offsets = []
    tile0 = 0
    pos = 0
    for coords, radii, _gids in structures:
        n = coords.shape[0]
        nt = -(-n // ATOM_TILE)
        center = np.round(
            coords.mean(axis=0, dtype=np.float64) * 256.0
        ) / 256.0
        c = coords - center.astype(np.float32)
        order = np.argsort(_morton_codes(c), kind="stable")
        inv = np.empty(n, dtype=np.int64)
        inv[order] = np.arange(n)
        c = c[order]
        r_eff = radii[order] + np.float32(probe)

        cmin = c.min(axis=0)
        extent = float((c.max(axis=0) - cmin).max())
        if not extent <= MAX_Q_EXTENT:  # NaN-safe negation
            return None
        scale = np.float32(max(extent, 1e-6) / 65535.0)
        q = np.rint((c - cmin[None, :]) / scale)
        planes4[0:3, pos:pos + n] = np.clip(q, 0, 65535).astype(np.uint16).T
        qr = np.rint(r_eff * R_QUANT)
        if not float(qr.max(initial=0.0)) <= 65535.0:  # NaN-safe
            return None
        planes4[3, pos:pos + n] = np.maximum(qr, 1.0).astype(np.uint16)
        t0, t1 = tile0, tile0 + nt
        tparams[t0:t1, 0:3] = cmin
        tparams[t0:t1, 3] = scale
        tmeta[t0:t1, 0] = tile0
        tmeta[t0:t1, 1] = nt
        offsets.append((pos, n, inv))
        tile0 += nt
        pos += nt * ATOM_TILE
    return planes4, tparams, tmeta, offsets


def quantize_packed(planes5: np.ndarray, spans: list) -> tuple:
    """Quantize f32 transfer planes -> (planes4 u16 [4,M], tparams [T,4]).

    spans: list of (pos, n) slot ranges, one per packed structure (padding
    slots between spans get qr=0).  Returns None if any structure's extent
    exceeds MAX_Q_EXTENT (caller falls back to the f32 path).

    The packers center coordinates per structure, so the box is symmetric
    and small; one uniform scale per structure keeps the grid isotropic.
    """
    m = planes5.shape[1]
    t = m // ATOM_TILE
    planes4 = np.zeros((4, m), dtype=np.uint16)
    tparams = np.zeros((t, 4), dtype=np.float32)
    tparams[:, 3] = 1.0  # neutral scale for unused tiles
    for pos, n in spans:
        if n == 0:
            continue
        sl = slice(pos, pos + n)
        c = planes5[0:3, sl]
        cmin = c.min(axis=1)
        extent = float((c.max(axis=1) - cmin).max())
        if not extent <= MAX_Q_EXTENT:  # NaN-safe negation
            return None
        scale = np.float32(max(extent, 1e-6) / 65535.0)
        q = np.rint((c - cmin[:, None]) / scale)
        planes4[0:3, sl] = np.clip(q, 0, 65535).astype(np.uint16)
        qr = np.rint(planes5[3, sl] * R_QUANT)
        if not float(qr.max(initial=0.0)) <= 65535.0:  # NaN-safe
            return None  # r_eff >= 8 A: exotic probe/radius, f32 path
        planes4[3, sl] = np.maximum(qr, 1.0).astype(np.uint16)
        t0, t1 = pos // ATOM_TILE, -(-(pos + n) // ATOM_TILE)
        tparams[t0:t1, 0:3] = cmin
        tparams[t0:t1, 3] = scale
    return planes4, tparams


def _morton_codes(coords: np.ndarray) -> np.ndarray:
    """30-bit Morton codes from quantized coordinates (10 bits/axis)."""
    q = coords - coords.min(axis=0, keepdims=True)
    scale = 1023.0 / max(float(q.max()), 1e-6)
    q = np.minimum((q * scale).astype(np.uint32), 1023)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    return spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)


def pack_structures(
    structures: list[tuple[np.ndarray, np.ndarray, np.ndarray]],
    probe: float,
    n_points: int,
):
    """Host-side packing for the fused kernel.

    structures: list of (coords [n,3] f32, radii [n] f32, gids [n] i32).
    Returns (planes [5, M], jlist [T, 128] u32 (mask<<16)|id, offsets,
    failed) where
    offsets[i] = (start, n, perm_inverse) for unpacking results and
    `failed` lists input indices whose tiling overflowed JLIST_CAP
    (callers route those through the list-based path); their offsets are
    None and their slots are zeroed.

    Dispatches to the native C++ packer (native/fastparse.cpp fastpack,
    same layout contract, parity-tested) when the library is available;
    this numpy implementation is the fallback and the executable spec.
    """
    from ..native import fastpack

    out = fastpack(structures, float(probe))
    if out is not None:
        return out
    return _pack_structures_numpy(structures, probe, n_points)


def _pack_structures_numpy(structures, probe, n_points):
    tiles_per = [-(-s[0].shape[0] // ATOM_TILE) for s in structures]
    total_tiles = sum(tiles_per)
    if total_tiles > 65535:
        raise ValueError(
            f"chunk too large for u16 tile ids: {total_tiles} tiles"
        )
    m = total_tiles * ATOM_TILE
    planes = np.zeros((N_XFER_PLANES, m), dtype=np.float32)
    jlist = np.zeros((total_tiles, JLIST_ROWS), dtype=np.uint32)

    offsets = []
    failed: list[int] = []
    tile0 = 0
    pos = 0
    for s_i, (coords, radii, gids) in enumerate(structures):
        n = coords.shape[0]
        nt = tiles_per[s_i]
        # Center per structure: |c| ~ 30 instead of ~300 keeps every f32
        # intermediate (|v|^2, dot chains) well away from cancellation.
        # Rounding the f64 mean to a 1/256 A grid makes the center - and
        # hence the whole packing - bit-identical to the native C++
        # packer, whose sequential f64 sum orders differently.
        center = np.round(
            coords.mean(axis=0, dtype=np.float64) * 256.0
        ) / 256.0
        coords = coords - center.astype(np.float32)
        order = np.argsort(_morton_codes(coords), kind="stable")
        inv = np.empty(n, dtype=np.int64)
        inv[order] = np.arange(n)
        c = coords[order]
        r_eff = radii[order] + np.float32(probe)
        g = gids[order].astype(np.float64) + 1.0

        planes[0:3, pos:pos + n] = c.T
        planes[3, pos:pos + n] = r_eff
        planes[4, pos:pos + n] = g

        # Vectorized per-tile AND per-8-group AABBs + max reach; padding
        # slots are neutral.
        slots = nt * ATOM_TILE
        ng = nt * GROUPS_PER_TILE
        big = np.float32(3e4)
        cmin = np.full((slots, 3), big, dtype=np.float32)
        cmin[:n] = c
        cmax = np.full((slots, 3), -big, dtype=np.float32)
        cmax[:n] = c
        rpad = np.zeros(slots, dtype=np.float32)
        rpad[:n] = r_eff
        gmin = cmin.reshape(ng, J_GROUP, 3).min(axis=1)
        gmax = cmax.reshape(ng, J_GROUP, 3).max(axis=1)
        gmaxr = rpad.reshape(ng, J_GROUP).max(axis=1)
        tmin = gmin.reshape(nt, GROUPS_PER_TILE, 3).min(axis=1)
        tmax = gmax.reshape(nt, GROUPS_PER_TILE, 3).max(axis=1)
        tmaxr = gmaxr.reshape(nt, GROUPS_PER_TILE).max(axis=1)

        # Host-side tile-pair culling: [nt, nt] AABB separation test.
        gap = np.maximum(
            np.maximum(
                tmin[:, None, :] - tmax[None, :, :],
                tmin[None, :, :] - tmax[:, None, :],
            ),
            0.0,
        )
        sep2 = (gap * gap).sum(axis=2)
        # CULL_SLACK keeps the cull conservative under u16 coordinate
        # quantization (quantize_packed) - the kernel sees coordinates
        # moved by up to ~0.01 A relative to the f32 values culled here.
        reach = tmaxr[:, None] + tmaxr[None, :] + np.float32(CULL_SLACK)
        active = sep2 <= reach * reach  # [nt_i, nt_j]
        ii, jj = np.nonzero(active)
        masks = np.zeros(len(ii), dtype=np.uint32)
        if len(ii):
            # Fine culling: i-tile AABB vs each of the j-tile's 16 8-atom
            # group AABBs -> 16-bit mask per admitted pair.  The kernel
            # streams ONLY masked-in groups (about 2035 admitted j/atom
            # at tile granularity vs about 875 at group granularity).
            jg = (jj[:, None] * GROUPS_PER_TILE
                  + np.arange(GROUPS_PER_TILE)[None, :])  # [p, 16]
            ggap = np.maximum(
                np.maximum(
                    tmin[ii][:, None, :] - gmax[jg],
                    gmin[jg] - tmax[ii][:, None, :],
                ),
                0.0,
            )
            gsep2 = (ggap * ggap).sum(axis=2)  # [p, 16]
            greach = (tmaxr[ii][:, None] + gmaxr[jg]
                      + np.float32(CULL_SLACK))
            bits = gsep2 <= greach * greach  # [p, 16]
            masks = (
                bits.astype(np.uint32)
                << np.arange(GROUPS_PER_TILE, dtype=np.uint32)[None, :]
            ).sum(axis=1, dtype=np.uint32)
            # Pairs whose tile AABBs touch but no group does: drop.
            keep = masks != 0
            ii, jj, masks = ii[keep], jj[keep], masks[keep]
            pair_sep2 = sep2[ii, jj]
        counts = np.bincount(ii, minlength=nt)
        if counts.max(initial=0) > JLIST_CAP:
            # Pathological tiling (e.g. Morton folds spanning the box):
            # zero this structure's slots and let the caller reroute it.
            planes[:, pos:pos + n] = 0.0
            failed.append(s_i)
            offsets.append(None)
            tile0 += nt
            pos += nt * ATOM_TILE
            continue
        sl = slice(tile0, tile0 + nt)
        jlist[sl, 0] = counts
        if len(ii):
            # Deterministic nearest-first order within each row (by AABB
            # separation): keeps this packer bit-compatible with the
            # native C++ packer and the device-side banded builder, which
            # sort the same way.  Row order does not change the counts.
            row_order = np.lexsort((pair_sep2, ii))
            ii = ii[row_order]
            jj = jj[row_order]
            masks = masks[row_order]
            starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
            row_pos = np.arange(len(ii)) - np.repeat(starts, counts)
            jlist[tile0 + ii, 1 + row_pos] = (
                (masks << np.uint32(16)) | (jj + tile0).astype(np.uint32)
            )

        offsets.append((pos, n, inv))
        tile0 += nt
        pos += nt * ATOM_TILE

    return planes, jlist, offsets, failed
