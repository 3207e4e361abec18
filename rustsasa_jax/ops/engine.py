"""Accelerator Shrake-Rupley SASA engine.

Replaces the reference's CPU-idiomatic design (ragged per-atom neighbor
Vecs + SIMD early-exit kernel, reference: src/lib.rs:69-224,
src/structures/spatial_grid.rs) with a fixed-shape, masked, fully batched
formulation that XLA and Pallas can tile onto the device:

  1. Pairwise squared distances via the |a|^2 + |b|^2 - 2ab^T expansion
     (one [N,3]x[3,N] matmul) instead of a cell-list walk.
  2. Exact neighbor capture: every atom j with d^2 <= (r_i + max_r + 2p)^2
     is a candidate (same criterion as reference spatial_grid.rs:307,387);
     the K nearest candidates are selected with lax.top_k and the engine
     *verifies* no candidate was dropped (max_count <= K) - no silent
     truncation, K is re-bucketed and the chunk re-run on overflow.
  3. Occlusion: point p of atom i is occluded iff
     dot(s_p, v_ij) < (t_j - |v_ij|^2 - r_i_eff^2) / (2 r_i_eff)
     with t_j = (r_j + probe)^2 (reference: lib.rs:136-146), evaluated
     by a masked K-chunked XLA scan.

The production path (backend "fused") skips all of the above: it culls
tile pairs on the device and counts occlusions with the kernel in
ops/fused_kernel.py.  This list path is the plain f32 reference that the
tests and the CPU backend use.

Dispatch discipline: inputs are packed into TWO buffers per chunk (an
[B,N,4] f32 x/y/z/radius block and an [B,N] i32 group-id block whose -1
entries mark padding), probe/n_points are compile-time constants, and
the engine enqueues EVERY chunk asynchronously before its single synchronization
point - transfers and kernels for chunk i+1 overlap the execution of
chunk i.  Overflow chunks (neighbor count > K) are re-run afterwards with
a bigger K bucket.

All shapes are static per (N_pad, K, P_pad) bucket; jit caches per bucket.
Batches of structures run as one flattened kernel launch: per-structure
neighbor phases are vmapped, then [B, N] collapses into the atom axis.
"""

from __future__ import annotations

import functools
import itertools
import math
import threading
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import DEFAULT_N_POINTS, DEFAULT_PROBE_RADIUS
from ..utils import stagestats
from . import fused_kernel
from .sphere import padded_sphere_points

# Sentinel for "never occludes" limits and masked top-k scores.
_NEG_BIG = np.float32(-1e30)

# Candidate-selection slack: the matmul distance expansion loses a few ulps
# to cancellation; widening the cutoff only ever *adds* candidates, and the
# occlusion test recomputes v exactly, so this is always safe.
_CUTOFF_SLACK = np.float32(1e-3)

# Size of the neighbor-axis chunk the XLA occlusion scan materializes.
_K_CHUNK = 16

# Atom-count buckets (1.5x-ish growth bounds recompilation and padding
# waste).
_N_BUCKETS = [
    8, 16, 32, 64, 128, 256, 384, 512, 768, 1024, 1536, 2048, 3072,
    4096, 6144, 8192, 12288, 16384, 24576, 32768, 49152, 65536,
]
_K_BUCKETS = [16, 32, 64, 96, 128, 160, 192, 256, 320, 384, 512]


def _round_bucket(n: int, buckets: list[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return int(math.ceil(n / buckets[-1])) * buckets[-1]


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@dataclass(frozen=True)
class SasaParams:
    """Runtime parameters of one SASA evaluation."""

    probe_radius: float = DEFAULT_PROBE_RADIUS
    n_points: int = DEFAULT_N_POINTS


import os as _os

BACKENDS = ("xla", "fused", "fused_interpret")


def resolve_backend(backend: str) -> str:
    """Pick the engine backend from the platform.

    'auto' gives 'fused' (device culling + the occlusion counts kernel)
    on a GPU and 'xla' (the plain f32 list path) on the CPU; any other
    platform, or no device at all, is an error.  The environment variable
    RUSTSASA_BACKEND overrides 'auto'.  'fused_interpret' runs the kernel
    in Pallas interpret mode; it exists for the CPU tests and is refused
    elsewhere.
    """
    if backend == "auto":
        backend = _os.environ.get("RUSTSASA_BACKEND", "auto")
    platform = jax.devices()[0].platform
    if backend == "auto":
        if platform == "gpu":
            return "fused"
        if platform == "cpu":
            return "xla"
        raise RuntimeError(f"no SASA backend for platform {platform!r}")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected {BACKENDS}")
    if backend == "fused_interpret" and platform != "cpu":
        raise ValueError("backend 'fused_interpret' runs on the CPU only")
    return backend


def _pairwise_d2(coords: jnp.ndarray) -> jnp.ndarray:
    """Squared distance matrix via the matmul expansion.

    Precision MUST be highest: a GPU's default may run f32 matmuls in TF32
    (10-bit mantissa), and with |coords| ~ 1e2 the resulting d^2 error
    (~1e2 A^2) would silently drop true neighbors.  The contraction dim is
    only 3, so the cost is irrelevant next to the occlusion loop.
    """
    sq = jnp.sum(coords * coords, axis=-1)
    cross = jnp.dot(
        coords, coords.T, precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )
    d2 = sq[:, None] + sq[None, :] - 2.0 * cross
    return jnp.maximum(d2, 0.0)


# Above this atom count the [N,N] working set is row-chunked (a 64k-atom
# dense d2 would be 16GB; chunks keep it ~1GB).
_DENSE_N_LIMIT = 8192
_ROW_CHUNK = 4096


def _neighbor_phase(
    packed: jnp.ndarray,  # [N, 4] x,y,z,radius
    group_id: jnp.ndarray,  # [N] i32, -1 for padding
    *,
    probe: float,
    k: int,
):
    """Candidate selection -> (v [N,K,3], limit [N,K], counts [N], max_count)."""
    packed = jnp.asarray(packed)
    group_id = jnp.asarray(group_id)
    coords = packed[:, 0:3]
    radii = packed[:, 3]
    valid = group_id >= 0
    n = coords.shape[0]
    k_eff = min(k, n)

    max_radius = jnp.max(jnp.where(valid, radii, 0.0))
    r_eff = radii + probe
    sq = jnp.sum(coords * coords, axis=-1)

    def rows(lo_coords, lo_radii, lo_gid, lo_sq):
        """Neighbor selection for one block of rows against all columns."""
        cross = jnp.dot(
            lo_coords, coords.T, precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        )
        d2 = jnp.maximum(lo_sq[:, None] + sq[None, :] - 2.0 * cross, 0.0)
        cutoff = lo_radii + max_radius + 2.0 * probe
        pair_ok = (
            (lo_gid >= 0)[:, None]
            & valid[None, :]
            & (lo_gid[:, None] != group_id[None, :])
        )
        cand = pair_ok & (
            d2 <= cutoff[:, None] * cutoff[:, None] + _CUTOFF_SLACK
        )
        counts = jnp.sum(cand, axis=1)
        score = jnp.where(cand, -d2, _NEG_BIG)
        _, nbr_idx = jax.lax.top_k(score, k_eff)  # valid-first
        nbr_valid = jnp.take_along_axis(cand, nbr_idx, axis=1)
        nc = coords[nbr_idx]
        nr = radii[nbr_idx]
        v = lo_coords[:, None, :] - nc
        v2 = jnp.sum(v * v, axis=-1)
        lo_reff = lo_radii + probe
        thr = (nr + probe) ** 2
        limit = (thr - v2 - (lo_reff * lo_reff)[:, None]) / (
            2.0 * lo_reff[:, None]
        )
        limit = jnp.where(nbr_valid, limit, _NEG_BIG)
        return v, limit, counts

    if n <= _DENSE_N_LIMIT or n % _ROW_CHUNK != 0:
        v, limit, counts = rows(coords, radii, group_id, sq)
        return v, limit, counts, jnp.max(counts)

    # Row-chunked: lax.map over row blocks bounds peak memory.
    nc_blocks = n // _ROW_CHUNK
    def block(args):
        return rows(*args)

    v_b, lim_b, cnt_b = jax.lax.map(
        block,
        (
            coords.reshape(nc_blocks, _ROW_CHUNK, 3),
            radii.reshape(nc_blocks, _ROW_CHUNK),
            group_id.reshape(nc_blocks, _ROW_CHUNK),
            sq.reshape(nc_blocks, _ROW_CHUNK),
        ),
    )
    v = v_b.reshape(n, k_eff, 3)
    limit = lim_b.reshape(n, k_eff)
    counts = cnt_b.reshape(n)
    return v, limit, counts, jnp.max(counts)


def _occlusion_scan(
    v: jnp.ndarray,  # [N, K, 3] center - neighbor
    limit: jnp.ndarray,  # [N, K] occlusion threshold, -BIG where invalid
    sphere: jnp.ndarray,  # [P, 3]
) -> jnp.ndarray:
    """XLA fallback: OR-accumulate occlusion over K-chunks -> [N, P] bool."""
    n, k, _ = v.shape
    p = sphere.shape[0]
    kc = min(_K_CHUNK, k)
    n_chunks = _round_up(k, kc) // kc
    pad_k = n_chunks * kc
    if pad_k != k:
        v = jnp.pad(v, ((0, 0), (0, pad_k - k), (0, 0)))
        limit = jnp.pad(limit, ((0, 0), (0, pad_k - k)), constant_values=_NEG_BIG)
    v_ch = v.reshape(n, n_chunks, kc, 3).transpose(1, 0, 2, 3)
    lim_ch = limit.reshape(n, n_chunks, kc).transpose(1, 0, 2)

    def body(occ, xs):
        v_c, lim_c = xs
        # dot(s_p, v_ij): [N, kc, P] in f32 (see _pairwise_d2 note).
        dots = jnp.einsum(
            "nkd,pd->nkp", v_c, sphere,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        occ = occ | jnp.any(dots < lim_c[:, :, None], axis=1)
        return occ, None

    # Derive the initial carry from the data so its varying-mesh-axes type
    # matches inside shard_map (a constant zeros carry would be replicated
    # while the body output varies over the mesh axis).
    occ0 = jnp.zeros((n, p), dtype=bool) | (v[:, 0, 0:1] != v[:, 0, 0:1])
    occ, _ = jax.lax.scan(body, occ0, (v_ch, lim_ch))
    return occ


def _area_factor(radii, valid, probe: float, n_points: int):
    r_eff = radii + probe
    factor = 4.0 * np.float32(np.pi) * r_eff * r_eff * np.float32(1.0 / n_points)
    return jnp.where(valid, factor, 0.0)


def _occlusion_sasa(
    v, limit, radii, valid, sphere_packed, *, probe: float, n_points: int,
):
    """Occlusion (XLA scan) + area.

    All inputs may be batched-flat: [M, K, 3] where M = B * N_pad.
    sphere_packed: [P, 4] f32 (x, y, z, point_valid).
    """
    sphere = sphere_packed[:, 0:3]
    point_valid = sphere_packed[:, 3] > 0.0
    area = _area_factor(radii, valid, probe, n_points)
    occluded = _occlusion_scan(v, limit, sphere)  # [M, P]
    accessible = jnp.sum(
        point_valid[None, :] & ~occluded, axis=1, dtype=jnp.float32
    )
    return area * accessible


@functools.partial(jax.jit, static_argnames=("k", "n_points", "probe"))
def _sasa_single(packed, group_id, sphere_packed, *, k, n_points, probe):
    v, limit, _, max_count = _neighbor_phase(
        packed, group_id, probe=probe, k=k
    )
    sasa = _occlusion_sasa(
        v, limit, packed[:, 3], group_id >= 0, sphere_packed,
        probe=probe, n_points=n_points,
    )
    return sasa, max_count


@functools.partial(jax.jit, static_argnames=("k", "n_points", "probe"))
def _sasa_batched(packed, group_id, sphere_packed, *, k, n_points, probe):
    """[B, N, ...] batch: vmapped neighbor phase + one flattened occlusion."""
    b, n = group_id.shape
    v, limit, _, max_counts = jax.vmap(
        functools.partial(_neighbor_phase, probe=probe, k=k)
    )(packed, group_id)
    k_eff = limit.shape[-1]
    sasa_flat = _occlusion_sasa(
        v.reshape(b * n, k_eff, 3),
        limit.reshape(b * n, k_eff),
        packed[:, :, 3].reshape(b * n),
        group_id.reshape(b * n) >= 0,
        sphere_packed,
        probe=probe, n_points=n_points,
    )
    return sasa_flat.reshape(b, n), jnp.max(max_counts)


def _initial_k(n: int) -> int:
    # Typical protein packing tops out around ~130 in-range neighbors with
    # ProtOr radii and probe 1.4 (the reference reserves 80 and grows,
    # spatial_grid.rs:213); start at 160 (the smallest bucket that fits
    # dense crystal cores without a re-run) capped by the atom count.
    return min(_round_bucket(min(160, n), _K_BUCKETS), n)


def _sphere_packed(n_points: int) -> np.ndarray:
    p_pad = _round_up(n_points, 8)
    sphere, point_valid = padded_sphere_points(n_points, p_pad)
    packed = np.empty((p_pad, 4), dtype=np.float32)
    packed[:, 0:3] = sphere
    packed[:, 3] = point_valid.astype(np.float32)
    return packed


def _dense_gids(gids: np.ndarray | None, n: int) -> np.ndarray:
    if gids is None:
        return np.arange(n, dtype=np.int32)
    gids = np.asarray(gids)
    if gids.dtype == np.int32 and (len(gids) == 0 or gids.min() >= 0):
        # Already-dense non-negative ids (the selection layer emits these);
        # only equality matters, no re-factorization needed.
        return gids
    _, inv = np.unique(gids, return_inverse=True)
    return inv.astype(np.int32)


def calculate_sasa_internal(
    coords: np.ndarray,
    radii: np.ndarray,
    *,
    group_ids: np.ndarray | None = None,
    probe_radius: float = DEFAULT_PROBE_RADIUS,
    n_points: int = DEFAULT_N_POINTS,
    backend: str = "auto",
) -> np.ndarray:
    """Per-atom SASA for one structure (reference API: lib.rs:249-298).

    coords: [N, 3] positions in Angstroms.
    radii: [N] atomic radii.
    group_ids: optional [N] int ids; atoms sharing an id never occlude each
      other (reference semantics: Atom.id equality skip, lib.rs:124).  When
      omitted every atom gets a distinct id.
    backend: 'auto' | 'xla' | 'fused' | 'fused_interpret' (see
      resolve_backend).
    """
    from ..utils.jax_cache import enable_persistent_cache

    enable_persistent_cache(library_call=True)
    coords = np.ascontiguousarray(coords, dtype=np.float32)
    radii = np.ascontiguousarray(radii, dtype=np.float32)
    n = coords.shape[0]
    if n == 0:
        return np.zeros(0, dtype=np.float32)
    gid = _dense_gids(group_ids, n)

    n_pad = _round_bucket(n, _N_BUCKETS)
    sphere_packed = _sphere_packed(n_points)
    backend = resolve_backend(backend)

    if backend.startswith("fused"):
        return _compute_fused(
            [(coords, radii, gid)],
            probe=float(probe_radius),
            n_points=n_points,
            interpret=backend.endswith("interpret"),
        ).collect()[0]

    packed = np.zeros((n_pad, 4), dtype=np.float32)
    packed[:n, 0:3] = coords
    packed[:n, 3] = radii
    g = np.full(n_pad, -1, dtype=np.int32)
    g[:n] = gid

    k = _initial_k(n_pad)
    probe = float(probe_radius)
    while True:
        sasa, max_count = _sasa_single(
            packed, g, sphere_packed,
            k=k, n_points=n_points, probe=probe,
        )
        mc = int(max_count)
        if mc <= k:
            break
        # Exactness guarantee: re-run with a K bucket that fits every
        # in-range neighbor.  Silent truncation would corrupt results.
        k = min(_round_bucket(mc, _K_BUCKETS), n_pad)
    return np.asarray(sasa[:n])


# Atom-slots per fused kernel launch: exactly the largest chunk bucket,
# so a budget-full chunk pads ZERO slots.
_FUSED_ATOM_BUDGET = 2_097_152

# Public alias for pipeline callers (batch.py streams dispatches at
# exactly this granularity so every chunk fills its bucket).
CHUNK_SLOT_BUDGET = _FUSED_ATOM_BUDGET

# Atom-slot buckets for fused chunks: every chunk pads to one of these so
# the whole corpus reuses a handful of compiled shapes.  Buckets are
# spaced ~4x to cap padding-slot transfer waste at <= 4x on the tail
# chunk only; each bucket's compile is a one-time cost amortized by the
# persistent cache.  All are powers of two.
_FUSED_M_BUCKETS = [2048, 4096, 8192, 32768, 131072, 524288, 1048576, 2097152]

# Device-resident probe spheres, keyed by (n_points, device): the [P, 4]
# f32 block is constant per configuration, so it crosses the host link
# once per device instead of once per chunk.
_SPHERE_DEV: dict = {}


def _sphere_device(n_points: int, dev):
    """Process-global per-(n_points, device) staged sphere block."""
    key = (n_points, id(dev))
    ent = _SPHERE_DEV.get(key)
    if ent is None:
        ent = jax.device_put(_sphere_packed(n_points), dev)
        _SPHERE_DEV[key] = ent
    return ent


def _unique_gids(gid: np.ndarray) -> bool:
    """Dense factorized gids are unique per atom iff max == n-1."""
    n = gid.shape[0]
    return n == 0 or int(gid.max()) == n - 1


class DeviceCycle:
    """Thread-safe round-robin over devices.

    One cycle lives as long as its engine, so successive enqueue calls
    (the batch pipeline dispatches one chunk per call) continue the
    rotation instead of each starting again at the first device.
    """

    def __init__(self, devices):
        self._it = itertools.cycle(list(devices))
        self._lock = threading.Lock()

    def __next__(self):
        with self._lock:
            return next(self._it)


def _compute_fused(
    structures, *, probe: float, n_points: int,
    interpret: bool = False, out_dtype=jnp.float32,
    devices: DeviceCycle | None = None,
) -> list[np.ndarray]:
    """Run the fused tiled kernel over a list of structures.

    Chunks by total atom-slot budget; every chunk is ONE pallas_call with
    no K buckets, no overflow re-runs, no gathers.  All chunks are
    enqueued before results are read back.

    Multi-device: chunks are independent, so they round-robin over
    `devices` (default: all local devices) - the production scale-out
    path for the fused kernel.  Each chunk's inputs are placed on its
    device and the jitted pallas_call executes there; no collectives are
    needed (per-structure results are embarrassingly parallel, the same
    isolation the reference gets from rayon-over-files, main.rs:375).
    """
    if devices is None:
        devices = DeviceCycle(jax.local_devices())

    def sphere_for(dev):
        return _sphere_device(n_points, dev)

    results: list[np.ndarray | None] = [None] * len(structures)
    order = sorted(
        range(len(structures)), key=lambda i: -structures[i][0].shape[0]
    )
    pending = []  # (chunk, offsets, device_out, kind)

    fallback: list[int] = []

    def flush(chunk):
        if not chunk:
            return
        triples = []
        for i in chunk:
            coords, radii, gids = structures[i]
            triples.append(
                (coords, radii, _dense_gids(gids, coords.shape[0]))
            )
        # Banded device-cull path (the production fast path): culling
        # happens on the device (fused_kernel.build_jlist_banded), the host
        # only centers/sorts/quantizes, and no j-lists ride the link.
        # Requirements: per-atom-unique gids (slot index becomes the
        # exclusion id) and every structure small enough for a W bucket.
        # Ineligible structures (alt-loc gid collisions, >127-tile
        # giants) re-flush as their OWN sub-chunk on the host-cull path,
        # so one exotic file never drags a whole chunk off the fast path.
        eligible = [
            k for k, t in enumerate(triples)
            if -(-t[0].shape[0] // fused_kernel.ATOM_TILE)
            <= fused_kernel.W_BUCKETS[-1] and _unique_gids(t[2])
        ]
        if 0 < len(eligible) < len(chunk):
            elig = set(eligible)
            rest = [
                chunk[k] for k in range(len(chunk)) if k not in elig
            ]
            flush([chunk[k] for k in eligible])
            flush(rest)
            return
        max_nt = max(
            -(-t[0].shape[0] // fused_kernel.ATOM_TILE) for t in triples
        )
        if len(eligible) == len(chunk):
            # 6 B/slot q13 wire first (25% less h2d over the narrow host
            # link, fused_kernel.MAX_Q13_EXTENT note), then the q16 wire
            # for chunks it can't take (big extents, >255 radii).  The
            # q13 packer is all-or-nothing per chunk, so split out
            # structures whose extent disqualifies them (extent is
            # translation-invariant: measuring raw coords here equals
            # the packer's centered measure) - one big structure must not
            # drag a whole chunk onto the 8 B/slot wire.
            q13_ok = [
                k for k, t in enumerate(triples)
                if t[0].shape[0] == 0
                or float((t[0].max(axis=0) - t[0].min(axis=0)).max())
                <= fused_kernel.MAX_Q13_EXTENT
            ]
            if 0 < len(q13_ok) < len(chunk):
                okset = set(q13_ok)
                rest = [
                    chunk[k] for k in range(len(chunk)) if k not in okset
                ]
                flush([chunk[k] for k in q13_ok])
                flush(rest)
                return
            with stagestats.stage("pack"):
                q13 = fused_kernel.pack_structures_q13(triples, probe)
            if q13 is not None:
                wire_a, wire_b, palette, tparams, tmeta, offsets = q13
                m = wire_a.shape[0]
                m_pad = m if interpret else _round_bucket(
                    m, _FUSED_M_BUCKETS
                )
                if m_pad != m:
                    pad_t = (m_pad - m) // fused_kernel.ATOM_TILE
                    wire_a = np.pad(wire_a, (0, m_pad - m))
                    wire_b = np.pad(wire_b, (0, m_pad - m))
                    tparams = np.pad(tparams, ((0, pad_t), (0, 0)))
                    tmeta = np.pad(tmeta, ((0, pad_t), (0, 0)))
                w = next(
                    b for b in fused_kernel.W_BUCKETS if b >= max_nt
                )
                dev = next(devices)
                with stagestats.stage("dispatch"):
                    wire_a, wire_b, palette, tparams, tmeta = (
                        jax.device_put(
                            (wire_a, wire_b, palette, tparams, tmeta), dev
                        )
                    )
                    out = fused_kernel.fused_sasa_q13_banded(
                        wire_a, wire_b, palette, tparams, tmeta,
                        sphere_for(dev),
                        n_points=n_points, w=w, interpret=interpret,
                    )
                pending.append((chunk, offsets, out, "q16"))
                return
            with stagestats.stage("pack"):
                qout = fused_kernel.pack_structures_q16(triples, probe)
            if qout is not None:
                planes4, tparams, tmeta, offsets = qout
                m = planes4.shape[1]
                m_pad = m if interpret else _round_bucket(
                    m, _FUSED_M_BUCKETS
                )
                if m_pad != m:
                    pad_t = (m_pad - m) // fused_kernel.ATOM_TILE
                    planes4 = np.pad(planes4, ((0, 0), (0, m_pad - m)))
                    tparams = np.pad(tparams, ((0, pad_t), (0, 0)))
                    tmeta = np.pad(tmeta, ((0, pad_t), (0, 0)))
                w = next(
                    b for b in fused_kernel.W_BUCKETS if b >= max_nt
                )
                dev = next(devices)
                with stagestats.stage("dispatch"):
                    planes4, tparams, tmeta = jax.device_put(
                        (planes4, tparams, tmeta), dev
                    )
                    out = fused_kernel.fused_sasa_q16_banded(
                        planes4, tparams, tmeta, sphere_for(dev),
                        n_points=n_points, w=w, interpret=interpret,
                    )
                pending.append((chunk, offsets, out, "q16"))
                return
        with stagestats.stage("pack"):
            planes, jlist, offsets, failed = fused_kernel.pack_structures(
                triples, probe, n_points
            )
        if failed:
            # Pathologically connected tiling: route those structures
            # through the list-based path instead (exactness over speed).
            fallback.extend(chunk[f] for f in failed)
        # Pad atom slots to a bucketed M so chunk shapes are reused.
        # Interpret mode (CPU tests / dryruns) skips the padding: every
        # padded tile costs real interpreter time there, and shape cache
        # reuse does not matter on the CPU.
        m = planes.shape[1]
        m_pad = m if interpret else _round_bucket(m, _FUSED_M_BUCKETS)
        if m_pad != m:
            planes = np.pad(planes, ((0, 0), (0, m_pad - m)))
            jlist = np.pad(
                jlist,
                ((0, (m_pad - m) // fused_kernel.ATOM_TILE), (0, 0)),
            )
        dev = next(devices)
        # Quantized 8B/slot wire format whenever gids are unique per atom
        # (slot index then serves as the occlusion-exclusion id) and every
        # structure's extent fits the u16 grid; exotic chunks use the f32
        # planes.  Counts come back as u8; SASA is reconstructed exactly
        # on host in collect().
        q = None
        if all(_unique_gids(t[2]) for t in triples):
            spans = [(off[0], off[1]) for off in offsets if off is not None]
            with stagestats.stage("quantize"):
                q = fused_kernel.quantize_packed(planes, spans)
        if q is not None:
            planes4, tparams = q
            with stagestats.stage("dispatch"):
                planes4, tparams, jlist = jax.device_put(
                    (planes4, tparams, jlist), dev
                )
                out = fused_kernel.fused_sasa_q16(
                    planes4, tparams, jlist, sphere_for(dev),
                    n_points=n_points, interpret=interpret,
                )
            pending.append((chunk, offsets, out, "q16"))
        else:
            with stagestats.stage("dispatch"):
                planes, jlist = jax.device_put((planes, jlist), dev)
                out = fused_kernel.fused_sasa(
                    planes, jlist, sphere_for(dev),
                    n_points=n_points, out_dtype=out_dtype,
                    interpret=interpret,
                )
            pending.append((chunk, offsets, out, "f32"))

    chunk: list[int] = []
    budget = 0
    for i in order:
        n_slots = _round_up(max(structures[i][0].shape[0], 1),
                            fused_kernel.ATOM_TILE)
        if chunk and budget + n_slots > _FUSED_ATOM_BUDGET:
            flush(chunk)
            chunk, budget = [], 0
        chunk.append(i)
        budget += n_slots
    flush(chunk)
    return _FusedPending(structures, results, pending, fallback,
                         probe, n_points)


class CountsView:
    """Deferred unpack of one structure's result from a chunk's raw
    occlusion-counts readback.  Calling it materializes the per-atom SASA
    (numpy path); consumers with a native sink (batch.py + NativeSelection)
    instead read the raw fields and fuse the unpack into the C++ emit."""

    __slots__ = ("out_np", "pos", "n", "inv", "radii", "probe", "n_points")

    def __init__(self, out_np, pos, n, inv, radii, probe, n_points):
        self.out_np = out_np
        self.pos = pos
        self.n = n
        self.inv = inv
        self.radii = radii
        self.probe = probe
        self.n_points = n_points

    @property
    def area_const(self) -> np.float32:
        return np.float32(4.0 * np.pi / self.n_points)

    @property
    def counts(self) -> np.ndarray:
        return self.out_np[self.pos:self.pos + self.n]

    def __call__(self) -> np.ndarray:
        vals = self.counts[self.inv]
        r_eff = self.radii.astype(np.float32) + np.float32(self.probe)
        return vals.astype(np.float32) * (self.area_const * r_eff * r_eff)


class _FusedPending:
    """In-flight fused computation: all chunks dispatched, none read back.

    collect() is the single synchronization point; until then the host is
    free to pack/parse/emit other work while the device drains the queue.
    """

    def __init__(self, structures, results, pending, fallback,
                 probe, n_points):
        self.structures = structures
        self.results = results
        self.pending = pending
        self.fallback = fallback
        self.probe = probe
        self.n_points = n_points

    def collect(self) -> list[np.ndarray]:
        with stagestats.stage("unpack"):
            return [
                v() if callable(v) else v for v in self.collect_views()
            ]

    def collect_views(self) -> list:
        """Sync all chunks; return per-structure entries that are either
        ready np.ndarrays or zero-arg thunks materializing one structure's
        SASA (slice + inverse permutation + counts->area).  Callers with a
        worker pool (batch.py) run the thunks OFF the main thread - the
        unpack work (~0.2-0.7 s/corpus) overlaps waiting instead of
        serializing on the pipeline spine."""
        views: list = self.results
        for chunk, offsets, out, kind in self.pending:
            with stagestats.stage("device_wait"):
                out_np = np.asarray(out)
            for i, off in zip(chunk, offsets):
                if off is None:
                    continue  # rerouted to fallback
                pos, n, inv = off

                if kind == "q16":
                    # counts -> SASA on host: exact f32, and the counts
                    # readback is 2-4x narrower than an area readback.
                    views[i] = CountsView(
                        out_np, pos, n, inv, self.structures[i][1],
                        self.probe, self.n_points,
                    )
                else:
                    def thunk(out_np=out_np, pos=pos, n=n, inv=inv):
                        return out_np[pos:pos + n][inv].astype(np.float32)

                    views[i] = thunk
        self.pending = []

        if self.fallback:
            eng = BatchedSasaEngine(
                SasaParams(probe_radius=self.probe, n_points=self.n_points),
                backend="xla",
            )
            for i, out in zip(
                self.fallback,
                eng.compute([self.structures[i] for i in self.fallback]),
            ):
                views[i] = out
            self.fallback = []
        return views


class _EagerPending:
    """Already-resolved handle (non-fused backends, empty inputs)."""

    def __init__(self, results):
        self._results = results

    def collect(self):
        return self._results

    def collect_views(self):
        return self._results


class _MappedPending:
    """Maps an inner handle over the nonempty-structure subset."""

    def __init__(self, inner, nonempty, total):
        self._inner = inner
        self._nonempty = nonempty
        self._total = total

    def _scatter(self, outs):
        results: list = [
            np.zeros(0, np.float32) for _ in range(self._total)
        ]
        for i, out in zip(self._nonempty, outs):
            results[i] = out
        return results

    def collect(self):
        return self._scatter(self._inner.collect())

    def collect_views(self):
        return self._scatter(self._inner.collect_views())


def _batch_cap(n_pad: int) -> int:
    """Structures per device call, bounded by the [B,N,N] distance matrix
    and the flattened occlusion working set."""
    cap_d2 = max(1, int(3e8 // (n_pad * n_pad)))
    cap_occ = max(1, int(1.6e8 // (n_pad * _K_CHUNK * 128)))
    return max(1, min(256, cap_d2, cap_occ))


class BatchedSasaEngine:
    """Batched engine: many structures per device call, bucketed by size.

    Feed with (coords, radii, group_ids) triples; structures are grouped
    into padded-N buckets, stacked [B, N, ...] and run as flattened kernel
    launches.  ALL chunks are enqueued asynchronously before the single
    synchronization point, so host->device transfers and kernels pipeline
    back-to-back on the device - this is the throughput path for
    directory/proteome processing (the device analog of the reference's
    rayon-over-files outer loop, main.rs:375).
    """

    def __init__(
        self,
        params: SasaParams | None = None,
        backend: str = "auto",
        *,
        readback_dtype=jnp.float16,
        devices=None,
    ):
        """readback_dtype: dtype of the device->host result transfer on the
        f32-planes fused path.  f16 halves it and its ~0.05% rounding is
        far inside every parity tolerance (golden eps=25 A^2/atom, RMSE
        gate +20).  Pass jnp.float32 for bit-clean per-atom output.

        devices: the devices fused chunks round-robin over (default: all
        local devices)."""
        from ..utils.jax_cache import enable_persistent_cache

        enable_persistent_cache(library_call=True)
        self.params = params or SasaParams()
        self.backend = backend
        self.readback_dtype = readback_dtype
        self.devices = list(devices or jax.local_devices())
        self._device_cycle = DeviceCycle(self.devices)

    # Production (M, w) shapes the proteome pipeline dispatches: the
    # chunk ramp (0.5M/1M slots) plus full 2M chunks, at the W bands
    # AlphaFold-scale structures land in.  warm_shapes() touches each so
    # its executable is compiled (persistent cache) AND loaded onto the
    # device up front.
    _WARM_SHAPES = [
        (524288, 16), (524288, 24), (524288, 32),
        (1048576, 16), (1048576, 24), (1048576, 32),
        (2097152, 16), (2097152, 24), (2097152, 32),
    ]

    def warm_shapes(self, shapes=None, *, threads: int | None = None) -> float:
        """Compile and load the production fused-kernel shapes.

        Dispatches one all-padding chunk per (M, w) shape on every local
        device, so each executable is compiled (persistent cache) and
        loaded before real work arrives and no compile lands inside a
        timed pass.  Inputs are made on the device, so no bytes cross the
        host link and the device work itself is ~zero.  Shapes compile
        concurrently, one thread per shape by default.  Returns elapsed
        seconds; 0.0 when the backend is not 'fused'.
        """
        import time as _time
        from concurrent.futures import ThreadPoolExecutor

        t0 = _time.time()
        if resolve_backend(self.backend) != "fused":
            return 0.0
        n_points = self.params.n_points
        devices = self.devices

        def one(shape):
            m, w = shape
            t = m // fused_kernel.ATOM_TILE
            for dev in devices:
                out = fused_kernel.fused_sasa_q13_banded(
                    jnp.zeros(m, jnp.uint32, device=dev),
                    jnp.zeros(m, jnp.uint16, device=dev),
                    jnp.zeros(256, jnp.float32, device=dev),
                    jnp.zeros((t, 4), jnp.float32, device=dev),
                    jnp.zeros((t, 2), jnp.int32, device=dev),
                    _sphere_device(n_points, dev),
                    n_points=n_points, w=w,
                )
                np.asarray(out[0:8])

        shapes = shapes or self._WARM_SHAPES
        if threads is None:
            threads = len(shapes)
        if threads <= 1:
            for shape in shapes:
                one(shape)
        else:
            with ThreadPoolExecutor(max_workers=threads) as pool:
                list(pool.map(one, shapes))
        return _time.time() - t0

    def compute(
        self, structures: list[tuple[np.ndarray, np.ndarray, np.ndarray | None]]
    ) -> list[np.ndarray]:
        if not structures:
            return []
        if resolve_backend(self.backend).startswith("fused"):
            return self.enqueue(structures).collect()

        results: list[np.ndarray | None] = [None] * len(structures)
        buckets: dict[int, list[int]] = {}
        for i, (coords, _, _) in enumerate(structures):
            n = coords.shape[0]
            if n == 0:
                results[i] = np.zeros(0, np.float32)
                continue
            buckets.setdefault(_round_bucket(n, _N_BUCKETS), []).append(i)

        # Phase 1: enqueue every chunk asynchronously.
        pending = []  # (members, inputs, k, sasa_dev, max_count_dev)
        return self._compute_xla(structures, results, buckets, pending)

    def enqueue(self, structures):
        """Dispatch all device work for `structures` WITHOUT synchronizing.

        Returns a handle with .collect() -> list[np.ndarray].  On the
        fused path the host is free between enqueue and collect (pack the
        next wave, emit the previous one) while the device drains its
        queue - this is what turns the batch pipeline's wall time into
        max(device, host) instead of their sum.  Non-fused backends
        compute eagerly and return an already-resolved handle.
        """
        params = self.params
        backend0 = resolve_backend(self.backend)
        if not backend0.startswith("fused") or not structures:
            return _EagerPending(self.compute(structures))
        nonempty = [
            i for i, s in enumerate(structures) if s[0].shape[0] > 0
        ]
        sub = [structures[i] for i in nonempty]
        inner = _compute_fused(
            sub, probe=float(params.probe_radius),
            n_points=params.n_points,
            interpret=backend0.endswith("interpret"),
            out_dtype=self.readback_dtype,
            devices=self._device_cycle,
        )
        return _MappedPending(inner, nonempty, len(structures))

    def _compute_xla(self, structures, results, buckets, pending):
        params = self.params
        sphere_packed = _sphere_packed(params.n_points)
        probe = float(params.probe_radius)
        for n_pad, members in sorted(buckets.items()):
            cap = _batch_cap(n_pad)
            for lo in range(0, len(members), cap):
                chunk = members[lo:lo + cap]
                packed, g = self._pack(n_pad, [structures[i] for i in chunk])
                k = _initial_k(n_pad)
                sasa, mc = _sasa_batched(
                    packed, g, sphere_packed,
                    k=k, n_points=params.n_points, probe=probe,
                )
                pending.append((chunk, (packed, g), k, n_pad, sasa, mc))

        # Phase 2: single sync; re-run overflowed chunks with a bigger K.
        for chunk, inputs, k, n_pad, sasa, mc in pending:
            mc_val = int(mc)
            while mc_val > k:
                k = min(_round_bucket(mc_val, _K_BUCKETS), n_pad)
                sasa, mc = _sasa_batched(
                    inputs[0], inputs[1], sphere_packed,
                    k=k, n_points=params.n_points, probe=probe,
                )
                mc_val = int(mc)
            sasa_np = np.asarray(sasa)
            for slot, i in enumerate(chunk):
                n = structures[i][0].shape[0]
                results[i] = sasa_np[slot, :n]
        return results  # type: ignore[return-value]

    @staticmethod
    def _pack(n_pad, structures):
        b = len(structures)
        packed = np.zeros((b, n_pad, 4), dtype=np.float32)
        g = np.full((b, n_pad), -1, dtype=np.int32)
        for i, (coords, radii, gids) in enumerate(structures):
            n = coords.shape[0]
            packed[i, :n, 0:3] = coords
            packed[i, :n, 3] = radii
            g[i, :n] = _dense_gids(gids, n)
        return packed, g
