"""Occlusion counts kernel parity tests (interpret mode on CPU).

The Pallas kernel must agree with the plain XLA counts exactly (both are
f32 with the same comparison semantics), and the fused path with the XLA
list path up to coordinate quantization.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from rustsasa_jax.ops.engine import BatchedSasaEngine, SasaParams, calculate_sasa_internal


def random_cluster(n, seed, spread=12.0):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(0, spread, size=(n, 3)).astype(np.float32) + 100.0
    radii = rng.uniform(1.4, 1.9, size=n).astype(np.float32)
    return coords, radii


def _kernel_inputs(n_atoms, seed, *, clear_bits=False, empty_row=False):
    """Packed planes + host-culled j-lists for one random cluster."""
    from rustsasa_jax.ops.fused_kernel import (
        N_PLANES,
        N_XFER_PLANES,
        _pack_structures_numpy,
    )

    coords, radii = random_cluster(n_atoms, seed=seed)
    gids = np.arange(n_atoms, dtype=np.int32)
    planes5, jlist, _, failed = _pack_structures_numpy(
        [(coords, radii, gids)], 1.4, 100
    )
    assert not failed
    planes = np.zeros((N_PLANES, planes5.shape[1]), np.float32)
    planes[:N_XFER_PLANES] = planes5
    jlist = jlist.copy()
    if clear_bits:
        # Drop every other admitted group: the kernel must skip exactly
        # the groups the reference masks out.
        jlist[:, 1:] &= np.uint32(0x5555FFFF)
    if empty_row:
        jlist[0, 0] = 0
    return planes, jlist


@pytest.mark.parametrize("n_points", [60, 100, 256])
def test_counts_kernel_matches_counts_xla(n_points):
    """Interpret-mode kernel vs the plain XLA counts: point padding
    (60, 100 -> whole point blocks) and several point blocks (256)."""
    from rustsasa_jax.ops.engine import _sphere_packed
    from rustsasa_jax.ops.fused_kernel import _counts_call, counts_xla

    planes, jlist = _kernel_inputs(300, seed=n_points)
    sphere = _sphere_packed(n_points)
    ker = np.asarray(_counts_call(planes, jlist, sphere, interpret=True))
    ref = np.asarray(counts_xla(planes, jlist, sphere))
    np.testing.assert_array_equal(ker, ref)
    assert ker.max() <= n_points and (ker[:300] > 0).any()


def test_counts_kernel_cleared_bits_and_empty_row():
    from rustsasa_jax.ops.engine import _sphere_packed
    from rustsasa_jax.ops.fused_kernel import (
        ATOM_TILE,
        _counts_call,
        counts_xla,
    )

    planes, jlist = _kernel_inputs(
        300, seed=5, clear_bits=True, empty_row=True
    )
    sphere = _sphere_packed(100)
    ker = np.asarray(_counts_call(planes, jlist, sphere, interpret=True))
    ref = np.asarray(counts_xla(planes, jlist, sphere))
    np.testing.assert_array_equal(ker, ref)
    # An empty j-list row leaves every real atom of its tile unoccluded.
    assert (ker[:ATOM_TILE] == 100).all()
    full = np.asarray(
        counts_xla(*_kernel_inputs(300, seed=5), sphere)
    )
    assert (ker[ATOM_TILE:300] >= full[ATOM_TILE:300]).all()
    assert (ker[ATOM_TILE:300] > full[ATOM_TILE:300]).any()


@pytest.mark.parametrize("n", [100, 128, 500])
def test_fused_matches_xla_single(n):
    coords, radii = random_cluster(n, seed=n + 7)
    ref = calculate_sasa_internal(coords, radii, backend="xla")
    out = calculate_sasa_internal(coords, radii, backend="fused_interpret")
    np.testing.assert_allclose(out, ref, atol=1e-3)


def test_fused_matches_xla_batched():
    structures = []
    for i, n in enumerate([90, 180, 256, 400]):
        coords, radii = random_cluster(n, seed=20 + i)
        structures.append((coords, radii, None))
    xla = BatchedSasaEngine(SasaParams(), backend="xla").compute(structures)
    fused = BatchedSasaEngine(
        SasaParams(), backend="fused_interpret", readback_dtype=jnp.float32
    ).compute(structures)
    for a, b in zip(xla, fused):
        np.testing.assert_allclose(a, b, atol=1e-3)
    # Default engine readback is f16 (the host link's readback direction is
    # its narrowest resource); rounding must stay inside f16 granularity,
    # far below every parity tolerance (golden eps=25 A^2/atom).
    f16 = BatchedSasaEngine(
        SasaParams(), backend="fused_interpret"
    ).compute(structures)
    for a, b in zip(xla, f16):
        assert b.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=0.05)


def test_fused_group_ids_and_spread_structures():
    # Coincident atoms sharing a group id must not occlude (fused path).
    coords = np.array([[0, 0, 0], [0.5, 0, 0], [3.0, 0, 0]], np.float32) + 50.0
    radii = np.full(3, 1.8, np.float32)
    gids = np.array([5, 5, 9], np.int32)
    ref = calculate_sasa_internal(coords, radii, group_ids=gids, backend="xla")
    out = calculate_sasa_internal(
        coords, radii, group_ids=gids, backend="fused_interpret"
    )
    np.testing.assert_allclose(out, ref, atol=1e-3)


def test_banded_jlist_never_culls_true_neighbors():
    """Device-side culling exactness: every atom pair close enough to
    occlude must have (j's 8-atom group) admitted into (i's tile) j-list.

    False admits are harmless (the kernel's margin self-masks them);
    false CULLS would silently corrupt SASA, so this pins the invariant
    on the real banded pipeline: numpy q16 pack -> dequant -> device
    jlist build, checked pair-by-pair against brute force.
    """
    import jax

    from rustsasa_jax.ops.fused_kernel import (
        ATOM_TILE,
        J_GROUP,
        R_QUANT,
        build_jlist_banded,
        N_PLANES,
        _pack_structures_q16_numpy,
    )

    structures = []
    for i, n in enumerate([64, 333, 1000]):
        coords, radii = random_cluster(n, seed=40 + i)
        structures.append((coords, radii, None))
    probe = 1.4
    planes4, tparams, tmeta, offsets = _pack_structures_q16_numpy(
        [(c, r, None) for c, r, _ in structures], probe
    )
    m = planes4.shape[1]
    # Dequantize exactly as the device does.
    q = planes4.astype(np.float32)
    par = np.repeat(tparams, ATOM_TILE, axis=0)
    planes = np.zeros((N_PLANES, m), np.float32)
    planes[0] = q[0] * par[:, 3] + par[:, 0]
    planes[1] = q[1] * par[:, 3] + par[:, 1]
    planes[2] = q[2] * par[:, 3] + par[:, 2]
    planes[3] = q[3] * np.float32(1.0 / R_QUANT)
    qvalid = q[3] > 0

    jlist = np.asarray(
        jax.jit(
            lambda p, v, t: build_jlist_banded(p, v, t, w=32),
        )(planes, qvalid, tmeta)
    )

    for pos, n, _inv in offsets:
        c = planes[0:3, pos:pos + n].T
        reff = planes[3, pos:pos + n]
        d = np.linalg.norm(c[:, None, :] - c[None, :, :], axis=-1)
        close = d < (reff[:, None] + reff[None, :])
        ii, jj = np.nonzero(close)
        for a, b in zip(ii, jj):
            ti = (pos + a) // ATOM_TILE
            tj = (pos + b) // ATOM_TILE
            gj = ((pos + b) % ATOM_TILE) // J_GROUP
            row = jlist[ti]
            cnt = row[0]
            entries = row[1:1 + cnt]
            match = entries[(entries & 0xFFFF) == tj]
            assert match.size == 1, (ti, tj)
            assert (int(match[0]) >> 16) & (1 << gj), (ti, tj, gj)
        # nearest-first: keys were sorted, so counts bound the row
        assert jlist[:, 0].max() <= 127


def test_pack_q16_native_matches_numpy():
    from rustsasa_jax.native import fastpack_q16
    from rustsasa_jax.ops.fused_kernel import _pack_structures_q16_numpy

    rng = np.random.default_rng(11)
    structures = []
    for n in (3, 100, 128, 700, 2622):
        coords = (rng.uniform(0, 40, (n, 3)) + 100).astype(np.float32)
        radii = rng.uniform(1.4, 1.9, n).astype(np.float32)
        structures.append((coords, radii, np.arange(n, dtype=np.int32)))
    a = fastpack_q16(structures, 1.4)
    if a is None:
        pytest.skip("native library unavailable")
    b = _pack_structures_q16_numpy(structures, 1.4)
    np.testing.assert_array_equal(a[0], b[0])  # planes4
    np.testing.assert_array_equal(a[1], b[1])  # tparams
    np.testing.assert_array_equal(a[2], b[2])  # tmeta
    for oa, ob in zip(a[3], b[3]):
        assert oa[0] == ob[0] and oa[1] == ob[1]
        np.testing.assert_array_equal(oa[2], ob[2])


def test_banded_multi_tile_band_widths():
    # A ~41-tile structure exercises the w=64 bucket end to end.
    coords, radii = random_cluster(5200, seed=77)
    ref = calculate_sasa_internal(coords, radii, backend="xla")
    out = calculate_sasa_internal(coords, radii, backend="fused_interpret")
    # Coordinate quantization can flip boundary sphere points; allow a
    # couple of point-flips per atom (area/point ~ 1.4 A^2).
    np.testing.assert_allclose(out, ref, atol=3.0)


def test_mixed_eligibility_batch_splits_sub_chunks():
    # A batch mixing banded-eligible structures with one alt-loc-style
    # gid-collision structure: the engine must split the chunk so the
    # eligible ones keep the banded path, and ALL results stay correct.
    structures = []
    for i, n in enumerate([150, 260]):
        coords, radii = random_cluster(n, seed=60 + i)
        structures.append((coords, radii, None))
    coords, radii = random_cluster(120, seed=66)
    gids = np.arange(120, dtype=np.int32)
    gids[1] = gids[0]  # two atoms share an exclusion id
    structures.insert(1, (coords, radii, gids))
    xla = BatchedSasaEngine(SasaParams(), backend="xla").compute(structures)
    fused = BatchedSasaEngine(
        SasaParams(), backend="fused_interpret", readback_dtype=jnp.float32
    ).compute(structures)
    for a, b in zip(xla, fused):
        np.testing.assert_allclose(a, b, atol=3.0)
