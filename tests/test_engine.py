"""Engine internals: bucketing, overflow re-runs, gid handling."""

import numpy as np
import pytest

from rustsasa_jax.ops.engine import (
    BatchedSasaEngine,
    SasaParams,
    _dense_gids,
    _initial_k,
    _round_bucket,
    _N_BUCKETS,
    calculate_sasa_internal,
)


def test_round_bucket():
    assert _round_bucket(1, _N_BUCKETS) == 8
    assert _round_bucket(129, _N_BUCKETS) == 256
    assert _round_bucket(70000, _N_BUCKETS) == 2 * 65536


def test_dense_gids_passthrough_and_factorize():
    g = np.array([0, 1, 2], np.int32)
    assert _dense_gids(g, 3) is g
    g64 = np.array([100, 100, 7], np.int64)
    out = _dense_gids(g64, 3)
    assert out.dtype == np.int32
    assert out[0] == out[1] != out[2]


def test_overflow_rebucket_exactness():
    """A dense cluster exceeding the initial K must still be exact."""
    rng = np.random.default_rng(0)
    n = 300
    # Very dense ball: hundreds of neighbors within cutoff.
    coords = rng.normal(0, 2.5, (n, 3)).astype(np.float32)
    radii = np.full(n, 1.8, np.float32)
    out = calculate_sasa_internal(coords, radii, backend="xla")
    # Brute-force check on a few atoms.
    from rustsasa_jax.ops.sphere import sphere_points

    S = sphere_points(100)
    probe = 1.4
    for i in (0, 57, 123):
        reff = radii[i] + probe
        pts = coords[i] + reff * S
        d2 = ((pts[:, None, :] - coords[None, :, :]) ** 2).sum(-1)
        occ = d2 < ((radii + probe) ** 2)[None, :]
        occ[:, i] = False
        expected = 4 * np.pi * reff**2 * (~occ.any(1)).sum() / 100
        assert out[i] == pytest.approx(expected, abs=1.5)


def test_batched_mixed_sizes_and_empty():
    rng = np.random.default_rng(1)
    structures = []
    for n in (0, 5, 100, 700):
        c = rng.uniform(0, 20, (n, 3)).astype(np.float32)
        r = np.full(n, 1.7, np.float32)
        structures.append((c, r, None))
    outs = BatchedSasaEngine(SasaParams(), backend="xla").compute(structures)
    assert [len(o) for o in outs] == [0, 5, 100, 700]
    singles = [
        calculate_sasa_internal(c, r, backend="xla")
        for c, r, _ in structures
    ]
    for a, b in zip(outs, singles):
        np.testing.assert_allclose(a, b, atol=1e-3)


def test_initial_k_capped_by_n():
    assert _initial_k(8) == 8
    assert _initial_k(4096) == 160


def test_row_chunked_neighbor_phase_matches_dense():
    """The row-chunked big-N path must produce identical results."""
    import functools
    import jax
    import rustsasa_jax.ops.engine as E

    rng = np.random.default_rng(5)
    n = 1024  # multiple of the patched row chunk below
    c = rng.uniform(0, 40, (n, 3)).astype(np.float32)
    r = np.full(n, 1.7, np.float32)
    gid = np.arange(n, dtype=np.int32)
    packed = np.concatenate([c, r[:, None]], axis=1).astype(np.float32)

    dense = E._neighbor_phase(packed, gid, probe=1.4, k=64)
    old_limit, old_chunk = E._DENSE_N_LIMIT, E._ROW_CHUNK
    try:
        E._DENSE_N_LIMIT, E._ROW_CHUNK = 256, 256
        chunked = E._neighbor_phase(packed, gid, probe=1.4, k=64)
    finally:
        E._DENSE_N_LIMIT, E._ROW_CHUNK = old_limit, old_chunk
    for a, b in zip(dense, chunked):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-4)


def test_warm_shapes_noop_on_cpu():
    """warm_shapes targets the fused device path; on the CPU/XLA backend
    it must return immediately without dispatching anything."""
    from rustsasa_jax.ops.engine import BatchedSasaEngine, SasaParams

    eng = BatchedSasaEngine(SasaParams(), backend="xla")
    assert eng.warm_shapes() == 0.0


def test_engine_routes_small_structures_to_q13(monkeypatch):
    """The production fused path must pick the 6 B/slot q13 wire for
    normal-extent structures and fall back per split for big ones."""
    import numpy as np

    import rustsasa_jax.ops.fused_kernel as fk
    from rustsasa_jax.ops.engine import BatchedSasaEngine, SasaParams

    calls = []
    orig13 = fk.fused_sasa_q13_banded
    orig16 = fk.fused_sasa_q16_banded

    def spy13(*a, **k):
        calls.append("q13")
        return orig13(*a, **k)

    def spy16(*a, **k):
        calls.append("q16")
        return orig16(*a, **k)

    monkeypatch.setattr(fk, "fused_sasa_q13_banded", spy13)
    monkeypatch.setattr(fk, "fused_sasa_q16_banded", spy16)
    monkeypatch.setenv("RUSTSASA_BACKEND", "fused_interpret")

    rng = np.random.default_rng(0)
    rset = np.array([1.55, 1.61, 1.77], np.float32)
    small = (
        (rng.uniform(0, 40, (100, 3)) - 20).astype(np.float32),
        rng.choice(rset, 100).astype(np.float32),
        np.arange(100, dtype=np.int32),
    )
    big = (
        (rng.uniform(0, 140, (100, 3)) - 70).astype(np.float32),
        rng.choice(rset, 100).astype(np.float32),
        np.arange(100, dtype=np.int32),
    )
    eng = BatchedSasaEngine(SasaParams(), backend="fused_interpret")
    out = eng.compute([small, big])
    assert len(out) == 2 and all(o.shape == (100,) for o in out)
    # The mixed chunk must SPLIT: q13 for the small structure, q16 for
    # the >100 A extent one (fused_kernel.MAX_Q13_EXTENT).
    assert sorted(calls) == ["q13", "q16"], calls
