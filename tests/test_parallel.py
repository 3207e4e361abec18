"""Multi-device sharding tests on the virtual 8-device CPU mesh."""

import numpy as np
import pytest

import jax


def test_virtual_mesh_available():
    assert len(jax.devices()) == 8


def test_sharded_step_matches_single_device():
    from rustsasa_jax.ops.engine import _sasa_batched
    from rustsasa_jax.parallel.mesh import (
        make_mesh,
        make_sharded_sasa,
        put_batch_sharded,
    )
    import __graft_entry__ as ge

    packed, gid, sphere_packed = ge._example_batch(b=8, n=128)

    ref, _ = _sasa_batched(
        packed, gid, sphere_packed, k=64, n_points=100, probe=1.4,
    )

    mesh = make_mesh(8)
    step = make_sharded_sasa(mesh, k=64, n_points=100)
    sasa, total, max_count = step(
        put_batch_sharded(mesh, packed),
        put_batch_sharded(mesh, gid),
        sphere_packed,
    )
    np.testing.assert_allclose(np.asarray(sasa), np.asarray(ref), atol=1e-3)
    assert float(total[0]) == pytest.approx(float(np.asarray(ref).sum()), rel=1e-5)


def test_dryrun_multichip_entrypoint():
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


def test_entry_compiles():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    sasa, max_count = jax.jit(fn)(*args)
    assert np.asarray(sasa).shape == args[0].shape[:2]
    assert np.isfinite(np.asarray(sasa)).all()


def test_shard_files_round_robin():
    from rustsasa_jax.parallel.distributed import shard_files

    files = [f"f{i}" for i in range(10)]
    shards = [shard_files(files, i, 3) for i in range(3)]
    assert shards[0] == ["f0", "f3", "f6", "f9"]
    assert sorted(sum(shards, [])) == sorted(files)


def test_allreduce_metrics_single_process():
    from rustsasa_jax.parallel.distributed import allreduce_metrics

    g = allreduce_metrics(10, 8, 2, 1234.5)
    assert (g.n_files, g.n_ok, g.n_errors) == (10, 8, 2)
    assert g.total_area == pytest.approx(1234.5)


def test_process_directory_distributed_single(reference_data_dir, tmp_path):
    from rustsasa_jax.api import SASAOptions
    from rustsasa_jax.levels import Level
    from rustsasa_jax.parallel.distributed import process_directory_distributed

    g = process_directory_distributed(
        str(reference_data_dir / "pdbs"),
        str(tmp_path / "out"),
        SASAOptions(level=Level.PROTEIN),
        "json",
        progress=False,
    )
    assert g.n_ok == 3
    assert g.n_errors == 0
