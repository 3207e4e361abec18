"""Multi-host distributed batch processing.

The reference is strictly single-process (SURVEY 2: no MPI/NCCL; rayon
threads only).  The accelerator-native scale-out axis is jax.distributed over
hosts, with the corpus sharded per process:

  * each host reads ITS OWN file shard (round-robin by process index) -
    ingest bandwidth scales with hosts, no cross-host data motion;
  * per-structure results are written locally by the owning host
    (per-file outputs, as in the reference's directory mode);
  * the only collectives are run-level metrics (structure counts, total
    area, error counts) - an all-reduce over a tiny vector on the global
    mesh, riding ICI within a slice and DCN across slices.

Single-process runs degrade gracefully: shard = everything, reductions
are identity.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import jax
import numpy as np


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Initialize jax.distributed when a multi-process env is configured.

    Returns True when running multi-process.  Arguments default to the
    standard JAX env vars; a bare single-host run is a no-op.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None:
        env = os.environ.get("JAX_NUM_PROCESSES")
        num_processes = int(env) if env else None
    if process_id is None:
        env = os.environ.get("JAX_PROCESS_ID")
        process_id = int(env) if env else None
    if not coordinator_address or not num_processes or num_processes <= 1:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def shard_files(files: list[str], process_index: int | None = None,
                process_count: int | None = None) -> list[str]:
    """Round-robin file shard for this host (deterministic, size-balanced
    when the listing is sorted)."""
    pi = jax.process_index() if process_index is None else process_index
    pc = jax.process_count() if process_count is None else process_count
    return files[pi::pc]


@dataclass
class GlobalReport:
    n_files: int
    n_ok: int
    n_errors: int
    total_area: float


def allreduce_metrics(
    n_files: int, n_ok: int, n_errors: int, total_area: float
) -> GlobalReport:
    """Sum run metrics across all hosts (identity on one process).

    Uses a tiny jitted psum over the global device set - the only
    cross-host communication in the batch pipeline.
    """
    # Counts ride as int32 (exact to 2^31 files; f32 lost exactness at
    # 2^24 on a path aimed at proteome-scale corpora).  total_area rides
    # as a two-float Dekker split (hi = f32(x), lo = f32(x - hi)) psum'd
    # componentwise and recombined in f64 on host, keeping ~14 significant
    # digits without requiring jax_enable_x64.
    hi = np.float32(total_area)
    lo = np.float32(total_area - float(hi))
    counts = np.array([n_files, n_ok, n_errors], dtype=np.int32)
    area2 = np.array([hi, lo], dtype=np.float32)
    if jax.process_count() == 1:
        counts_sum, area_sum = counts, area2.astype(np.float64)
    else:
        from jax.sharding import Mesh, PartitionSpec as P

        devs = np.array(jax.devices())
        mesh = Mesh(devs, ("d",))

        def reduce_fn(c, a):
            return jax.lax.psum(c, "d"), jax.lax.psum(a, "d")

        fn = jax.jit(
            jax.shard_map(
                reduce_fn, mesh=mesh,
                in_specs=(P("d", None), P("d", None)), out_specs=(P(), P()),
            )
        )
        # Only device 0 of each host contributes its process-local values;
        # the others contribute zeros, so the global psum equals the sum
        # over hosts with no division round-off.
        nl = jax.local_device_count()
        per_dev_c = np.zeros((nl, 3), dtype=np.int32)
        per_dev_c[0] = counts
        per_dev_a = np.zeros((nl, 2), dtype=np.float32)
        per_dev_a[0] = area2
        sh = jax.sharding.NamedSharding(mesh, P("d", None))
        arr_c = jax.make_array_from_process_local_data(sh, per_dev_c)
        arr_a = jax.make_array_from_process_local_data(sh, per_dev_a)
        c_out, a_out = fn(arr_c, arr_a)
        counts_sum = np.asarray(c_out).reshape(-1)
        area_sum = np.asarray(a_out).reshape(-1).astype(np.float64)
    return GlobalReport(
        n_files=int(counts_sum[0]),
        n_ok=int(counts_sum[1]),
        n_errors=int(counts_sum[2]),
        total_area=float(area_sum[0] + area_sum[1]),
    )


def process_directory_distributed(
    input_dir: str,
    output_dir: str,
    options,
    output_format: str,
    **kwargs,
) -> GlobalReport:
    """Multi-host directory batch: shard files, process locally, reduce
    metrics globally.  Every host must call this collectively."""
    import jax

    from ..batch import process_directory

    if jax.process_count() > 1:
        # Establish the cross-process collective context NOW, while all
        # hosts are still in lockstep after startup.  The first psum
        # builds the Gloo/ICI communicator with a bounded peer-rendezvous
        # timeout (~30 s on the CPU backend); deferring it to the final
        # metrics reduce makes the whole job die whenever shard
        # processing skews hosts by more than that timeout.
        allreduce_metrics(0, 0, 0, 0.0)

    entries = sorted(os.listdir(input_dir))
    files = [f for f in entries if os.path.isfile(os.path.join(input_dir, f))]
    my_files = shard_files(files)

    # Process only this host's shard via a filtered view directory.
    report = process_directory(
        input_dir,
        output_dir,
        options,
        output_format,
        file_filter=set(my_files),
        **kwargs,
    )
    return allreduce_metrics(
        report.n_files, report.n_ok, len(report.errors), report.total_area
    )
