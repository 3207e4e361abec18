"""Subprocess worker for the multi-process distributed batch test.

Usage: python distributed_worker.py <coord_addr> <num_procs> <proc_id>
       <input_dir> <output_dir> <report_json>

Each worker initializes jax.distributed on the CPU backend, processes its
file shard via process_directory_distributed, and writes the GlobalReport
as JSON.  All workers must produce the SAME global report (that is the
collective correctness check).
"""

import json
import os
import sys


def main() -> int:
    coord, nprocs, pid, input_dir, output_dir, report_path = sys.argv[1:7]
    os.environ.setdefault("JAX_PLATFORMS", "cpu")

    # Optional core pinning (scripts/scaling_curve.py): gives every worker
    # a fixed CPU budget so the scaling curve measures data-parallel
    # speedup rather than XLA's intra-process multithreading, which
    # already saturates this host's cores with a single worker.
    pin = os.environ.get("RSASA_PIN_CPU")
    if pin is not None:
        os.sched_setaffinity(0, {int(pin)})

    import jax

    jax.config.update("jax_platforms", "cpu")
    # Generous shutdown barrier: on an oversubscribed host one worker can
    # finish its shard (and reach the exit barrier) long before another -
    # the default 300 s barrier then kills BOTH with DEADLINE_EXCEEDED.
    jax.distributed.initialize(
        coordinator_address=coord,
        num_processes=int(nprocs),
        process_id=int(pid),
        initialization_timeout=600,
        shutdown_timeout_seconds=900,
    )

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from rustsasa_jax.api import SASAOptions
    from rustsasa_jax.levels import Level
    from rustsasa_jax.parallel.distributed import process_directory_distributed

    import time

    t0 = time.time()
    report = process_directory_distributed(
        input_dir,
        output_dir,
        SASAOptions(level=Level.RESIDUE),
        "json",
        progress=False,
    )
    elapsed = time.time() - t0
    with open(report_path, "w") as f:
        json.dump(
            {
                "n_files": report.n_files,
                "n_ok": report.n_ok,
                "n_errors": report.n_errors,
                "total_area": report.total_area,
                "process_index": jax.process_index(),
                "process_count": jax.process_count(),
                "elapsed_s": elapsed,
            },
            f,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
