#!/usr/bin/env python
"""Multi-host scaling curve on the virtual CPU backend (SURVEY.md section 6).

Runs the SAME fixed corpus through process_directory_distributed at 1, 2
and 4 coordinator-connected processes (the tests/distributed_worker.py
worker: round-robin file shards, full batch pipeline per shard, psum
metrics allreduce) and records aggregate structures/s per configuration
plus the collective-correctness assertions of tests/test_distributed.py
(every worker must report identical global totals; every input covered).

This host has 2 CPU cores, so the expected honest shape is ~linear from
1 -> 2 workers and saturation at 4 (documented in the artifact); on a
real multi-host cluster each process owns its own cards and host cores,
and the same sharding/allreduce machinery is what scales.

Usage: python scripts/scaling_curve.py [out_artifact]
"""
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "distributed_worker.py")
SRC = os.path.join(REPO, "tests", "data", "freesasa_pdbs")
N_FILES = 66


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def build_corpus(d: str) -> int:
    if os.path.isdir(d):
        shutil.rmtree(d)
    os.makedirs(d)
    import gzip

    # 11 distinct sources: coprime with 2 and 4, so the round-robin
    # shard assignment cycles every source through every worker (12
    # sources gave each of 2/4 workers a FIXED subset - source sizes
    # vary ~20x, which made the shards wildly time-imbalanced).
    srcs = sorted(
        f for f in os.listdir(SRC) if f.endswith((".pdb", ".pdb.gz"))
    )[:11]
    count = 0
    while count < N_FILES:
        s = srcs[count % len(srcs)]
        src_path = os.path.join(SRC, s)
        stem = s[:-3] if s.endswith(".gz") else s
        dst = os.path.join(d, f"{count:04d}_{stem}")
        if s.endswith(".gz"):
            with gzip.open(src_path, "rb") as f:
                with open(dst, "wb") as g:
                    g.write(f.read())
        else:
            shutil.copy(src_path, dst)
        count += 1
    return count


def run_config(nprocs: int, input_dir: str, scratch: str) -> dict:
    out_dir = os.path.join(scratch, f"out_{nprocs}")
    if os.path.isdir(out_dir):
        shutil.rmtree(out_dir)
    print(f"running {nprocs}-process config...", file=sys.stderr, flush=True)
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    procs = []
    report_paths = []
    ncores = os.cpu_count() or 1
    t0 = time.time()
    for pid in range(nprocs):
        rp = os.path.join(scratch, f"report_{nprocs}_{pid}.json")
        report_paths.append(rp)
        # One core per worker (round-robin when oversubscribed): the
        # curve then measures data-parallel scaling at fixed per-process
        # resources - the pod situation - rather than XLA's
        # intra-process multithreading, which already fills this host's
        # 2 cores with a single unpinned worker.
        penv = dict(env)
        penv["RSASA_PIN_CPU"] = str(pid % ncores)
        procs.append(
            subprocess.Popen(
                [sys.executable, WORKER, coord, str(nprocs), str(pid),
                 input_dir, out_dir, rp],
                env=penv, stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL,
            )
        )
    for p in procs:
        rc = p.wait(timeout=1200)
        assert rc == 0, f"worker failed rc={rc}"
    wall = time.time() - t0
    reports = [json.load(open(rp)) for rp in report_paths]
    # Collective correctness: identical global reports on every worker.
    for r in reports[1:]:
        assert r["n_files"] == reports[0]["n_files"]
        assert r["n_ok"] == reports[0]["n_ok"]
        assert abs(r["total_area"] - reports[0]["total_area"]) < 1e-3
    assert reports[0]["n_ok"] == N_FILES
    outs = len(os.listdir(out_dir))
    assert outs == N_FILES, f"{outs} outputs != {N_FILES}"
    # Processing-phase wall: the slowest worker's shard time (startup +
    # per-process compile excluded; those are fixed costs a real pod pays
    # once, and on this 2-core host they dominate the end-to-end wall).
    proc_wall = max(r["elapsed_s"] for r in reports)
    return {
        "processes": nprocs,
        "end_to_end_wall_s": round(wall, 2),
        "processing_wall_s": round(proc_wall, 2),
        "worker_walls_s": [round(r["elapsed_s"], 2) for r in reports],
        "structures_per_s": round(N_FILES / proc_wall, 2),
        "global_n_ok": reports[0]["n_ok"],
        "global_total_area": round(reports[0]["total_area"], 2),
    }


def main() -> int:
    scratch = os.path.join(tempfile.gettempdir(), "rsasa_scaling")
    input_dir = os.path.join(scratch, "corpus")
    os.makedirs(scratch, exist_ok=True)
    n = build_corpus(input_dir)
    rows = [run_config(p, input_dir, scratch) for p in (1, 2, 4)]
    result = {
        "corpus_files": n,
        "host_cores": os.cpu_count(),
        "backend": "cpu (jax.distributed, per-process coordinator)",
        "note": (
            "processing_wall_s = slowest worker's shard (startup/compile "
            "excluded); each worker is pinned to one core so the curve "
            f"measures data-parallel scaling at fixed per-process "
            f"resources; with {os.cpu_count()} host cores the expected "
            "honest shape is ~linear 1->2 processes and degradation at 4 "
            "(oversubscription) - on a cluster every process owns its own "
            "cards+cores and the same shard/psum machinery scales on; "
            "all workers must agree on the psum-allreduced global report "
            "and every input is covered exactly once"
        ),
        "rows": rows,
    }
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as f:
            json.dump(result, f, indent=1)
            f.write("\n")
    print(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
