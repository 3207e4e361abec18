#!/usr/bin/env python
"""Single-worker proteome benchmark (reference: paper/paper.md:43, 26.0 s).

The reference's single-threaded row pins the per-core efficiency of its
CPU pipeline (rayon pool of 1).  The analog here: ONE host worker thread
for parse/select/emit (the device is the same either way - accelerator
offload is the point of the design, so the device is not throttled).
Reuses bench.py's corpus (run bench.py first to build it).
"""
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from rustsasa_jax.utils.jax_cache import enable_persistent_cache  # noqa: E402

enable_persistent_cache()

from bench import CORPUS_DIR as CORPUS  # noqa: E402

OUT = os.path.join(tempfile.gettempdir(), "rustsasa_jax_bench_out_1w")
REFERENCE_S = 26.0


def main() -> int:
    import shutil

    from rustsasa_jax.api import SASAOptions
    from rustsasa_jax.batch import process_directory
    from rustsasa_jax.levels import Level

    if not os.path.isdir(CORPUS):
        raise SystemExit("run bench.py first to build the corpus")
    options = SASAOptions(level=Level.RESIDUE)
    process_directory(CORPUS, OUT + "_warm", options, "json",
                      workers=1, progress=False)
    if os.path.isdir(OUT):
        shutil.rmtree(OUT)
    t0 = time.time()
    report = process_directory(CORPUS, OUT, options, "json",
                               workers=1, progress=False)
    elapsed = time.time() - t0
    print(
        f"single-worker: {report.n_ok}/{report.n_files} in {elapsed:.2f}s, "
        f"errors={len(report.errors)}", file=sys.stderr, flush=True,
    )
    print(json.dumps({
        "metric": "ecoli_proteome_equiv_single_worker_wall",
        "value": round(elapsed, 3),
        "unit": "s",
        "reference_s": REFERENCE_S,
        "vs_reference": round(REFERENCE_S / elapsed, 3),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
