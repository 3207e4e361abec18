#!/usr/bin/env python
"""Occlusion counts: the Pallas kernel vs the plain XLA version, end to end.

Runs process_directory over bench.py's proteome corpus (4,400 files,
10.7M atoms) with each implementation of the counts stage, in the order
kernel, xla, xla, kernel, one warm pass before each first timed pass, and
prints the wall time of every timed pass with the card.  The per-chunk
times of both are printed by chip_smoke.py (phase "kernel parity").

Usage (on a GPU host): python scripts/compare_counts.py
"""

import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from rustsasa_jax.utils.jax_cache import enable_persistent_cache  # noqa: E402

enable_persistent_cache()

import jax  # noqa: E402

from bench import build_corpus  # noqa: E402
from rustsasa_jax.api import SASAOptions  # noqa: E402
from rustsasa_jax.batch import process_directory  # noqa: E402
from rustsasa_jax.levels import Level  # noqa: E402
from rustsasa_jax.ops import fused_kernel as fk  # noqa: E402
from rustsasa_jax.ops.engine import BatchedSasaEngine, SasaParams  # noqa: E402

KERNEL = fk._counts_call


def xla_counts(planes, jlist, sphere, *, interpret):
    return fk.counts_xla(planes, jlist, sphere)


IMPLS = {"kernel": KERNEL, "xla": xla_counts}


def main() -> int:
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU; JAX found {dev.platform!r}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    options = SASAOptions(level=Level.RESIDUE)
    with tempfile.TemporaryDirectory(prefix="compare_counts_") as tmp:
        corpus, n_files, n_atoms = build_corpus(os.path.join(tmp, "corpus"))
        print(f"corpus: {n_files} files, {n_atoms} atoms; card: {card}",
              flush=True)

        def run(tag):
            t0 = time.perf_counter()
            report = process_directory(
                corpus, os.path.join(tmp, tag), options, "json",
                progress=False,
            )
            assert not report.errors, report.errors[:3]
            return time.perf_counter() - t0

        current = None
        for i, impl in enumerate(("kernel", "xla", "xla", "kernel")):
            if impl != current:
                fk._counts_call = IMPLS[impl]
                jax.clear_caches()
                warm = BatchedSasaEngine(SasaParams()).warm_shapes()
                first = run(f"warm{i}")
                print(f"{impl}: warm_shapes {warm:.1f}s, warm pass "
                      f"{first:.3f}s", flush=True)
                current = impl
            print(f"{impl}: timed pass {run(f'out{i}'):.3f}s", flush=True)
    fk._counts_call = KERNEL
    return 0


if __name__ == "__main__":
    sys.exit(main())
