#!/usr/bin/env python
"""Headline benchmark: E. coli-proteome-equivalent residue-level SASA.

Baseline (BASELINE.md): RustSASA processes the AlphaFold E. coli proteome
(~4,400 structures, ~10.7M atoms) at residue level in 5.237 s on an 8-core
Apple M3.  The proteome itself is not downloadable here (zero egress), so
the corpus is reconstructed from the real PDB structures in the reference
test suite: files are replicated (as symlinks, so every parse does real
I/O) until the corpus matches the proteome's scale - 4,400 structures AND
~10.7M atoms, preferring smaller files to match AlphaFold's size profile.

The measured quantity is the full end-to-end pipeline on this machine:
parse -> atom selection -> device SASA (GPU) -> residue aggregation ->
JSON written per structure, identical to the reference's benchmark
protocol (CLI directory mode, README.md:163).  It fails when JAX finds no
GPU, and when the device-path quality gate fails.

Prints exactly one JSON line:
  {"metric": "...", "value": <wall seconds>, "unit": "s",
   "vs_baseline": <ratio>, ...,
   "device": {"platform": ..., "kind": ..., "count": ...}}
vs_baseline > 1 means faster than the reference's published 5.237 s.
"""

import json
import os
import shutil
import sys
import tempfile
import time

BASELINE_SECONDS = 5.237  # reference: README.md:155, paper/paper.md:41
TARGET_FILES = 4400
TARGET_ATOMS = 10_700_000

REPO = os.path.dirname(os.path.abspath(__file__))
SOURCE_DIR = os.path.join(REPO, "tests", "data", "freesasa_pdbs")
CORPUS_DIR = os.path.join(tempfile.gettempdir(), "rustsasa_jax_bench_corpus")
OUTPUT_DIR = os.path.join(tempfile.gettempdir(), "rustsasa_jax_bench_out")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def build_corpus(corpus_dir: str = CORPUS_DIR) -> tuple[str, int, int]:
    """Symlink-replicate the repo's 88 PDBs to proteome scale."""
    from rustsasa_jax.io.read import read_structure

    src_dir = SOURCE_DIR
    files = sorted(
        os.path.join(src_dir, f)
        for f in os.listdir(src_dir)
        if f.endswith((".pdb", ".cif", ".pdb.gz", ".cif.gz"))
    )
    sizes = {}
    for f in files:
        sizes[f] = read_structure(f).n_atoms()
    # Match the reference proteome on BOTH axes: 4,400 files and ~10.7M
    # atoms (avg ~2,432 atoms/file - AlphaFold's E. coli size profile).
    # Cycle the largest ascending-size prefix whose mean stays at or under
    # that average, so the replicated corpus hits the atom target too.
    target_mean = TARGET_ATOMS / TARGET_FILES
    ordered = sorted(files, key=lambda f: sizes[f])
    prefix = []
    total = 0
    for f in ordered:
        if prefix and (total + sizes[f]) / (len(prefix) + 1) > target_mean:
            break
        prefix.append(f)
        total += sizes[f]
    small = prefix or ordered[:1]

    if os.path.isdir(corpus_dir):
        shutil.rmtree(corpus_dir)
    os.makedirs(corpus_dir)
    total_atoms = 0
    count = 0
    i = 0
    while count < TARGET_FILES or total_atoms < TARGET_ATOMS:
        f = small[i % len(small)]
        # "1abc.pdb.gz" -> "1abc_00042.pdb.gz": every replica keeps its
        # format suffix and writes its own output file.
        stem, ext = os.path.basename(f).split(".", 1)
        os.symlink(f, os.path.join(corpus_dir, f"{stem}_{count:05d}.{ext}"))
        total_atoms += sizes[f]
        count += 1
        i += 1
        if count > 20000:  # safety stop
            break
    return corpus_dir, count, total_atoms


def main() -> int:
    from rustsasa_jax.utils.jax_cache import enable_persistent_cache

    enable_persistent_cache()

    import jax

    from rustsasa_jax.api import SASAOptions
    from rustsasa_jax.batch import process_directory
    from rustsasa_jax.levels import Level

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {dev.platform!r}")
    log(f"devices: {jax.devices()}")
    corpus, n_files, n_atoms = build_corpus()
    log(f"corpus: {n_files} structures, {n_atoms} atoms at {corpus}")

    options = SASAOptions(level=Level.RESIDUE)

    # Warmup mirrors the reference's protocol (hyperfine warmup runs,
    # README.md:163) and its PGO build step (rust.yml:59-137):
    # compilation is a one-time artifact of the deployment, not per-run
    # work.
    from rustsasa_jax.utils import stagestats as _ss

    from rustsasa_jax.ops.engine import BatchedSasaEngine, SasaParams

    # Stage 1: compile and load every production chunk shape on every
    # device (engine.warm_shapes), so no compile lands in a timed pass.
    warm_engine = BatchedSasaEngine(SasaParams())
    t0 = time.time()
    shape_elapsed = warm_engine.warm_shapes()
    log(f"warm_shapes (executable loads) took {shape_elapsed:.1f}s")

    # Stage 2: one FULL corpus pass — the reference's protocol warms
    # with full runs too (hyperfine 3 warmup runs, README.md:163).
    _ss.reset()
    process_directory(
        corpus, OUTPUT_DIR + "_warm", options, "json", progress=False,
    )
    warm_elapsed = time.time() - t0
    log(f"warmup pass took {warm_elapsed:.1f}s")
    if _ss.enabled:
        log("warmup stage split (dispatch includes per-shape executable "
            "loads; device_wait includes first-shape compiles/loads):")
        log(_ss.report(warm_elapsed))

    # Timed passes: 5 runs, median reported (the reference's protocol is
    # hyperfine with 3 runs + 3 warmup, README.md:163).
    from rustsasa_jax.utils import stagestats

    runs = []
    for i in range(5):
        if os.path.isdir(OUTPUT_DIR):
            shutil.rmtree(OUTPUT_DIR)
        stagestats.reset()
        t0 = time.time()
        report = process_directory(
            corpus, OUTPUT_DIR, options, "json", progress=False
        )
        elapsed = time.time() - t0
        runs.append(elapsed)
        if stagestats.enabled:
            log("main-thread stage split (collect = device_wait + unpack):")
            log(stagestats.report(elapsed))
        log(
            f"run {i}: {report.n_ok}/{report.n_files} files in {elapsed:.2f}s "
            f"({n_atoms / elapsed / 1e6:.2f} Matoms/s, "
            f"{report.n_files / elapsed:.0f} structures/s); "
            f"errors: {len(report.errors)}"
        )
        for e in report.errors[:5]:
            log(f"  error: {e}")
    runs.sort()
    elapsed = runs[len(runs) // 2]
    log(f"median {elapsed:.2f}s (best {runs[0]:.2f}s, worst {runs[-1]:.2f}s)")

    # Device-path quality gate: the 88-PDB FreeSASA RMSE gate through the
    # same production backend the timed runs used (reference:
    # tests/quality.rs:17-18; the pytest gate covers only the CPU/XLA
    # backend).  A failed gate fails the benchmark.
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from quality_gate import run_gate

    gate = run_gate()
    for row in gate["rows"]:
        log(f"quality gate [{row['depth']:17s}]: rmse={row['rmse']} "
            f"n={row['n']} pass={row['pass']}")
    if not gate["pass"]:
        log("quality gate FAILED")
        return 1

    print(
        json.dumps(
            {
                "metric": "ecoli_proteome_equiv_residue_sasa_wall",
                "value": round(elapsed, 3),
                "unit": "s",
                "vs_baseline": round(BASELINE_SECONDS / elapsed, 3),
                "runs": [round(r, 3) for r in runs],
                "best": round(runs[0], 3),
                "best_vs_baseline": round(BASELINE_SECONDS / runs[0], 3),
                "warmup_s": round(warm_elapsed, 1),
                "quality_pass": gate["pass"],
                "quality_residue_rmse": gate["rmse"],
                "device": {
                    "platform": dev.platform,
                    "kind": dev.device_kind,
                    "count": len(jax.devices()),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
