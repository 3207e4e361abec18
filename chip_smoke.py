#!/usr/bin/env python
"""Run the SASA pipeline once on a GPU, at real size, and check it.

    python chip_smoke.py               # one card, every phase below
    python chip_smoke.py --four-cards  # only the multi-card corpus pass

Phases, each fatal on failure:
  1. device        a GPU must be present; prints its name and power limit
  2. compile       the production chunk (M = 2,097,152 slots, w = 32) and
                   the widest band (w = 127), with memory_analysis()
  3. kernel        the occlusion counts kernel vs counts_xla on one full
                   chunk built from the 88 test PDBs, with both timings
  4. fused vs xla  BatchedSasaEngine fused vs the plain f32 list path
                   (backend="xla", HIGHEST precision) on all 88 PDBs:
                   per atom within three flipped points, at most 5% of
                   atoms off by more than 0.01 A^2
  5. cli           cli.main on example.cif at protein depth
  6. proteome      process_directory over bench.py's corpus (4,400 files,
                   10.7M atoms): one warm and one timed pass, 0 errors,
                   every replica's JSON equal to its source's
  7. quality       the 88-PDB FreeSASA gate at all depths + occupancy
  8. trajectory    a seeded 200-frame DCD of example.cif; frame 0 must
                   match phase 5

With --four-cards only the proteome corpus runs: on all local cards
(chunks round-robin over devices) and on card 0 alone; the output files
must be byte-identical.

The last line of stdout is one JSON object:
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PDB_DIR = os.path.join(REPO, "tests", "data", "freesasa_pdbs")
EXAMPLE = os.path.join(REPO, "tests", "data", "pdbs", "example.cif")
CHUNK = 2_097_152  # engine.CHUNK_SLOT_BUDGET
N_POINTS = 100
# Fused vs plain f32: the q13 wire moves each coordinate by at most half a
# step (0.0061 A); a flipped point is worth 4 pi r^2 / 100 <= 1.5 A^2.
# On the 88 PDBs up to three points of one atom flip (4.06 A^2, the same
# atoms in Pallas interpret mode on the CPU as on the card), so the bound
# is three points.
ATOM_MAX_DIFF = 4.5
ATOM_FRAC_DIFF = 0.05
# Kernel vs counts_xla: FMA contraction and division order may differ, so
# a margin within rounding of 0 may flip one point.
KERNEL_FRAC_DIFF = 1e-4
CLI_TOTAL, CLI_TOL = 20268.0, 1500.0  # reference: units.rs:58


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok, msg) -> None:
    """Fail the run (unlike assert, this survives python -O)."""
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def phase(name: str):
    log(f"== {name}")
    return time.perf_counter()


def timed(fn, reps: int = 5) -> float:
    """Median seconds of fn() after one warm call; fn must block."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def pdb_files() -> list[str]:
    return sorted(
        os.path.join(PDB_DIR, f) for f in os.listdir(PDB_DIR)
        if f.endswith(".pdb.gz")
    )


def selections(files):
    from rustsasa_jax.api import SASAOptions
    from rustsasa_jax.io.read import read_structure
    from rustsasa_jax.levels import Level

    options = SASAOptions(level=Level.RESIDUE)
    out = []
    for f in files:
        sel = options.build_selection(read_structure(f))
        out.append((sel.coords, sel.radii, sel.group_ids))
    return out


def check_device():
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke needs a GPU; JAX found {devices[0].platform!r}"
        )
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    log(f"card: {smi}")
    log(f"jax {jax.__version__}: {len(devices)} x {devices[0].device_kind}")
    return devices


def phase_compile():
    import jax
    import jax.numpy as jnp

    from rustsasa_jax.ops import fused_kernel as fk
    from rustsasa_jax.ops.engine import _sphere_packed

    t = CHUNK // fk.ATOM_TILE
    s = jax.ShapeDtypeStruct
    sphere = s(_sphere_packed(N_POINTS).shape, jnp.float32)
    t0 = time.perf_counter()
    compiled = fk.fused_sasa_q13_banded.trace(
        s((CHUNK,), jnp.uint32), s((CHUNK,), jnp.uint16),
        s((256,), jnp.float32), s((t, 4), jnp.float32),
        s((t, 2), jnp.int32), sphere, n_points=N_POINTS, w=32,
    ).lower().compile()
    log(f"fused_sasa_q13_banded M={CHUNK} w=32 compiled in "
        f"{time.perf_counter() - t0:.1f}s: {compiled.memory_analysis()}")
    planes = s((fk.N_PLANES, CHUNK), jnp.float32)
    jlist = s((t, fk.JLIST_ROWS), jnp.int32)
    for w in (32, 127):
        t0 = time.perf_counter()
        compiled = jax.jit(
            fk.build_jlist_banded, static_argnames="w"
        ).trace(planes, s((CHUNK,), jnp.bool_), s((t, 2), jnp.int32),
                w=w).lower().compile()
        log(f"build_jlist_banded M={CHUNK} w={w} compiled in "
            f"{time.perf_counter() - t0:.1f}s: "
            f"{compiled.memory_analysis()}")
    t0 = time.perf_counter()
    compiled = fk.counts_xla.trace(planes, jlist, sphere).lower().compile()
    log(f"counts_xla M={CHUNK} compiled in {time.perf_counter() - t0:.1f}s:"
        f" {compiled.memory_analysis()}")


def real_chunk(triples, m: int = CHUNK, *, w: int = 32):
    """One full q13 chunk of replicated structures -> device planes, jlist.

    Structures the production path would send to this shape (q13 extent,
    at most w tiles) are taken in order, cycling, until the next would
    overflow m slots; the chunk is padded to exactly m.  Returns (planes,
    jlist, n_real_atoms).
    """
    import jax
    import numpy as np

    from rustsasa_jax.ops import fused_kernel as fk

    triples = [
        t for t in triples
        if t[0].shape[0] <= w * fk.ATOM_TILE
        and float(np.ptp(t[0], axis=0).max()) <= fk.MAX_Q13_EXTENT
    ]
    chunk, slots, k = [], 0, 0
    while True:
        tri = triples[k % len(triples)]
        n = -(-tri[0].shape[0] // fk.ATOM_TILE) * fk.ATOM_TILE
        if slots + n > m:
            break
        chunk.append(tri)
        slots += n
        k += 1
    wire_a, wire_b, palette, tparams, tmeta, _ = fk.pack_structures_q13(
        chunk, 1.4
    )
    pad, pad_t = m - wire_a.shape[0], (m - wire_a.shape[0]) // fk.ATOM_TILE
    wire_a = np.pad(wire_a, (0, pad))
    wire_b = np.pad(wire_b, (0, pad))
    tparams = np.pad(tparams, ((0, pad_t), (0, 0)))
    tmeta = np.pad(tmeta, ((0, pad_t), (0, 0)))

    @jax.jit
    def build(wire_a, wire_b, palette, tparams, tmeta):
        planes, qvalid = fk.planes_q13(wire_a, wire_b, palette, tparams)
        return planes, fk.build_jlist_banded(planes, qvalid, tmeta, w=w)

    planes, jlist = build(wire_a, wire_b, palette, tparams, tmeta)
    n_real = sum(t[0].shape[0] for t in chunk)
    return planes, jlist, n_real


def admitted_j_atoms(jlist) -> int:
    """j-atoms the kernel streams: 8 per set group-mask bit."""
    import numpy as np

    j = np.asarray(jlist)
    cols = np.arange(j.shape[1])[None, :]
    live = (cols >= 1) & (cols <= j[:, :1])
    masks = (j.view(np.uint32) >> 16) * live
    bits = np.unpackbits(masks.astype(">u2").view(np.uint8)).sum()
    return int(bits) * 8


def phase_kernel(triples, *, interpret: bool = False, m: int = CHUNK):
    import jax
    import numpy as np

    from rustsasa_jax.ops import fused_kernel as fk
    from rustsasa_jax.ops.engine import _sphere_packed

    planes, jlist, n_real = real_chunk(triples, m)
    sphere = jax.device_put(_sphere_packed(N_POINTS))
    kernel = jax.jit(lambda p, j, s: fk._counts_call(
        p, j, s, interpret=interpret))
    ker = np.asarray(kernel(planes, jlist, sphere))
    ref = np.asarray(fk.counts_xla(planes, jlist, sphere))
    diff = np.abs(ker.astype(np.int64) - ref.astype(np.int64))
    n_diff = int((diff > 0).sum())
    log(f"chunk: {m} slots, {n_real} atoms, "
        f"{admitted_j_atoms(jlist) * fk.ATOM_TILE / n_real:.0f} admitted "
        f"j-atoms per i-atom (tile-level)")
    log(f"kernel vs counts_xla: {n_diff} of {m} slots differ "
        f"(max {int(diff.max())} point)")
    check(diff.max() <= 1, f"max count difference {diff.max()}")
    check(n_diff <= KERNEL_FRAC_DIFF * n_real, f"{n_diff} slots differ")
    check(ker.sum() > 0, "no accessible point in the chunk")
    t_ker = timed(lambda: kernel(planes, jlist, sphere).block_until_ready())
    t_xla = timed(
        lambda: fk.counts_xla(planes, jlist, sphere).block_until_ready()
    )
    log(f"counts stage at {m} slots: kernel {t_ker * 1e3:.2f} ms, "
        f"counts_xla {t_xla * 1e3:.2f} ms (median of 5)")


def phase_fused_vs_xla(triples, *, backend: str = "fused"):
    """Per-atom bound on every atom; the share bound over all atoms (one
    small, elongated structure can exceed 5% on its own, since its q13
    step is coarser)."""
    import numpy as np

    from rustsasa_jax.ops.engine import BatchedSasaEngine, SasaParams

    fused = BatchedSasaEngine(SasaParams(), backend=backend).compute(triples)
    plain = BatchedSasaEngine(SasaParams(), backend="xla").compute(triples)
    diff = np.concatenate([
        np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
        for a, b in zip(fused, plain)
    ])
    worst, share = float(diff.max()), float((diff > 1e-2).mean())
    log(f"fused vs xla on {len(triples)} structures, {diff.size} atoms: "
        f"max per-atom |d| {worst:.4f} A^2 (limit {ATOM_MAX_DIFF}); "
        f"{100 * share:.3f}% of atoms differ by > 0.01 A^2 (limit "
        f"{100 * ATOM_FRAC_DIFF:.0f}%)")
    check(worst <= ATOM_MAX_DIFF and share <= ATOM_FRAC_DIFF,
          "fused vs xla outside its bounds")


def phase_cli(tmp: str) -> float:
    from rustsasa_jax import cli

    out = os.path.join(tmp, "example_protein.json")
    rc = cli.main([EXAMPLE, out, "--output-depth", "protein"])
    check(rc == 0, f"cli exit {rc}")
    with open(out) as f:
        total = float(json.load(f)["Protein"]["global_total"])
    log(f"cli example.cif protein total {total:.3f} "
        f"(reference {CLI_TOTAL} +- {CLI_TOL})")
    check(abs(total - CLI_TOTAL) <= CLI_TOL, f"cli total {total}")
    return total


def run_corpus(corpus: str, out: str, engine=None) -> float:
    from rustsasa_jax.api import SASAOptions
    from rustsasa_jax.batch import process_directory
    from rustsasa_jax.levels import Level

    t0 = time.perf_counter()
    report = process_directory(
        corpus, out, SASAOptions(level=Level.RESIDUE), "json",
        progress=False, engine=engine,
    )
    elapsed = time.perf_counter() - t0
    check(not report.errors, report.errors[:5])
    check(report.n_ok == report.n_files,
          f"{report.n_ok} of {report.n_files} files ok")
    return elapsed


def check_replicas(corpus: str, out: str) -> int:
    """Every replica's JSON must equal its source file's first replica."""
    first: dict[str, bytes] = {}
    n = 0
    for name in sorted(os.listdir(corpus)):
        src = os.path.realpath(os.path.join(corpus, name))
        with open(os.path.join(out, name.split(".")[0] + ".json"),
                  "rb") as f:
            data = f.read()
        check(first.setdefault(src, data) == data, f"{name} differs")
        n += 1
    return n


def build_corpus(tmp: str):
    sys.path.insert(0, REPO)
    from bench import TARGET_ATOMS, TARGET_FILES, build_corpus

    corpus, n_files, n_atoms = build_corpus(os.path.join(tmp, "corpus"))
    log(f"corpus: {n_files} files, {n_atoms} atoms")
    check(n_files >= TARGET_FILES and n_atoms >= TARGET_ATOMS,
          "corpus below proteome scale")
    return corpus, n_files, n_atoms


def ingest_path() -> str:
    from rustsasa_jax.native import pipe_library

    return "native C++" if pipe_library() is not None else "numpy fallback"


def phase_proteome(tmp: str, card: str):
    from rustsasa_jax.ops.engine import BatchedSasaEngine, SasaParams

    corpus, n_files, n_atoms = build_corpus(tmp)
    log(f"ingest: {ingest_path()}")
    warm = BatchedSasaEngine(SasaParams()).warm_shapes()
    log(f"warm_shapes {warm:.1f}s")
    t_warm = run_corpus(corpus, os.path.join(tmp, "out_warm"))
    t = run_corpus(corpus, os.path.join(tmp, "out"))
    n = check_replicas(corpus, os.path.join(tmp, "out"))
    log(f"proteome: {n_files} files, {n_atoms} atoms, 0 errors, {n} "
        f"replica outputs equal their source; warm pass {t_warm:.3f}s, "
        f"timed pass {t:.3f}s on {card}")


def phase_quality():
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from quality_gate import run_gate

    gate = run_gate()
    for row in gate["rows"]:
        log(f"quality [{row['depth']:17s}] rmse={row['rmse']} n={row['n']} "
            f"files={row['n_ok']}/{row['n_files']} pass={row['pass']}")
    check(gate["platform"] == "gpu", f"gate ran on {gate['platform']}")
    check(gate["pass"], "quality gate failed")


def phase_trajectory(tmp: str, cli_total: float):
    import numpy as np

    from rustsasa_jax.api import SASAOptions
    from rustsasa_jax.io.read import read_structure
    from rustsasa_jax.levels import Level
    from rustsasa_jax.trajectory import compute_trajectory_sasa, write_dcd

    base = read_structure(EXAMPLE).atoms.coords.astype(np.float32)
    rng = np.random.default_rng(0)
    frames = base[None] + rng.normal(
        0.0, 0.3, size=(200,) + base.shape).astype(np.float32)
    frames[0] = base
    dcd = os.path.join(tmp, "traj.dcd")
    write_dcd(dcd, frames)
    t0 = time.perf_counter()
    res = compute_trajectory_sasa(
        EXAMPLE, dcd, SASAOptions(level=Level.PROTEIN)
    )
    elapsed = time.perf_counter() - t0
    check(res.n_frames == 200 and np.isfinite(res.totals).all(),
          "trajectory totals")
    log(f"trajectory: 200 frames in {elapsed:.3f}s (first call in this "
        f"process); frame 0 total {res.totals[0]:.3f} vs cli "
        f"{cli_total:.3f}")
    check(abs(float(res.totals[0]) - cli_total) <= 1e-3 * cli_total,
          "trajectory frame 0 differs from the cli")


def four_cards(devices, tmp: str, card: str):
    import filecmp

    from rustsasa_jax.ops.engine import BatchedSasaEngine, SasaParams

    check(len(devices) == 4, f"--four-cards needs 4 GPUs, not {len(devices)}")
    corpus, n_files, n_atoms = build_corpus(tmp)
    log(f"ingest: {ingest_path()}")
    all_cards = BatchedSasaEngine(SasaParams())
    one_card = BatchedSasaEngine(SasaParams(), devices=devices[:1])
    log(f"warm_shapes on 4 cards {all_cards.warm_shapes():.1f}s")
    run_corpus(corpus, os.path.join(tmp, "warm4"), all_cards)
    run_corpus(corpus, os.path.join(tmp, "warm1"), one_card)
    t4 = run_corpus(corpus, os.path.join(tmp, "out4"), all_cards)
    t1 = run_corpus(corpus, os.path.join(tmp, "out1"), one_card)
    names = sorted(os.listdir(os.path.join(tmp, "out1")))
    check(names == sorted(os.listdir(os.path.join(tmp, "out4"))),
          "4-card and 1-card output names differ")
    _, mismatch, errors = filecmp.cmpfiles(
        os.path.join(tmp, "out1"), os.path.join(tmp, "out4"), names,
        shallow=False,
    )
    check(not mismatch and not errors, (mismatch[:5], errors[:5]))
    log(f"four cards: {n_files} files, {n_atoms} atoms; {len(names)} "
        f"outputs byte-identical to the one-card pass; 4 cards {t4:.3f}s, "
        f"1 card {t1:.3f}s on {card}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the proteome corpus on 4 cards vs 1")
    args = ap.parse_args(argv)

    t0 = phase("device")
    devices = check_device()
    sys.path.insert(0, REPO)
    from rustsasa_jax.utils.jax_cache import enable_persistent_cache

    enable_persistent_cache()
    card = devices[0].device_kind
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        if args.four_cards:
            phase("four cards")
            four_cards(devices, tmp, card)
        else:
            phase("compile")
            phase_compile()
            phase("kernel parity")
            triples = selections(pdb_files())
            phase_kernel(triples)
            phase("fused vs xla")
            phase_fused_vs_xla(triples)
            phase("cli")
            total = phase_cli(tmp)
            phase("proteome")
            phase_proteome(tmp, card)
            phase("quality")
            phase_quality()
            phase("trajectory")
            phase_trajectory(tmp, total)
    log(f"all phases passed in {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
