"""Cross-tool quality regression: RMSE vs FreeSASA over 88 real PDBs.

Mirrors the reference quality gate (reference: tests/quality.rs): run the
full pipeline over tests/data/freesasa_pdbs/, compare chain (or file) totals
against the stored FreeSASA reference JSONs, assert
RMSE <= 43.99 + 20.0 (v0.9.0 baseline + tolerance, quality.rs:17-18).

Marked slow: ~600k atoms through the engine on the CPU backend.
"""

import json
import math
import os

import pytest

from rustsasa_jax import SASAOptions
from rustsasa_jax.batch import process_directory
from rustsasa_jax.levels import Level

RMSE_BASELINE = 43.99
TOLERANCE = 20.0
MAX_RMSE = RMSE_BASELINE + TOLERANCE


def load_freesasa_chains(path, use_file_total):
    with open(path) as f:
        data = json.load(f)
    totals = {}
    if use_file_total:
        total = 0.0
        for result in data["results"]:
            for structure in result["structure"]:
                for chain in structure["chains"]:
                    total += chain["area"]["total"]
        totals[os.path.splitext(os.path.basename(path))[0]] = total
    else:
        for result in data["results"]:
            for structure in result["structure"]:
                for chain in structure["chains"]:
                    totals[chain["label"]] = chain["area"]["total"]
    return totals


def load_ours(path):
    with open(path) as f:
        data = json.load(f)
    totals = {}
    stem = os.path.splitext(os.path.basename(path))[0]
    if "Atom" in data:
        totals[stem] = float(sum(data["Atom"]))
    elif "Residue" in data:
        for r in data["Residue"]:
            totals[r["chain_id"]] = totals.get(r["chain_id"], 0.0) + r["value"]
    elif "Chain" in data:
        for c in data["Chain"]:
            totals[c["name"]] = c["value"]
    elif "Protein" in data:
        totals[stem] = data["Protein"]["global_total"]
    return totals


def compute_rmse(depth, reference_data_dir, tmp_path):
    pdb_dir = reference_data_dir / "freesasa_pdbs"
    ref_dir = reference_data_dir / "freesasa_reference"
    out_dir = tmp_path / f"quality_{depth}"
    use_file_total = depth in ("atom", "protein")

    report = process_directory(
        str(pdb_dir),
        str(out_dir),
        SASAOptions(level=Level(depth)),
        "json",
        progress=False,
    )
    assert report.n_ok > 0, report.errors

    ours, ref = [], []
    matched_files = 0
    for fname in sorted(os.listdir(ref_dir)):
        if not fname.endswith(".json"):
            continue
        out_path = out_dir / fname
        if not out_path.exists():
            continue
        matched_files += 1
        ref_chains = load_freesasa_chains(ref_dir / fname, use_file_total)
        our_chains = load_ours(out_path)
        for key, ref_val in ref_chains.items():
            if key in our_chains:
                ref.append(ref_val)
                ours.append(our_chains[key])
    assert matched_files > 0
    assert len(ours) > 0
    rmse = math.sqrt(
        sum((a - b) ** 2 for a, b in zip(ours, ref)) / len(ours)
    )
    return rmse, report, len(ours)


@pytest.mark.slow
@pytest.mark.parametrize("depth", ["residue", "chain", "atom", "protein"])
def test_quality_vs_freesasa(depth, reference_data_dir, tmp_path):
    rmse, report, n = compute_rmse(depth, reference_data_dir, tmp_path)
    print(
        f"[{depth}] RMSE vs FreeSASA: {rmse:.2f} over {n} comparisons "
        f"({report.n_ok}/{report.n_files} files, {len(report.errors)} errors)"
    )
    assert rmse <= MAX_RMSE, (
        f"[{depth}] RMSE ({rmse:.2f}) exceeds threshold ({MAX_RMSE:.2f}); "
        f"errors: {report.errors[:5]}"
    )
