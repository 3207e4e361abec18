"""Occupancy-radii end-to-end quality gate.

Mirrors the reference's fifth quality test (reference:
tests/quality.rs:260-442): rewrite ProtOr radii (VdW fallback) into the
occupancy column of all 88 FreeSASA PDBs, run the full pipeline with
read_radii_from_occupancy=True, and assert the same chain-level RMSE gate
as the normal-radii run.  This exercises the -R path over real structures
at scale, not just a one-atom smoke test.

Marked slow like the other quality gates (~600k atoms on the CPU backend).
"""

import gzip
import os
import sys

import pytest

from rustsasa_jax import SASAOptions
from rustsasa_jax.batch import process_directory
from rustsasa_jax.levels import Level

from test_quality import MAX_RMSE, load_freesasa_chains, load_ours

sys.path.insert(
    0,
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 "scripts"),
)
from quality_report import rewrite_occupancy_with_radii  # noqa: E402


@pytest.mark.slow
def test_quality_read_radii_from_occupancy(reference_data_dir, tmp_path):
    import json
    import math

    pdb_dir = reference_data_dir / "freesasa_pdbs"
    ref_dir = reference_data_dir / "freesasa_reference"
    modified_dir = tmp_path / "occupancy_pdbs"
    out_dir = tmp_path / "occupancy_out"
    modified_dir.mkdir()

    n_written = 0
    for fname in sorted(os.listdir(pdb_dir)):
        path = pdb_dir / fname
        if fname.endswith(".gz"):
            with gzip.open(path, "rt") as f:
                text = f.read()
            fname = fname[:-3]
        else:
            with open(path) as f:
                text = f.read()
        (modified_dir / fname).write_text(rewrite_occupancy_with_radii(text))
        n_written += 1
    assert n_written >= 80, "vendored FreeSASA PDB set incomplete"

    report = process_directory(
        str(modified_dir),
        str(out_dir),
        SASAOptions(level=Level.RESIDUE, read_radii_from_occupancy=True),
        "json",
        progress=False,
    )
    assert report.n_ok > 0, report.errors

    ours, ref = [], []
    for fname in sorted(os.listdir(ref_dir)):
        if not fname.endswith(".json"):
            continue
        out_path = out_dir / fname
        if not out_path.exists():
            continue
        ref_chains = load_freesasa_chains(ref_dir / fname, False)
        our_chains = load_ours(out_path)
        for key, ref_val in ref_chains.items():
            if key in our_chains:
                ref.append(ref_val)
                ours.append(our_chains[key])
    assert len(ours) > 0
    rmse = math.sqrt(sum((a - b) ** 2 for a, b in zip(ours, ref)) / len(ours))
    print(
        f"[read_radii_from_occupancy] RMSE vs FreeSASA: {rmse:.2f} over "
        f"{len(ours)} chains ({report.n_ok}/{report.n_files} files)"
    )
    assert rmse <= MAX_RMSE, (
        f"[read_radii_from_occupancy] RMSE ({rmse:.2f}) exceeds threshold "
        f"({MAX_RMSE:.2f}); errors: {report.errors[:5]}"
    )
