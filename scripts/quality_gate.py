#!/usr/bin/env python
"""Device-path quality gate.

Runs the 88-PDB FreeSASA gate (reference: tests/quality.rs:17-18,138-233,
RMSE baseline 43.99 + 20 tolerance) through the PRODUCTION pipeline on
whatever backend this host resolves - on a GPU host that is the fused
banded path, which the pytest gate (pinned to the CPU/XLA backend) never
exercises.  Prints the gate as JSON, and writes it to a file when one is
named, so a kernel regression can't hide behind the CPU gate.

Usage: python scripts/quality_gate.py [out.json]
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rustsasa_jax.utils.jax_cache import enable_persistent_cache  # noqa: E402

enable_persistent_cache()

RMSE_LIMIT = 43.99 + 20.0  # reference: tests/quality.rs:17-18


def _row(r: dict) -> dict:
    import math

    if not math.isfinite(r["rmse"]):
        r["rmse"] = 1e30  # JSON-safe sentinel; pass stays False below
    if not math.isfinite(r["pearson_r"]):
        r["pearson_r"] = 0.0  # degenerate correlation; keep JSON strict
    row = {
        "depth": r["depth"],
        "n": r["n"],
        "n_files": r["n_files"],
        "n_ok": r["n_ok"],
        "n_errors": len(r["errors"]),
        "rmse": round(r["rmse"], 4),
        "pearson_r": round(r["pearson_r"], 6),
        "pass": bool(r["rmse"] <= RMSE_LIMIT and r["n_ok"] == r["n_files"]),
    }
    if r["errors"]:
        row["errors"] = r["errors"][:10]
    return row


def run_gate() -> dict:
    """All four output depths + the occupancy-radii path through the
    production pipeline on this host's backend (reference runs its gate at
    all depths too, quality.rs:224-257, plus the -R test :260-442).  The
    depths differ in gid semantics (protein-level drops alt-loc), which is
    exactly where a device-path-only bug would hide."""
    import jax

    from quality_report import evaluate_depth, evaluate_occupancy

    rows = [
        _row(evaluate_depth(d))
        for d in ("residue", "atom", "chain", "protein")
    ]
    rows.append(_row(evaluate_occupancy()))
    residue = rows[0]
    dev = jax.devices()[0]
    out = {
        "gate": "freesasa_88pdb_rmse_all_depths",
        "device": str(dev),
        "platform": dev.platform,
        "rmse_limit": RMSE_LIMIT,
        # Top-level n/rmse/pearson_r mirror the residue row (the
        # historical single-depth schema); `pass` requires EVERY row.
        "n": residue["n"],
        "n_files": residue["n_files"],
        "n_ok": residue["n_ok"],
        "n_errors": residue["n_errors"],
        "rmse": residue["rmse"],
        "pearson_r": residue["pearson_r"],
        "rows": rows,
        "pass": all(row["pass"] for row in rows),
    }
    return out


def main() -> int:
    result = run_gate()
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as f:
            json.dump(result, f, indent=1)
            f.write("\n")
    print(json.dumps(result))
    return 0 if result["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
