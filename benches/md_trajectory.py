#!/usr/bin/env python
"""MD-trajectory benchmark (reference: paper/paper.md:45, mdsasa-bolt).

The reference's companion package processes GPCRmd trajectory 10824
(4IAQ 5-HT1B receptor) in 22.7 s +- 1.4 (hyperfine, 3 runs, 8-core M3);
mdakit-sasa needs 448.4 s.  The trajectory itself is not downloadable here
(zero egress), so this bench synthesizes a GPCRmd-SHAPED workload: a
receptor-sized topology (~3k heavy atoms) and a physically plausible DCD
(per-frame thermal jitter around the crystal coordinates), then streams it
through compute_trajectory_sasa - static topology/radii resolved once,
frame blocks batched through the fused device kernel, vectorized per-frame
residue aggregation.

Reports seconds total, ms/frame, and Matoms/s.  Default 2500 frames (the
typical GPCRmd stride).
"""

import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rustsasa_jax.utils.jax_cache import enable_persistent_cache  # noqa: E402

enable_persistent_cache()

import json  # noqa: E402

import numpy as np  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOPOLOGY = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
    REPO, "tests", "data", "pdbs", "example.cif"
)
N_FRAMES = int(sys.argv[2]) if len(sys.argv) > 2 else 2500
REFERENCE_S = 22.7  # paper.md:45


def main() -> int:
    from rustsasa_jax.io.read import read_structure
    from rustsasa_jax.trajectory import (
        compute_trajectory_sasa,
        write_dcd,
    )

    structure = read_structure(TOPOLOGY)
    n_atoms = structure.n_atoms()
    base = structure.atoms.coords.astype(np.float32)

    # Synthesize frames: small correlated thermal jitter (~0.3 A RMS)
    # around the crystal coordinates - same compute shape as a real MD
    # trajectory (the kernel's work depends on geometry, and 0.3 A
    # perturbations keep protein-like packing).
    rng = np.random.default_rng(0)
    frames = base[None, :, :] + rng.normal(
        0.0, 0.3, size=(N_FRAMES, n_atoms, 3)
    ).astype(np.float32)

    tmp = tempfile.mkdtemp(prefix="rustsasa_md_bench_")
    dcd_path = os.path.join(tmp, "traj.dcd")
    write_dcd(dcd_path, frames)
    print(
        f"synthetic trajectory: {N_FRAMES} frames x {n_atoms} atoms "
        f"({os.path.getsize(dcd_path)/1e6:.0f} MB DCD)",
        file=sys.stderr, flush=True,
    )

    # Warmup (compile): a short prefix.
    t0 = time.time()
    compute_trajectory_sasa(TOPOLOGY, dcd_path)
    warm_first = time.time() - t0

    t0 = time.time()
    result = compute_trajectory_sasa(TOPOLOGY, dcd_path)
    elapsed = time.time() - t0
    assert result.n_frames == N_FRAMES
    assert result.residue_values is not None
    assert result.residue_values.shape[0] == N_FRAMES
    assert float(result.totals.min()) > 0.0

    sasa_atoms = result.residue_values.shape  # noqa: F841
    matoms = N_FRAMES * n_atoms / elapsed / 1e6
    print(
        f"first pass {warm_first:.1f}s; warm pass {elapsed:.2f}s "
        f"({elapsed/N_FRAMES*1e3:.2f} ms/frame, {matoms:.2f} Matoms/s)",
        file=sys.stderr, flush=True,
    )
    print(
        json.dumps(
            {
                "metric": "md_trajectory_residue_sasa_wall",
                "value": round(elapsed, 3),
                "unit": "s",
                "frames": N_FRAMES,
                "atoms_per_frame": n_atoms,
                "reference_s": REFERENCE_S,
                "vs_reference": round(REFERENCE_S / elapsed, 3),
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
