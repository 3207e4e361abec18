#!/usr/bin/env python
"""Component microbenchmarks (reference: benches/sasa_benchmarks.rs).

Times the same units as the reference's criterion suite - radius lookup,
atom building (selection), and the full residue-level pipeline on
example.cif - plus this framework's parser and engine phases.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

EXAMPLE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "tests", "data", "pdbs", "example.cif",
)


def timeit(name, fn, reps=10, warmup=2):
    for _ in range(warmup):
        fn()
    best = min(
        (lambda t0=time.perf_counter(): (fn(), time.perf_counter() - t0)[1])()
        for _ in range(reps)
    )
    print(f"{name:32s} {best * 1e3:10.3f} ms")


def main() -> int:
    from rustsasa_jax import SASAOptions, get_radius, read_structure
    from rustsasa_jax.levels import Level, build_selection
    from rustsasa_jax.ops.engine import calculate_sasa_internal

    if not os.path.exists(EXAMPLE):
        print("example.cif not available", file=sys.stderr)
        return 1

    timeit("get_radius (ALA CA)", lambda: get_radius("ALA", "CA"))

    structure = read_structure(EXAMPLE)
    timeit("parse example.cif (native)", lambda: read_structure(EXAMPLE))
    timeit(
        "parse example.cif (python)",
        lambda: read_structure(EXAMPLE, native=False),
    )
    timeit(
        "build_atoms_and_mapping",
        lambda: build_selection(structure, Level.RESIDUE),
    )

    sel = build_selection(structure, Level.RESIDUE)
    timeit(
        "calculate_sasa (device)",
        lambda: calculate_sasa_internal(
            sel.coords, sel.radii, group_ids=sel.group_ids
        ),
        reps=5,
    )
    opts = SASAOptions(level=Level.RESIDUE)
    timeit(
        "full_sasa_residue_level",
        lambda: opts.process(structure),
        reps=5,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
