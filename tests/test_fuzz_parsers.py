"""Deterministic parser robustness fuzzing.

The reference leans on pdbtbx's Loose mode to digest malformed files
(SURVEY §7 hard parts; units.rs:68-91 pins two real-world broken PDBs).
Our permissive parsers claim the same: any byte-level corruption must
produce either a parsed Structure or a typed error — never an unhandled
exception, and never memory-unsafety in the C++ parser.  Seeded RNG
keeps failures reproducible.
"""

import gzip
import os
import random

import numpy as np
import pytest

from conftest import REFERENCE_DATA

from rustsasa_jax.io.read import StructureReadError, parse_structure
from rustsasa_jax.native import parse_file_native, pipe_library


def _load(name: str) -> bytes:
    path = REFERENCE_DATA / "pdbs" / name
    data = path.read_bytes()
    return gzip.decompress(data) if name.endswith(".gz") else data


def _mutations(data: bytes, rng: random.Random, n: int):
    """Yield n corrupted variants: byte flips, truncations, line
    shuffles, chunk deletions, binary injections."""
    for _ in range(n):
        kind = rng.randrange(5)
        b = bytearray(data)
        if kind == 0:  # random byte flips
            for _ in range(rng.randrange(1, 64)):
                b[rng.randrange(len(b))] = rng.randrange(256)
        elif kind == 1:  # truncate mid-record
            b = b[: rng.randrange(1, len(b))]
        elif kind == 2:  # shuffle a window of lines
            lines = bytes(b).split(b"\n")
            i = rng.randrange(max(1, len(lines) - 20))
            window = lines[i:i + 20]
            rng.shuffle(window)
            lines[i:i + 20] = window
            b = bytearray(b"\n".join(lines))
        elif kind == 3:  # delete a chunk
            i = rng.randrange(len(b))
            j = min(len(b), i + rng.randrange(1, 4096))
            del b[i:j]
        else:  # inject binary garbage
            i = rng.randrange(len(b))
            b[i:i] = bytes(rng.randrange(256) for _ in range(64))
        yield bytes(b)


@pytest.mark.parametrize("fixture", ["151L_H3.pdb", "example.cif"])
def test_python_parsers_never_crash_on_corruption(fixture):
    data = _load(fixture)
    rng = random.Random(1234)
    parsed = errors = 0
    for variant in _mutations(data, rng, 120):
        try:
            st = parse_structure(variant, path=fixture)
            assert st.n_atoms() > 0
            # Core arrays must be internally consistent.
            assert st.atoms.coords.shape == (st.n_atoms(), 3)
            assert np.isfinite(st.atoms.occupancy).all()
            parsed += 1
        except StructureReadError:
            errors += 1
    # The suite is vacuous if every variant lands on one side.
    assert parsed > 0 and errors > 0, (parsed, errors)


@pytest.mark.parametrize("fixture", ["151L_H3.pdb", "example.cif"])
def test_native_parser_never_crashes_on_corruption(fixture, tmp_path):
    if pipe_library() is None:
        pytest.skip("native library unavailable")
    data = _load(fixture)
    rng = random.Random(99)
    parsed = errors = 0
    p = tmp_path / ("fuzz" + os.path.splitext(fixture)[1])
    for variant in _mutations(data, rng, 120):
        p.write_bytes(variant)
        try:
            out = parse_file_native(str(p))
        except ValueError:
            errors += 1
            continue
        assert out is not None
        table, _fmt = out
        n = len(table)
        assert table.coords.shape == (n, 3)
        parsed += 1
    assert parsed > 0, (parsed, errors)


def test_native_parser_survives_corrupt_gzip(tmp_path):
    """Corruption AFTER compression exercises the native zlib error path:
    must raise a parse error, never crash or return garbage."""
    if pipe_library() is None:
        pytest.skip("native library unavailable")
    data = _load("151L_H3.pdb")
    rng = random.Random(7)
    p = tmp_path / "fuzz.pdb.gz"
    outcomes = {"ok": 0, "err": 0}
    for _ in range(40):
        blob = bytearray(gzip.compress(data))
        for _ in range(rng.randrange(1, 16)):
            blob[rng.randrange(len(blob))] = rng.randrange(256)
        p.write_bytes(bytes(blob))
        try:
            out = parse_file_native(str(p))
        except ValueError:
            outcomes["err"] += 1
            continue
        table, _fmt = out
        assert table.coords.shape == (len(table), 3)
        outcomes["ok"] += 1
    assert outcomes["err"] > 0, outcomes
