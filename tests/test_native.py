"""Native C++ parser tests: parity with the Python parsers, gzip, codes."""

import gzip
import os

import numpy as np
import pytest

from rustsasa_jax.io.read import read_structure
from rustsasa_jax.native import load_library


pytestmark = pytest.mark.skipif(
    load_library() is None, reason="native parser unavailable (no toolchain)"
)


def assert_tables_equal(a, b):
    assert len(a) == len(b)
    np.testing.assert_allclose(a.coords, b.coords, atol=1e-4)
    for field in ("name", "resname", "chain_id", "alt_loc", "icode",
                  "element", "serial", "res_serial", "hetero"):
        va, vb = getattr(a, field), getattr(b, field)
        assert (va == vb).all(), field
    np.testing.assert_allclose(a.occupancy, b.occupancy, atol=1e-4)
    np.testing.assert_allclose(a.bfactor, b.bfactor, atol=1e-4)


def test_native_pdb_parity(reference_data_dir):
    path = str(reference_data_dir / "pdbs" / "bad_seqadv_1A06.pdb")
    native = read_structure(path, native=True)
    python = read_structure(path, native=False)
    assert_tables_equal(native.atoms, python.atoms)


def test_native_cif_parity(example_cif):
    native = read_structure(str(example_cif), native=True)
    python = read_structure(str(example_cif), native=False)
    assert_tables_equal(native.atoms, python.atoms)


def test_native_gzip(tmp_path, reference_data_dir):
    src = reference_data_dir / "pdbs" / "151L_H3.pdb"
    gz_path = tmp_path / "s.pdb.gz"
    with open(src, "rb") as f:
        gz_path.write_bytes(gzip.compress(f.read()))
    native = read_structure(str(gz_path), native=True)
    plain = read_structure(str(src), native=False)
    assert_tables_equal(native.atoms, plain.atoms)


def test_native_interned_codes(example_cif):
    s = read_structure(str(example_cif), native=True)
    t = s.atoms
    assert t.chain_code is not None
    # Codes must be dense first-appearance and consistent with strings.
    for strings, codes in [
        (t.chain_id, t.chain_code),
        (t.resname, t.resname_code),
        (t.name, t.name_code),
    ]:
        assert codes.min() == 0
        # same code <=> same string
        order = np.argsort(codes, kind="stable")
        cs, ss = codes[order], strings[order]
        change = np.r_[True, cs[1:] != cs[:-1]]
        # within a code run, all strings equal the first
        firsts = np.repeat(ss[change], np.diff(np.r_[np.nonzero(change)[0], len(cs)]))
        assert (ss == firsts).all()


def test_native_error_on_missing_file():
    from rustsasa_jax.io.read import StructureReadError

    with pytest.raises(StructureReadError):
        read_structure("/nonexistent/file.pdb", native=True)


def test_lean_parse_coords_match_full():
    """fastparse_file_lean skips occupancy/b-factor parsing but must
    produce identical coordinates/topology; the occupancy-radii path
    (which needs the column) must keep using the FULL parser."""
    import pathlib

    import numpy as np

    from rustsasa_jax.native import load_library

    lib = load_library()
    if lib is None or not hasattr(lib, "fastparse_file_lean"):
        pytest.skip("native library unavailable")
    # Use PDB fixtures with real occupancy values (CIF always parses fully).
    pdb = pathlib.Path(__file__).parent / "data" / "freesasa_pdbs"
    cand = sorted(pdb.glob("*.pdb*"))
    assert cand, "no pdb fixtures"
    for p in cand[:3]:
        full = lib.fastparse_file(str(p).encode())
        lean = lib.fastparse_file_lean(str(p).encode())
        try:
            n = int(full.contents.n)
            assert int(lean.contents.n) == n
            cf = np.ctypeslib.as_array(full.contents.coords, shape=(n, 3))
            cl = np.ctypeslib.as_array(lean.contents.coords, shape=(n, 3))
            np.testing.assert_array_equal(cf, cl)
            sf = np.ctypeslib.as_array(full.contents.serial, shape=(n,))
            sl = np.ctypeslib.as_array(lean.contents.serial, shape=(n,))
            np.testing.assert_array_equal(sf, sl)
            ol = np.ctypeslib.as_array(lean.contents.occupancy, shape=(n,))
            assert (ol == 1.0).all()  # defaults, not parsed
        finally:
            lib.fastparse_free(full)
            lib.fastparse_free(lean)


def test_native_short_and_mixed_line_parity(tmp_path):
    """Short (<54-char) ATOM records take the non-fixed parse branch;
    mixed files must intern identically across both branches (regression
    for the round-4 restructuring that split name interning per branch
    and added raw-window intern caches on the fixed branch)."""
    pdb = (
        # fixed-width line (full 80 cols)
        "ATOM      1  N   ALA A   1      11.104   6.134  -6.504"
        "  1.00  0.00           N  \n"
        # short line: truncated after coords' start -> non-fixed branch
        "ATOM      2  CA  ALA A   1      11.639   6.071\n"
        # fixed again, same name as atom 2 (codes must match across
        # branches)
        "ATOM      3  CA  GLY A   2      12.260   4.711  -4.913"
        "  1.00  0.00           C  \n"
        # short line with a DIFFERENT residue name
        "ATOM      4  CB  VAL B   3       1.0     2.0\n"
        "END\n"
    )
    path = tmp_path / "mixed.pdb"
    path.write_text(pdb)
    native = read_structure(str(path), native=True)
    python = read_structure(str(path), native=False)
    assert_tables_equal(native.atoms, python.atoms)
    assert list(native.atoms.name) == ["N", "CA", "CA", "CB"]
    assert list(native.atoms.resname) == ["ALA", "ALA", "GLY", "VAL"]
