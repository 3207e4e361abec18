"""Write-back fidelity: output differs from the input only in B-factors.

The reference saves through pdbtbx after stamping SASA into the B-factor
column (src/utils/io.rs:20-64), preserving the file's record structure.
Our splice-based write-back (io/writeback.py) is byte-faithful: every
record except the B-factor field of coordinate lines round-trips
unchanged.  The from-scratch writers (the no-source fallback) must
preserve multi-character chain ids and >99999 serials via the two-char
chain column / hybrid-36 extensions.
"""

import gzip
import os

import numpy as np
import pytest

from rustsasa_jax import SASAOptions, read_structure
from rustsasa_jax.batch import serialize_result
from rustsasa_jax.io import hybrid36
from rustsasa_jax.io.pdb import parse_pdb, write_pdb
from rustsasa_jax.io.read import parse_structure
from rustsasa_jax.levels import Level


def test_hybrid36_encode_decode():
    assert hybrid36.encode(99999, 5) == "99999"
    assert hybrid36.encode(100000, 5) == "A0000"
    assert hybrid36.encode(100001, 5) == "A0001"
    assert hybrid36.encode(9999, 4) == "9999"
    assert hybrid36.encode(10000, 4) == "A000"
    for v in (0, 7, 99999, 100000, 1234567, 10**5 + 26 * 36**4,
              10**5 + 26 * 36**4 + 99):
        assert hybrid36.decode(hybrid36.encode(v, 5), 5) == v
    for v in (0, 9999, 10000, 123456, 10**4 + 26 * 36**3 + 5):
        assert hybrid36.decode(hybrid36.encode(v, 4), 4) == v
    with pytest.raises(ValueError):
        hybrid36.encode(10**5 + 52 * 36**4, 5)


def _bfactor_only_diff(original: str, spliced: str):
    """Assert the two PDB texts differ only in columns 61-66 of
    coordinate records."""
    olines = original.split("\n")
    slines = spliced.split("\n")
    assert len(olines) == len(slines)
    n_changed = 0
    for o, s in zip(olines, slines):
        if o == s:
            continue
        assert o[:6].startswith("ATOM") or o[:6] == "HETATM", (o, s)
        op = o.ljust(66)
        sp = s.ljust(66)
        assert op[:60] == sp[:60], (o, s)
        assert op[66:].rstrip() == sp[66:].rstrip(), (o, s)
        n_changed += 1
    return n_changed


def test_pdb_writeback_differs_only_in_bfactor(reference_data_dir, tmp_path):
    src = reference_data_dir / "freesasa_pdbs"
    gz = sorted(p for p in os.listdir(src) if p.endswith(".pdb.gz"))[0]
    original = gzip.open(src / gz, "rt").read()
    path = tmp_path / gz[:-3]
    path.write_text(original)

    structure = read_structure(str(path))
    result, sel = SASAOptions(level=Level.RESIDUE).process_with_selection(
        structure
    )
    out = serialize_result(structure, result, "pdb", selection=sel)
    changed = _bfactor_only_diff(original, out)
    # A handful of atoms may splice a value that formats identically to
    # the original (excluded atoms write 0.00 over an original 0.00).
    assert structure.n_atoms() * 0.99 <= changed <= structure.n_atoms()
    # And the new B-factors are the residue SASA write-back values, not
    # the originals: at least one changed line carries a residue total.
    reparsed = parse_pdb(out)
    assert float(np.max(reparsed.atoms.bfactor)) == pytest.approx(
        max(r.value for r in result.residues), abs=0.01
    )


def test_cif_writeback_differs_only_in_bfactor(example_cif):
    original = open(example_cif).read()
    structure = read_structure(str(example_cif))
    result, sel = SASAOptions(level=Level.ATOM).process_with_selection(
        structure
    )
    out = serialize_result(structure, result, "cif", selection=sel)
    olines = original.split("\n")
    slines = out.split("\n")
    assert len(olines) == len(slines)
    changed = [
        (o, s) for o, s in zip(olines, slines) if o != s
    ]
    assert len(changed) == structure.n_atoms()
    for o, s in changed:
        # Only the B_iso_or_equiv token may differ.
        ot, st = o.split(), s.split()
        assert len(ot) == len(st)
        diffs = [k for k in range(len(ot)) if ot[k] != st[k]]
        assert len(diffs) == 1, (o, s)
    # Reparse: bfactors now carry atom SASA for included atoms.
    reparsed = parse_structure(out, path="roundtrip.cif")
    got = reparsed.atoms.bfactor[sel.atom_indices]
    np.testing.assert_allclose(
        got, np.asarray(result.atoms, dtype=np.float32), atol=0.01
    )


MULTICHAIN_CIF = """data_test
loop_
_atom_site.group_PDB
_atom_site.id
_atom_site.type_symbol
_atom_site.label_atom_id
_atom_site.label_alt_id
_atom_site.label_comp_id
_atom_site.auth_asym_id
_atom_site.auth_seq_id
_atom_site.pdbx_PDB_ins_code
_atom_site.Cartn_x
_atom_site.Cartn_y
_atom_site.Cartn_z
_atom_site.occupancy
_atom_site.B_iso_or_equiv
_atom_site.pdbx_PDB_model_num
ATOM 1 N N . MET AB 1 ? 0.000 0.000 0.000 1.00 0.00 1
ATOM 2 C CA . MET AB 1 ? 1.500 0.000 0.000 1.00 0.00 1
ATOM 3 N N . GLY CD 1 ? 8.000 0.000 0.000 1.00 0.00 1
ATOM 4 C CA . GLY CD 1 ? 9.500 0.000 0.000 1.00 0.00 1
#
"""


def test_multichar_chain_pdb_roundtrip(tmp_path):
    st = parse_structure(MULTICHAIN_CIF, path="multi.cif")
    assert sorted({c.id for c in st.chains}) == ["AB", "CD"]
    text = write_pdb(st)
    # Fixed columns intact: resname at 18-20, chain at 21-22, resSeq 23-26.
    line = text.split("\n")[0]
    assert line[17:20] == "MET"
    assert line[20:22] == "AB"
    assert line[22:26] == "   1"
    back = parse_pdb(text)
    assert sorted({c.id for c in back.chains}) == ["AB", "CD"]
    # Native parser agrees (two-char chain read is mirrored in C++).
    from rustsasa_jax.native import parse_file_native

    p = tmp_path / "multi.pdb"
    p.write_text(text)
    parsed = parse_file_native(str(p))
    if parsed is not None:
        table, _ = parsed
        assert sorted(set(table.chain_id)) == ["AB", "CD"]


def test_hybrid36_serial_pdb_roundtrip():
    rows = []
    for k in range(4):
        serial = 99998 + k  # crosses the 99999 -> A0000 boundary
        rows.append(
            f"ATOM {serial} N N . MET A {10000 + k} ? {k * 8}.0 0.0 0.0 "
            f"1.00 0.00 1"
        )
    cif = MULTICHAIN_CIF.split("ATOM ")[0] + "\n".join(rows) + "\n#\n"
    st = parse_structure(cif, path="big.cif")
    text = write_pdb(st)
    lines = text.split("\n")
    assert lines[0][6:11] == "99998"
    assert lines[2][6:11] == "A0000"  # 100000
    assert lines[0][22:26] == "A000"  # resSeq 10000
    back = parse_pdb(text)
    assert list(back.atoms.serial) == [99998, 99999, 100000, 100001]
    assert list(back.atoms.res_serial) == [10000, 10001, 10002, 10003]


def test_hybrid36_serials_native_parser_parity(tmp_path):
    """The C++ parser must decode hybrid-36 serial/resSeq fields exactly
    like the Python parser (width-aware, PDB fields only)."""
    from rustsasa_jax.native import parse_file_native

    rows = []
    for k in range(4):
        serial = 99998 + k
        rows.append(
            f"ATOM {serial} N N . MET A {10000 + k} ? {k * 8}.0 0.0 0.0 "
            f"1.00 0.00 1"
        )
    cif = MULTICHAIN_CIF.split("ATOM ")[0] + "\n".join(rows) + "\n#\n"
    text = write_pdb(parse_structure(cif, path="big.cif"))
    p = tmp_path / "h36.pdb"
    p.write_text(text)
    parsed = parse_file_native(str(p))
    if parsed is None:
        pytest.skip("native library unavailable")
    table, _ = parsed
    assert list(table.serial) == [99998, 99999, 100000, 100001]
    assert list(table.res_serial) == [10000, 10001, 10002, 10003]
