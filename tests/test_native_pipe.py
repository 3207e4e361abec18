"""Native (C++) parse+select+emit pipeline parity vs the Python path.

The Python implementations (levels.build_selection, io.serialize fast
paths) are the executable specification; the native pipeline must agree
on every reference structure and every output level.
"""

import json
import os

import numpy as np
import pytest

from rustsasa_jax.api import SASAOptions
from rustsasa_jax.io.read import read_structure
from rustsasa_jax.io.serialize import fast_selection_json, fast_selection_xml
from rustsasa_jax.levels import Level
from rustsasa_jax.native import (
    NativeFallback,
    native_process_file,
    pipe_library,
)

from conftest import REFERENCE_DATA

pytestmark = pytest.mark.skipif(
    pipe_library() is None, reason="native library unavailable"
)

FREESASA_DIR = REFERENCE_DATA / "freesasa_pdbs"
PDB_DIR = REFERENCE_DATA / "pdbs"


def _sample_files(limit=12):
    files = [str(PDB_DIR / "example.cif")]
    if FREESASA_DIR.is_dir():
        entries = sorted(os.listdir(FREESASA_DIR))[:limit]
        files += [str(FREESASA_DIR / f) for f in entries]
    for extra in ("bad_seqadv_1A06.pdb", "151L_H3.pdb"):
        p = PDB_DIR / extra
        if p.is_file():
            files.append(str(p))
    return files


@pytest.mark.parametrize("path", _sample_files())
def test_native_select_matches_python(path):
    options = SASAOptions(level=Level.RESIDUE)
    sel = options.build_selection(read_structure(path))
    ns = native_process_file(
        path, level="residue", include_hydrogens=False,
        include_hetatms=False, read_radii_from_occupancy=False,
        allow_vdw_fallback=False,
    )
    try:
        np.testing.assert_array_equal(ns.coords, sel.coords)
        np.testing.assert_array_equal(ns.radii, sel.radii)
        # gids: equality structure must match (values are arbitrary dense)
        _, py_inv = np.unique(sel.group_ids, return_inverse=True)
        _, nat_inv = np.unique(ns.gids, return_inverse=True)
        assert len(np.unique(sel.group_ids)) == len(np.unique(ns.gids))
        same_py = py_inv[:, None] == py_inv[None, :] if len(py_inv) < 800 \
            else None
        if same_py is not None:
            same_nat = nat_inv[:, None] == nat_inv[None, :]
            assert (same_py == same_nat).all()
    finally:
        ns.close()


@pytest.mark.parametrize("level", list(Level))
@pytest.mark.parametrize("fmt", ["json", "xml"])
def test_native_emit_matches_python(tmp_path, level, fmt):
    path = str(PDB_DIR / "example.cif")
    options = SASAOptions(level=level)
    sel = options.build_selection(read_structure(path))
    rng = np.random.default_rng(42)
    sasa = rng.uniform(0.0, 50.0, sel.coords.shape[0]).astype(np.float32)

    expected = (
        fast_selection_json(sel, sasa, level)
        if fmt == "json"
        else fast_selection_xml(sel, sasa, level)
    )

    ns = native_process_file(
        path, level=level.value, include_hydrogens=False,
        include_hetatms=False, read_radii_from_occupancy=False,
        allow_vdw_fallback=False,
    )
    try:
        out = tmp_path / f"out.{fmt}"
        ns.emit(sasa, level.value, fmt, str(out))
        assert out.read_text() == expected
    finally:
        ns.close()


def test_native_emit_multichain(tmp_path):
    # A multi-chain PDB exercises chain grouping + serialize_chain_id.
    files = [f for f in os.listdir(FREESASA_DIR)] if FREESASA_DIR.is_dir() else []
    assert files
    path = None
    for f in sorted(files):
        s = read_structure(str(FREESASA_DIR / f))
        sel = SASAOptions(level=Level.CHAIN).build_selection(s)
        if len(sel.chain_ids) > 1:
            path = str(FREESASA_DIR / f)
            break
    assert path is not None, "no multi-chain structure in sample"
    sel = SASAOptions(level=Level.CHAIN).build_selection(read_structure(path))
    sasa = np.linspace(0, 10, sel.coords.shape[0]).astype(np.float32)
    expected = fast_selection_json(sel, sasa, Level.CHAIN)
    ns = native_process_file(
        path, level="chain", include_hydrogens=False, include_hetatms=False,
        read_radii_from_occupancy=False, allow_vdw_fallback=False,
    )
    try:
        out = tmp_path / "out.json"
        ns.emit(sasa, "chain", "json", str(out))
        assert out.read_text() == expected
    finally:
        ns.close()


def test_native_occupancy_and_hydrogens():
    path = str(PDB_DIR / "example.cif")
    for kwargs in (
        dict(include_hydrogens=True, include_hetatms=True,
             read_radii_from_occupancy=False, allow_vdw_fallback=True),
        dict(include_hydrogens=False, include_hetatms=False,
             read_radii_from_occupancy=True, allow_vdw_fallback=False),
    ):
        options = SASAOptions(level=Level.RESIDUE, **kwargs)
        sel = options.build_selection(read_structure(path))
        ns = native_process_file(path, level="residue", **kwargs)
        try:
            np.testing.assert_array_equal(ns.coords, sel.coords)
            np.testing.assert_array_equal(ns.radii, sel.radii)
        finally:
            ns.close()


def test_native_radius_missing_error():
    from rustsasa_jax.radii import RadiusMissingError

    path = str(PDB_DIR / "example.cif")
    # HETATMs included without vdW fallback -> unknown (res, atom) pairs.
    s = read_structure(path)
    has_het = bool(s.atoms.hetero.any())
    if not has_het:
        pytest.skip("no HETATM in example.cif")
    with pytest.raises(RadiusMissingError):
        native_process_file(
            path, level="residue", include_hydrogens=False,
            include_hetatms=True, read_radii_from_occupancy=False,
            allow_vdw_fallback=False,
        )


def test_native_missing_file_error():
    from rustsasa_jax.io.read import StructureReadError

    with pytest.raises((StructureReadError, NativeFallback)):
        native_process_file(
            "/nonexistent/file.pdb", level="residue",
            include_hydrogens=False, include_hetatms=False,
            read_radii_from_occupancy=False, allow_vdw_fallback=False,
        )


def _pack_parity_case(structures):
    import numpy as np

    from rustsasa_jax.native import fastpack
    from rustsasa_jax.ops.fused_kernel import _pack_structures_numpy

    a = fastpack(structures, 1.4)
    if a is None:
        pytest.skip("native library unavailable")
    b = _pack_structures_numpy(structures, 1.4, 100)
    np.testing.assert_array_equal(a[0], b[0])  # planes
    np.testing.assert_array_equal(a[1], b[1])  # jlist
    assert a[3] == b[3]  # failed indices
    for oa, ob in zip(a[2], b[2]):
        assert (oa is None) == (ob is None)
        if oa is not None:
            assert oa[0] == ob[0] and oa[1] == ob[1]
            np.testing.assert_array_equal(oa[2], ob[2])


def test_fastpack_matches_numpy_mixed_sizes():
    import numpy as np

    rng = np.random.default_rng(0)
    structures = []
    for n in (3, 100, 128, 700, 2622):
        coords = (rng.uniform(0, 40, (n, 3)) + 100).astype(np.float32)
        radii = rng.uniform(1.4, 1.9, n).astype(np.float32)
        structures.append((coords, radii, np.arange(n, dtype=np.int32)))
    _pack_parity_case(structures)


def test_fastpack_matches_numpy_on_overflow():
    import numpy as np

    rng = np.random.default_rng(1)
    # >127 mutually-in-reach tiles: every tile pair culls active, so the
    # j-list overflows and BOTH packers must reroute this structure.
    n = 130 * 128
    coords = rng.uniform(0, 10, (n, 3)).astype(np.float32)
    radii = np.full(n, 1.8, np.float32)
    big = (coords, radii, np.arange(n, dtype=np.int32))
    small = (
        (rng.uniform(0, 30, (64, 3)) + 50).astype(np.float32),
        np.full(64, 1.6, np.float32),
        np.arange(64, dtype=np.int32),
    )
    _pack_parity_case([small, big, small])


def test_fused_counts_native_emit_parity(reference_data_dir, tmp_path, monkeypatch):
    """The fully-fused sink (device counts -> C++ emit_counts) must write
    byte-identical output to the Python unpack + emit route.  Runs the
    production fused path in interpret mode so it works on the CPU suite."""
    import rustsasa_jax.batch as batch_mod
    from rustsasa_jax.api import SASAOptions
    from rustsasa_jax.levels import Level
    from rustsasa_jax.native import pipe_library

    if pipe_library() is None:
        pytest.skip("native library unavailable")
    monkeypatch.setenv("RUSTSASA_BACKEND", "fused_interpret")

    src = tmp_path / "in"
    src.mkdir()
    import gzip
    import shutil as _sh

    pdbs = sorted(
        (reference_data_dir / "freesasa_pdbs").glob("*.pdb*")
    )[:2]
    for p in pdbs:
        if p.name.endswith(".gz"):
            with gzip.open(p, "rb") as f:
                (src / p.name[:-3]).write_bytes(f.read())
        else:
            _sh.copy(p, src / p.name)

    fused_out = tmp_path / "fused"
    report = batch_mod.process_directory(
        str(src), str(fused_out), SASAOptions(level=Level.RESIDUE),
        "json", progress=False,
    )
    assert report.n_ok == len(pdbs) and not report.errors
    assert report.total_area > 0

    # Reference route: XLA backend + Python serialization.
    monkeypatch.setenv("RUSTSASA_BACKEND", "xla")
    xla_out = tmp_path / "xla"
    report2 = batch_mod.process_directory(
        str(src), str(xla_out), SASAOptions(level=Level.RESIDUE),
        "json", progress=False,
    )
    assert report2.n_ok == len(pdbs)
    for f in sorted(fused_out.iterdir()):
        a = json.loads(f.read_text())
        b = json.loads((xla_out / f.name).read_text())
        ra = {(r["chain_id"], r["serial_number"]): r["value"] for r in a["Residue"]}
        rb = {(r["chain_id"], r["serial_number"]): r["value"] for r in b["Residue"]}
        assert ra.keys() == rb.keys()
        for k in ra:
            assert abs(ra[k] - rb[k]) < 26.0  # golden eps scale


def test_fused_counts_native_sink_bytes_match_python_unpack(
    reference_data_dir, tmp_path, monkeypatch
):
    """emit_counts (C++ fused unpack+emit) must produce BYTE-identical
    files to the Python route (CountsView materialization + handle.emit)
    on the SAME fused backend - this pins the bit-identical contract the
    cross-backend test above cannot (it allows numeric tolerance)."""
    import rustsasa_jax.batch as batch_mod
    from rustsasa_jax.api import SASAOptions
    from rustsasa_jax.levels import Level
    from rustsasa_jax.native import pipe_library

    if pipe_library() is None:
        pytest.skip("native library unavailable")
    monkeypatch.setenv("RUSTSASA_BACKEND", "fused_interpret")

    import gzip
    import shutil as _sh

    src = tmp_path / "in"
    src.mkdir()
    for p in sorted((reference_data_dir / "freesasa_pdbs").glob("*.pdb*"))[:2]:
        if p.name.endswith(".gz"):
            with gzip.open(p, "rb") as f:
                (src / p.name[:-3]).write_bytes(f.read())
        else:
            _sh.copy(p, src / p.name)

    native_out = tmp_path / "native_sink"
    r1 = batch_mod.process_directory(
        str(src), str(native_out), SASAOptions(level=Level.RESIDUE),
        "json", progress=False,
    )
    assert r1.n_ok == 2 and not r1.errors

    # Force the Python unpack route: make the isinstance check in _emit
    # never match, so CountsView thunks materialize and handle.emit runs.
    monkeypatch.setattr(batch_mod, "CountsView", type("_Never", (), {}))
    py_out = tmp_path / "python_unpack"
    r2 = batch_mod.process_directory(
        str(src), str(py_out), SASAOptions(level=Level.RESIDUE),
        "json", progress=False,
    )
    assert r2.n_ok == 2 and not r2.errors
    for f in sorted(native_out.iterdir()):
        assert f.read_bytes() == (py_out / f.name).read_bytes()
    # total_area is a report metric, not output: the C++ sink sums f64
    # sequentially while the Python route sums f32 pairwise (numpy), so
    # only relative agreement is contractual.
    assert abs(r1.total_area - r2.total_area) <= 1e-6 * max(
        1.0, abs(r1.total_area)
    )


def test_emit_counts_rejects_mismatched_views(tmp_path):
    """A wrong CountsView/NativeSelection pairing (or truncated readback)
    must surface as a typed error from the native sink, never a silent
    out-of-bounds read (ADVICE r4: fastpipe_emit_counts bounds)."""
    ns = native_process_file(
        str(PDB_DIR / "example.cif"), level="residue",
        include_hydrogens=False, include_hetatms=False,
        read_radii_from_occupancy=False, allow_vdw_fallback=False,
    )
    try:
        m = ns.coords.shape[0]
        out = str(tmp_path / "out.json")
        # inv shorter than the selection: length mismatch.
        with pytest.raises(OSError, match="inv length"):
            ns.emit_counts(
                np.zeros(m, dtype=np.uint8),
                np.zeros(m - 1, dtype=np.int32),
                1.0, 1.4, "residue", "json", out,
            )
        # slot index beyond the counts slice: out of range.
        with pytest.raises(OSError, match="out of range"):
            ns.emit_counts(
                np.zeros(4, dtype=np.uint8),
                np.full(m, 1000, dtype=np.int32),
                1.0, 1.4, "residue", "json", out,
            )
    finally:
        ns.close()


def test_native_pipeline_custom_radii_matches_python(tmp_path, monkeypatch):
    """A -r custom radii config must ride the native pipeline (VERDICT r4
    item 8) and produce byte-identical output to the Python route, with
    the custom values actually applied (custom-first, ProtOr-fallback
    precedence, reference: utils.rs:40-56)."""
    import gzip
    import shutil as _sh

    import rustsasa_jax.batch as batch_mod
    from rustsasa_jax.radii import parse_radii_config

    src = tmp_path / "in"
    src.mkdir()
    for p in sorted(FREESASA_DIR.glob("*.pdb*"))[:2]:
        if p.name.endswith(".gz"):
            with gzip.open(p, "rb") as f:
                (src / p.name[:-3]).write_bytes(f.read())
        else:
            _sh.copy(p, src / p.name)

    cfg = parse_radii_config(
        "types:\nBIG 2.75\natoms:\nALA CA BIG\nGLY CA BIG\n"
    )
    opts = SASAOptions(level=Level.RESIDUE).with_radii_config(cfg)

    native_out = tmp_path / "native"
    r1 = batch_mod.process_directory(
        str(src), str(native_out), opts, "json", progress=False
    )
    assert r1.n_ok == 2 and not r1.errors

    # Force the Python spine for the same run.
    monkeypatch.setattr(batch_mod, "pipe_library", lambda: None)
    py_out = tmp_path / "python"
    r2 = batch_mod.process_directory(
        str(src), str(py_out), opts, "json", progress=False
    )
    assert r2.n_ok == 2 and not r2.errors
    for f in sorted(native_out.iterdir()):
        assert f.read_bytes() == (py_out / f.name).read_bytes()

    # The custom radii must actually change the result vs the default
    # table (2.75 A CA radii are far off ProtOr's 1.88).
    default_out = tmp_path / "default"
    r3 = batch_mod.process_directory(
        str(src), str(default_out),
        SASAOptions(level=Level.RESIDUE), "json", progress=False,
    )
    assert r3.n_ok == 2
    diff = any(
        f.read_bytes() != (default_out / f.name).read_bytes()
        for f in sorted(native_out.iterdir())
    )
    assert diff, "custom radii config had no effect"


def test_fastpack_q13_matches_numpy():
    from rustsasa_jax.native import fastpack_q13
    from rustsasa_jax.ops.fused_kernel import _pack_structures_q13_numpy

    rng = np.random.default_rng(2)
    rset = np.array([1.55, 1.61, 1.64, 1.42, 1.77, 1.2], np.float32)
    structures = []
    for n in (3, 100, 128, 700, 2622):
        coords = (rng.uniform(0, 60, (n, 3)) + 100).astype(np.float32)
        radii = rng.choice(rset, n).astype(np.float32)
        structures.append((coords, radii, np.arange(n, dtype=np.int32)))
    a = fastpack_q13(structures, 1.4)
    if a is None:
        pytest.skip("native library unavailable")
    assert a != "ineligible"
    b = _pack_structures_q13_numpy(structures, 1.4)
    assert b is not None
    np.testing.assert_array_equal(a[0], b[0])  # wire_a
    np.testing.assert_array_equal(a[1], b[1])  # wire_b
    np.testing.assert_array_equal(a[2], b[2])  # palette (exact f32)
    np.testing.assert_array_equal(a[3], b[3])  # tparams
    np.testing.assert_array_equal(a[4], b[4])  # tmeta
    for oa, ob in zip(a[5], b[5]):
        assert oa[0] == ob[0] and oa[1] == ob[1]
        np.testing.assert_array_equal(oa[2], ob[2])


def test_fastpack_q13_ineligible_cases():
    from rustsasa_jax.native import fastpack_q13
    from rustsasa_jax.ops.fused_kernel import _pack_structures_q13_numpy

    rng = np.random.default_rng(3)
    # Extent beyond MAX_Q13_EXTENT: both implementations must decline.
    coords = rng.uniform(0, 250, (256, 3)).astype(np.float32)
    radii = np.full(256, 1.6, np.float32)
    s = [(coords, radii, np.arange(256, dtype=np.int32))]
    a = fastpack_q13(s, 1.4)
    if a is None:
        pytest.skip("native library unavailable")
    assert a == "ineligible"
    assert _pack_structures_q13_numpy(s, 1.4) is None
    # >255 distinct radii (occupancy-style): decline.
    radii2 = (1.2 + np.arange(300, dtype=np.float32) * 0.01)
    coords2 = rng.uniform(0, 50, (300, 3)).astype(np.float32)
    s2 = [(coords2, radii2, np.arange(300, dtype=np.int32))]
    assert fastpack_q13(s2, 1.4) == "ineligible"
    assert _pack_structures_q13_numpy(s2, 1.4) is None


def test_q13_roundtrip_accuracy():
    """Dequantized q13 planes must match the raw coordinates within the
    quantization step and radii EXACTLY (palette carries exact f32)."""
    from rustsasa_jax.ops.fused_kernel import (
        MAX_Q13_EXTENT,
        _pack_structures_q13_numpy,
    )

    rng = np.random.default_rng(4)
    n = 500
    coords = (rng.uniform(0, 70, (n, 3)) - 35).astype(np.float32)
    rset = np.array([1.55, 1.61, 1.88, 1.42], np.float32)
    radii = rng.choice(rset, n).astype(np.float32)
    out = _pack_structures_q13_numpy(
        [(coords, radii, np.arange(n, dtype=np.int32))], 1.4
    )
    assert out is not None
    wire_a, wire_b, palette, tparams, tmeta, offsets = out
    pos, nn, inv = offsets[0]
    qx = (wire_a & 0x1FFF).astype(np.float32)
    qy = ((wire_a >> 13) & 0x1FFF).astype(np.float32)
    qz = (((wire_a >> 26) & 0x3F) << 7 | (wire_b & 0x7F)).astype(np.float32)
    ridx = (wire_b >> 7) & 0xFF
    par = np.repeat(tparams, 128, axis=0)
    x = qx * par[:, 3] + par[:, 0]
    y = qy * par[:, 3] + par[:, 1]
    z = qz * par[:, 3] + par[:, 2]
    dq = np.stack([x, y, z], axis=1)[pos:pos + nn][inv]
    center = np.round(coords.mean(axis=0, dtype=np.float64) * 256.0) / 256.0
    step = 70.0 / 8191.0
    assert np.abs(dq - (coords - center.astype(np.float32))).max() <= step
    assert step <= MAX_Q13_EXTENT / 8191.0
    r_eff = palette[ridx[pos:pos + nn][inv]]
    np.testing.assert_array_equal(
        r_eff, radii + np.float32(1.4)
    )
