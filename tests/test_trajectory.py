"""DCD trajectory reader + streaming SASA tests."""

import numpy as np
import pytest

from rustsasa_jax import SASAOptions
from rustsasa_jax.levels import Level
from rustsasa_jax.trajectory import (
    compute_trajectory_sasa,
    iter_frame_blocks,
    read_dcd,
    write_dcd,
)

PDB_2RES = """ATOM      1  N   ALA A   1      20.154  16.967  25.000  1.00 10.00           N
ATOM      2  CA  ALA A   1      19.030  16.155  25.000  1.00 15.00           C
ATOM      3  N   GLY A   2      17.948  16.712  25.000  1.00 20.00           N
ATOM      4  CA  GLY A   2      16.500  17.000  25.000  1.00 25.00           C
END
"""


def test_dcd_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    coords = rng.uniform(-50, 50, size=(5, 37, 3)).astype(np.float32)
    path = tmp_path / "t.dcd"
    write_dcd(str(path), coords)
    header, back = read_dcd(str(path))
    assert header.n_frames == 5
    assert header.n_atoms == 37
    np.testing.assert_allclose(back, coords, atol=1e-5)


def test_dcd_roundtrip_with_cell(tmp_path):
    coords = np.zeros((3, 11, 3), dtype=np.float32)
    coords[:, :, 0] = np.arange(11)[None, :]
    path = tmp_path / "c.dcd"
    write_dcd(str(path), coords, has_unit_cell=True)
    header, back = read_dcd(str(path))
    assert header.has_unit_cell
    np.testing.assert_allclose(back, coords, atol=1e-5)


def test_iter_frame_blocks(tmp_path):
    coords = np.random.default_rng(1).normal(size=(10, 8, 3)).astype(np.float32)
    path = tmp_path / "b.dcd"
    write_dcd(str(path), coords)
    seen = []
    for _, start, block in iter_frame_blocks(str(path), block=4):
        seen.append((start, block.shape[0]))
    assert seen == [(0, 4), (4, 4), (8, 2)]


def test_trajectory_sasa_matches_static(tmp_path):
    top = tmp_path / "top.pdb"
    top.write_text(PDB_2RES)

    from rustsasa_jax.io.read import read_structure

    structure = read_structure(str(top))
    opts = SASAOptions(level=Level.RESIDUE)
    static = opts.process(structure)

    # Frame 0 = topology coords; frame 1 = shifted apart (more SASA).
    base = structure.atoms.coords.copy()
    shifted = base.copy()
    shifted[2:, 0] += 30.0
    coords = np.stack([base, shifted])
    dcd = tmp_path / "t.dcd"
    write_dcd(str(dcd), coords)

    result = compute_trajectory_sasa(str(top), str(dcd), opts, block=8)
    assert result.n_frames == 2
    static_total = sum(r.value for r in static.residues)
    assert result.totals[0] == pytest.approx(static_total, rel=1e-4)
    assert result.totals[1] > result.totals[0]
    assert result.residue_values.shape == (2, 2)
    assert result.residue_names == ["ALA", "GLY"]


def test_trajectory_atom_count_mismatch(tmp_path):
    top = tmp_path / "top.pdb"
    top.write_text(PDB_2RES)
    dcd = tmp_path / "t.dcd"
    write_dcd(str(dcd), np.zeros((1, 7, 3), dtype=np.float32))
    with pytest.raises(ValueError, match="atoms"):
        compute_trajectory_sasa(str(top), str(dcd))


def test_iter_frame_blocks_streams_without_slurping(tmp_path):
    """No single read may pull more than one block of frames (+ header
    prefix); total reads ~= file size, not a multiple of it."""
    import rustsasa_jax.trajectory.dcd as dcd_mod

    coords = np.random.default_rng(2).normal(size=(64, 100, 3)).astype(
        np.float32
    )
    path = tmp_path / "big.dcd"
    write_dcd(str(path), coords)
    file_size = path.stat().st_size

    reads = []
    real_open = open

    def counting_open(p, mode="r", *a, **k):
        f = real_open(p, mode, *a, **k)
        real_read = f.read

        def read(n=-1):
            data = real_read(n)
            reads.append(len(data))
            return data

        f.read = read
        return f

    dcd_mod.open = counting_open
    try:
        blocks = list(iter_frame_blocks(str(path), block=4))
    finally:
        del dcd_mod.open

    h = blocks[0][0]
    assert h.n_frames == 64
    assert sum(b.shape[0] for _, _, b in blocks) == 64
    np.testing.assert_allclose(
        np.concatenate([b for _, _, b in blocks]), coords, atol=1e-5
    )
    # Largest single read: one 4-frame block (or the 64KB header prefix).
    block_bytes = 4 * h.frame_size
    assert max(reads) <= max(block_bytes, 65536)
    assert max(reads) < file_size
    # Every byte is read exactly once (header prefix may overlap frames).
    assert sum(reads) <= file_size + 65536
