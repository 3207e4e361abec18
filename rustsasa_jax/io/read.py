"""Structure file reading: format dispatch + gzip support."""

from __future__ import annotations

import gzip
import os

from .cif import parse_cif
from .pdb import parse_pdb
from .structure import Structure


class StructureReadError(ValueError):
    """Failed to read/parse an input structure (reference: CLIError::InputFileRead)."""


def _sniff_format(path: str, content: bytes) -> str:
    base = path[:-3] if path.endswith(".gz") else path
    ext = os.path.splitext(base)[1].lower()
    if ext in (".cif", ".mmcif"):
        return "cif"
    if ext in (".pdb", ".ent", ".pdb1"):
        return "pdb"
    # Sniff: mmCIF starts with data_ / # blocks; PDB with record names.
    head = content[:4096].lstrip()
    if head.startswith(b"data_") or b"_atom_site." in content[:65536]:
        return "cif"
    return "pdb"


_USE_NATIVE = os.environ.get("RUSTSASA_NATIVE", "1") != "0"


def read_structure(path: str, *, native: bool | None = None) -> Structure:
    """Read a PDB or mmCIF file (optionally .gz) into a Structure.

    Uses the native C++ parser when available (RUSTSASA_NATIVE=0 to
    disable); transparently falls back to the Python parsers.
    """
    if native is None:
        native = _USE_NATIVE
    if native and os.path.isfile(path):
        from ..native import parse_file_native

        try:
            parsed = parse_file_native(path)
        except ValueError as e:
            raise StructureReadError(str(e)) from e
        if parsed is not None:
            table, fmt = parsed
            st = Structure(atoms=table, source_path=path, format=fmt)
            if st.n_atoms() == 0:
                raise StructureReadError(
                    f"Failed to parse {path}: no atom records found"
                )
            return st
    try:
        if path.endswith(".gz"):
            with gzip.open(path, "rb") as f:
                content = f.read()
        else:
            with open(path, "rb") as f:
                content = f.read()
    except OSError as e:
        raise StructureReadError(f"Failed to read from input file: {e}") from e
    return parse_structure(content, path)


def parse_structure(content: bytes | str, path: str = "") -> Structure:
    if isinstance(content, str):
        content = content.encode("utf-8", "replace")
    fmt = _sniff_format(path, content)
    try:
        if fmt == "cif":
            st = parse_cif(content, source_path=path)
        else:
            st = parse_pdb(content, source_path=path)
    except StructureReadError:
        raise
    except Exception as e:  # noqa: BLE001 - wrap into a typed error
        raise StructureReadError(f"Failed to parse {path or '<memory>'}: {e}") from e
    if st.n_atoms() == 0:
        # A file with zero coordinate records is not a structure; report a
        # per-file error like the reference (pdbtbx fails such files and the
        # CLI collects the error, main.rs:447-453) instead of emitting an
        # empty result.
        raise StructureReadError(
            f"Failed to parse {path or '<memory>'}: no atom records found"
        )
    return st
