"""ProtOr radii table and radius-resolution tests.

Spot checks mirror the reference (reference: tests/units.rs:211-277).
"""

import numpy as np
import pytest

from rustsasa_jax import (
    RadiusMissingError,
    VanDerWaalsMissingError,
    get_protor_radius,
    get_radius,
    get_vdw_radius,
    parse_radii_config,
)
from rustsasa_jax.data.protor import PROTOR_RADII
from rustsasa_jax.radii import resolve_radii


def test_protor_spot_checks():
    assert get_protor_radius("ASN", "CA") == pytest.approx(1.88)
    assert get_protor_radius("ASN", "N") == pytest.approx(1.64)
    assert get_protor_radius("ASN", "CB") == pytest.approx(1.88)
    assert get_protor_radius("CYS", "SG") == pytest.approx(1.77)
    assert get_protor_radius("XXX", "YY") is None
    assert get_protor_radius("ALA", "CA") == pytest.approx(1.88)
    assert get_protor_radius("GLY", "CA") == pytest.approx(1.88)
    assert get_protor_radius("TYR", "OH") == pytest.approx(1.46)


def test_protor_table_size():
    # 40 residue classes, 506 atom rows (reference: radii/protor.config).
    assert len(PROTOR_RADII) == 40
    assert sum(len(v) for v in PROTOR_RADII.values()) == 506


def test_vdw_values_match_reference_goldens():
    # Values arithmetically recovered from the reference golden array.
    assert get_vdw_radius("C") == pytest.approx(1.77)
    assert get_vdw_radius("N") == pytest.approx(1.66)
    assert get_vdw_radius("O") == pytest.approx(1.50)
    assert get_vdw_radius("S") == pytest.approx(1.89)
    assert get_vdw_radius("unknownium") is None


def test_custom_config_overrides_protor():
    cfg = parse_radii_config(
        """
# custom
types:
CX 2.5 apolar
atoms:
ALA CA CX
"""
    )
    assert get_radius("ALA", "CA", cfg) == pytest.approx(2.5)
    # Non-overridden entries fall through to ProtOr.
    assert get_radius("ALA", "CB", cfg) == pytest.approx(1.88)


def test_parse_skips_unknown_types_and_garbage():
    cfg = parse_radii_config(
        """
name: junk
types:
T1 1.5 polar
BAD notafloat
atoms:
RES A1 T1
RES A2 MISSINGTYPE
shortrow
"""
    )
    assert cfg == {"RES": {"A1": 1.5}}


def test_resolve_radii_precedence():
    resnames = np.array(["ALA", "ALA"], dtype=object)
    atoms = np.array(["CA", "CB"], dtype=object)
    elements = np.array(["C", "C"], dtype=object)
    occ = np.array([9.0, 8.0], dtype=np.float32)

    out = resolve_radii(resnames, atoms, elements, occ)
    np.testing.assert_allclose(out, [1.88, 1.88])

    out = resolve_radii(
        resnames, atoms, elements, occ, read_radii_from_occupancy=True
    )
    np.testing.assert_allclose(out, [9.0, 8.0])


def test_resolve_radii_errors_and_fallback():
    resnames = np.array(["XXX"], dtype=object)
    atoms = np.array(["QQ"], dtype=object)
    occ = np.zeros(1, np.float32)

    with pytest.raises(RadiusMissingError):
        resolve_radii(resnames, atoms, np.array(["C"], object), occ)

    out = resolve_radii(
        resnames, atoms, np.array(["C"], object), occ, allow_vdw_fallback=True
    )
    np.testing.assert_allclose(out, [1.77])

    with pytest.raises(VanDerWaalsMissingError):
        resolve_radii(
            resnames, atoms, np.array(["XX"], object), occ,
            allow_vdw_fallback=True,
        )
