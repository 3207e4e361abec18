"""Test configuration.

Tests run on the JAX CPU backend with 8 virtual devices so sharding tests
exercise a real (virtual) mesh without accelerator hardware, and so the
suite is deterministic and runs anywhere.  Env vars must be set before jax
imports.

Tests marked `gpu` need the card.  They skip on the CPU; on a GPU host run
them with `JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/`, which
leaves the platform unpinned (the CPU device runs the plain references).
"""

import os
import pathlib

_GPU_RUN = "cuda" in os.environ.get("JAX_PLATFORMS", "")
if not _GPU_RUN:
    os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if not _GPU_RUN:
    # Re-pin to CPU before any backend is initialized, in case the
    # environment overrode jax_platforms after the env vars were read.
    jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
# Self-contained: the quality dataset (88 FreeSASA PDBs gzipped + stored
# FreeSASA JSONs + awkward-PDB fixtures) is vendored in tests/data, so the
# quality gate runs everywhere and can never green-light by skipping.
REFERENCE_DATA = REPO_ROOT / "tests" / "data"


@pytest.fixture(scope="session")
def reference_data_dir() -> pathlib.Path:
    assert REFERENCE_DATA.is_dir(), "vendored test data missing"
    return REFERENCE_DATA


@pytest.fixture(scope="session")
def example_cif(reference_data_dir) -> pathlib.Path:
    return reference_data_dir / "pdbs" / "example.cif"


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where there is none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; this run has {dev.platform!r} devices")
    return dev
