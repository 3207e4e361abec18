"""Checks that need the card: the compiled kernel, not the interpreter.

They skip on the CPU.  On a GPU host:
    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/
The plain references run on the host CPU device.
"""

import jax
import numpy as np
import pytest

from test_pallas import _kernel_inputs, random_cluster

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("n_points", [60, 100, 256])
def test_compiled_kernel_matches_counts_xla(gpu_device, n_points):
    from rustsasa_jax.ops.engine import _sphere_packed
    from rustsasa_jax.ops.fused_kernel import _counts_call, counts_xla

    planes, jlist = _kernel_inputs(300, seed=n_points, clear_bits=True)
    sphere = _sphere_packed(n_points)
    ker = np.asarray(_counts_call(planes, jlist, sphere, interpret=False))
    with jax.default_device(jax.devices("cpu")[0]):
        ref = np.asarray(counts_xla(planes, jlist, sphere))
    # FMA contraction may differ between the two compilers: a margin
    # within rounding of 0 can flip one point.
    diff = np.abs(ker - ref)
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 0.01


def test_fused_backend_matches_xla(gpu_device):
    from rustsasa_jax.ops.engine import BatchedSasaEngine, SasaParams

    structures = [
        (*random_cluster(n, seed=90 + i), None)
        for i, n in enumerate([90, 700, 2600])
    ]
    fused = BatchedSasaEngine(SasaParams(), backend="fused").compute(
        structures
    )
    with jax.default_device(jax.devices("cpu")[0]):
        xla = BatchedSasaEngine(SasaParams(), backend="xla").compute(
            structures
        )
    for a, b in zip(xla, fused):
        diff = np.abs(a - b)
        assert diff.max() <= 3.0
        assert (diff > 1e-2).mean() <= 0.05
