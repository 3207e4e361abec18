"""Lower every fused entry point for CUDA at the production chunk size.

Lowering needs no card: it runs the Pallas Triton lowering (block shapes,
supported primitives, scalar loads) and XLA's GPU StableHLO export here on
the CPU.  What only the card reports (shared memory, registers, the PTX
compile) is checked by chip_smoke.py.
"""

import functools

import jax
import jax.numpy as jnp
import pytest

from rustsasa_jax.ops import fused_kernel as fk

M = 2_097_152  # one full production chunk (engine.CHUNK_SLOT_BUDGET)
T = M // fk.ATOM_TILE


def _s(shape, dtype):
    return jax.ShapeDtypeStruct(shape, dtype)


SPHERE = _s((104, 4), jnp.float32)  # n_points=100 padded to 8

ENTRIES = {
    "fused_sasa": (
        functools.partial(fk.fused_sasa, n_points=100),
        (_s((fk.N_XFER_PLANES, M), jnp.float32),
         _s((T, fk.JLIST_ROWS), jnp.uint32), SPHERE),
    ),
    "fused_sasa_q16": (
        functools.partial(fk.fused_sasa_q16, n_points=100),
        (_s((4, M), jnp.uint16), _s((T, 4), jnp.float32),
         _s((T, fk.JLIST_ROWS), jnp.uint32), SPHERE),
    ),
    "fused_sasa_q13_banded": (
        functools.partial(fk.fused_sasa_q13_banded, n_points=100, w=32),
        (_s((M,), jnp.uint32), _s((M,), jnp.uint16),
         _s((256,), jnp.float32), _s((T, 4), jnp.float32),
         _s((T, 2), jnp.int32), SPHERE),
    ),
    "fused_sasa_q16_banded": (
        functools.partial(fk.fused_sasa_q16_banded, n_points=100, w=32),
        (_s((4, M), jnp.uint16), _s((T, 4), jnp.float32),
         _s((T, 2), jnp.int32), SPHERE),
    ),
}


def _lower_cuda(fn, args):
    return jax.jit(fn).trace(*args).lower(lowering_platforms=("cuda",))


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_fused_entry_lowers_for_cuda(name):
    fn, args = ENTRIES[name]
    text = _lower_cuda(fn, args).as_text()
    # The counts stage is the named Triton kernel.
    assert "__gpu$xla.gpu.triton" in text
    assert "sasa_occlusion_counts" in text


@pytest.mark.parametrize("n_points", [60, 256])
def test_counts_kernel_lowers_for_cuda_any_point_count(n_points):
    from rustsasa_jax.ops.engine import _sphere_packed

    sphere = _sphere_packed(n_points)
    fn = functools.partial(fk._counts_call, interpret=False)
    args = (_s((fk.N_PLANES, M), jnp.float32),
            _s((T, fk.JLIST_ROWS), jnp.int32),
            _s(sphere.shape, jnp.float32))
    assert "sasa_occlusion_counts" in _lower_cuda(fn, args).as_text()


def test_counts_xla_lowers_for_cuda():
    args = (_s((fk.N_PLANES, M), jnp.float32),
            _s((T, fk.JLIST_ROWS), jnp.int32), SPHERE)
    text = _lower_cuda(fk.counts_xla, args).as_text()
    assert "triton" not in text
