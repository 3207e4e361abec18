"""Device-mesh data parallelism for batched SASA.

The reference's only cross-worker parallelism is rayon threads over files
(reference: src/main.rs:375); the accelerator-native equivalent is data parallelism
over structures across a jax.sharding.Mesh:

  * a 1-D mesh over all local (or global) devices, axis "batch";
  * structure batches [B, N, ...] sharded on the batch axis;
  * per-shard compute is the same fixed-shape kernel as single-chip;
  * cross-chip collectives (psum over ICI) only for run metrics -
    per-structure results are embarrassingly parallel, exactly like the
    reference's per-file isolation, so no result-gather is needed on the
    hot path (results stay on their shard until the host reads them).

shard_map is used rather than implicit sharding propagation so the
collective structure is explicit and compiles identically from 1 chip to a
multi-host slice.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.engine import (
    _area_factor,
    _neighbor_phase,
    _occlusion_scan,
)


def make_mesh(n_devices: int | None = None, axis_name: str = "batch") -> Mesh:
    """Build a 1-D device mesh over the first n_devices devices."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), axis_names=(axis_name,))


def _shard_sasa_core(packed, group_id, sphere_packed,
                     *, probe, k, n_points, axis_name):
    """Per-shard batched SASA + psum'd metrics.

    Runs inside shard_map: packed is the local [B_local, N, 4] shard
    (x, y, z, radius; group_id -1 marks padding).
    Returns (sasa [B_local, N], global_total_area [1], global_max_count [1]).
    """
    b, n = group_id.shape
    v, limit, counts, max_counts = jax.vmap(
        functools.partial(_neighbor_phase, probe=probe, k=k)
    )(packed, group_id)
    k_eff = limit.shape[-1]
    sphere = sphere_packed[:, 0:3]
    point_valid = sphere_packed[:, 3] > 0.0
    occluded = _occlusion_scan(
        v.reshape(b * n, k_eff, 3), limit.reshape(b * n, k_eff), sphere
    )
    accessible = jnp.sum(
        point_valid[None, :] & ~occluded, axis=1, dtype=jnp.float32
    )
    area = _area_factor(
        packed[:, :, 3].reshape(b * n), group_id.reshape(b * n) >= 0,
        probe, n_points,
    )
    sasa = (area * accessible).reshape(b, n)
    # Cross-chip collectives over ICI: run metrics only.
    total = jax.lax.psum(jnp.sum(sasa), axis_name)
    max_count = jax.lax.pmax(jnp.max(max_counts), axis_name)
    return sasa, total[None], max_count[None]


def make_sharded_sasa(
    mesh: Mesh,
    *,
    k: int,
    n_points: int,
    probe: float = 1.4,
    axis_name: str = "batch",
):
    """Build a jitted, mesh-sharded batched SASA step.

    Returns fn(packed [B,N,4], group_id [B,N], sphere_packed [P,4]) ->
               (sasa [B,N], total_area [1], max_count [1])
    with B sharded across the mesh.  B must be divisible by mesh size.
    """
    spec_b = P(axis_name)
    repl = P()

    shard_fn = jax.shard_map(
        functools.partial(
            _shard_sasa_core, probe=probe, k=k, n_points=n_points,
            axis_name=axis_name,
        ),
        mesh=mesh,
        in_specs=(spec_b, spec_b, repl),
        out_specs=(spec_b, repl, repl),
    )
    return jax.jit(shard_fn)


def put_batch_sharded(mesh: Mesh, array, axis_name: str = "batch"):
    """Device-put one host array sharded along its leading (batch) axis."""
    spec = P(axis_name, *([None] * (array.ndim - 1)))
    return jax.device_put(array, NamedSharding(mesh, spec))
