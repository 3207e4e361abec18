"""Precompile the fused-kernel shape buckets into the persistent cache
and report warm throughput per bucket.

Two wire formats compile: the q13 path (discrete ProtOr-like radii ->
palette fits; the production default) and the q16 fallback (forced here
with a >163 A extent structure per chunk: real chunks fall back for big
extents or occupancy-column radii)."""
import os
import sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from rustsasa_jax.utils.jax_cache import enable_persistent_cache
enable_persistent_cache()
import time
import numpy as np
import rustsasa_jax.ops.engine as E

rng = np.random.default_rng(0)

# Discrete radii (ProtOr-like set): keeps the q13 palette tiny, like
# every real structure.
RSET = np.array([1.42, 1.55, 1.61, 1.64, 1.77, 1.88, 2.0], np.float32)


def protein_like(n, extent=None):
    side = extent if extent is not None else (n / 0.1) ** (1 / 3)
    c = rng.uniform(0, side, (n, 3)).astype(np.float32)
    r = rng.choice(RSET, n).astype(np.float32)
    return c, r, None


eng = E.BatchedSasaEngine(E.SasaParams(), backend="fused")
for m in E._FUSED_M_BUCKETS:
    # Fill the bucket with 2048-atom protein-density structures.
    count = max(1, m // 2048)
    structures = [protein_like(2000) for _ in range(count)]
    t0 = time.time()
    outs = eng.compute(structures)
    print(f"bucket {m}: compiled+ran in {time.time()-t0:.1f}s", flush=True)
    for _ in range(2):
        t0 = time.time()
        outs = eng.compute(structures)
        el = time.time() - t0
        atoms = count * 2000
        print(
            f"bucket {m}: warm {el*1000:.0f}ms for {atoms} atoms "
            f"-> {atoms/el/1e6:.2f} Matoms/s",
            flush=True,
        )

# Wider band buckets: chunks compile separate (M, w) variants keyed by
# the largest structure's tile count (W_BUCKETS ladder: 16/24/32/64/127
# tiles <-> <=2048/3072/4096/8192/16256 atoms).  The 2.6k/4k rows cover
# the w=24/32 bands typical proteome chunks use; 5000 -> w=64 single-file
# CLI shape; 12000/16000 -> w=127.
for m, big_n in [(4096, 2600), (4096, 4000), (8192, 2600), (32768, 2600), (131072, 2600),
                 (524288, 2600), (1048576, 2600), (2097152, 2600),
                 (8192, 4000), (32768, 4000), (131072, 4000),
                 (524288, 4000), (1048576, 4000), (2097152, 4000),
                 (8192, 5000), (32768, 12000),
                 (32768, 8000), (131072, 8000), (524288, 8000),
                 (2097152, 8000), (4194304, 8000),
                 (131072, 16000), (524288, 16000),
                 (2097152, 16000), (4194304, 16000)]:
    structures = [protein_like(big_n)]
    structures += [
        protein_like(2000)
        for _ in range(max(0, (m - 2 * big_n) // 2048))
    ]
    t0 = time.time()
    eng.compute(structures)
    print(
        f"bucket {m} w-band({big_n} atoms): compiled+ran in "
        f"{time.time()-t0:.1f}s",
        flush=True,
    )

# q16 fallback shapes: a >163 A extent structure in the chunk declines
# the q13 packer, so these rows compile the q16 wire at the buckets big
# or exotic chunks actually hit.
for m, big_n, w_n in [(2097152, 2600, 2600), (2097152, 4000, 4000),
                      (1048576, 4000, 4000), (524288, 4000, 4000),
                      (32768, 5000, 5000), (131072, 16000, 16000),
                      (2048, 2000, 2000), (8192, 2600, 2600)]:
    structures = [protein_like(w_n, extent=200.0)]
    structures += [
        protein_like(2000)
        for _ in range(max(0, (m - 2 * w_n) // 2048))
    ]
    t0 = time.time()
    eng.compute(structures)
    print(
        f"bucket {m} q16({w_n} atoms): compiled+ran in "
        f"{time.time()-t0:.1f}s",
        flush=True,
    )
