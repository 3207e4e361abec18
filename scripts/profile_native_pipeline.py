"""Stage split of the ACTUAL batch pipeline (native fastpipe + fused device path).

Measures, on a corpus slice, exactly what process_directory does:
  load    : native_process_file per file (thread pool, GIL-free C++)
  pack    : fused_kernel.pack_structures (Morton + tile culling, numpy)
  device  : engine.compute warm (pack + transfer + kernel + readback)
  emit    : NativeSelection.emit per file (thread pool, GIL-free C++)

Run AFTER bench.py built its corpus (bench.CORPUS_DIR), or pass a dir.
"""
import os
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from rustsasa_jax.utils.jax_cache import enable_persistent_cache  # noqa: E402

enable_persistent_cache()

from rustsasa_jax.native import native_process_file  # noqa: E402
from rustsasa_jax.ops import fused_kernel  # noqa: E402
from rustsasa_jax.ops.engine import BatchedSasaEngine, SasaParams  # noqa: E402

from bench import CORPUS_DIR  # noqa: E402

CORPUS = sys.argv[1] if len(sys.argv) > 1 else CORPUS_DIR
LIMIT = int(sys.argv[2]) if len(sys.argv) > 2 else 1024
OUT = os.path.join(tempfile.gettempdir(), "profile_native_out")

all_files = sorted(os.listdir(CORPUS))
step = max(1, len(all_files) // LIMIT)
files = [os.path.join(CORPUS, f) for f in all_files[::step][:LIMIT]]
os.makedirs(OUT, exist_ok=True)
workers = min(32, (os.cpu_count() or 4) * 2)
pool = ThreadPoolExecutor(max_workers=workers)


def load(path):
    return native_process_file(
        path, level="residue", include_hydrogens=False,
        include_hetatms=False, read_radii_from_occupancy=False,
        allow_vdw_fallback=False,
    )


t0 = time.time()
handles = list(pool.map(load, files))
t_load = time.time() - t0
n_atoms = sum(h.coords.shape[0] for h in handles)
print(
    f"load    {t_load:7.2f}s  ({len(files)} files, {n_atoms} atoms, "
    f"{workers} workers)",
    flush=True,
)

triples = [(h.coords, h.radii, h.gids) for h in handles]

t0 = time.time()
packed = fused_kernel.pack_structures(triples, 1.4, 100)
t_pack = time.time() - t0
jl = packed[1]
nt = packed[0].shape[1] // fused_kernel.ATOM_TILE
print(
    f"pack    {t_pack:7.2f}s  (M={packed[0].shape[1]}, "
    f"avg j-tiles {jl[:nt, 0].mean():.1f})",
    flush=True,
)

engine = BatchedSasaEngine(SasaParams())
t0 = time.time()
outs = engine.compute(triples)
print(f"device  {time.time()-t0:7.2f}s  (first, may compile)", flush=True)
t0 = time.time()
outs = engine.compute(triples)
t_dev = time.time() - t0
print(
    f"device2 {t_dev:7.2f}s  (warm, incl. pack; "
    f"{n_atoms/t_dev/1e6:.2f} Matoms/s)",
    flush=True,
)


def emit(args):
    i, h, sasa = args
    h.emit(sasa, "residue", "json", os.path.join(OUT, f"{i}.json"))


t0 = time.time()
list(pool.map(emit, [(i, h, o) for i, (h, o) in enumerate(zip(handles, outs))]))
t_emit = time.time() - t0
print(f"emit    {t_emit:7.2f}s", flush=True)

total = t_load + t_dev + t_emit
print(
    f"sum(load+device2+emit) = {total:.2f}s for {len(files)} files / "
    f"{n_atoms} atoms ({n_atoms/total/1e6:.2f} Matoms/s serial-sum)",
    flush=True,
)
