"""Split the proteome-bench wall time into pipeline stages.

Stages measured independently on the bench corpus (or a slice of it):
  parse      : read_structure over every file (threaded, like batch.py)
  select     : options.build_selection per structure
  pack       : fused_kernel.pack_structures (Morton + tile culling)
  device     : engine.compute on the pre-parsed triples (transfer + kernel)
  emit       : fast_selection_json + file writes

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

import numpy as np  # noqa: E402

from rustsasa_jax.api import SASAOptions  # noqa: E402
from rustsasa_jax.io.read import read_structure  # noqa: E402
from rustsasa_jax.io.serialize import fast_selection_json  # noqa: E402
from rustsasa_jax.levels import Level  # noqa: E402
from rustsasa_jax.ops import fused_kernel  # noqa: E402
from rustsasa_jax.ops.engine import BatchedSasaEngine, SasaParams  # noqa: E402

from bench import CORPUS_DIR  # noqa: E402

CORPUS = sys.argv[1] if len(sys.argv) > 1 else CORPUS_DIR
LIMIT = int(sys.argv[2]) if len(sys.argv) > 2 else 1024
OUT = os.path.join(tempfile.gettempdir(), "profile_out")

files = sorted(os.path.join(CORPUS, f) for f in os.listdir(CORPUS))[:LIMIT]
print(f"{len(files)} files", flush=True)
os.makedirs(OUT, exist_ok=True)

options = SASAOptions(level=Level.RESIDUE)
workers = min(32, (os.cpu_count() or 4) * 2)
pool = ThreadPoolExecutor(max_workers=workers)

t0 = time.time()
structures = list(pool.map(read_structure, files))
t_parse = time.time() - t0
n_atoms = sum(s.n_atoms() for s in structures)
print(f"parse   {t_parse:7.2f}s  ({n_atoms} atoms, {workers} workers)", flush=True)

t0 = time.time()
sels = list(pool.map(options.build_selection, structures))
t_select = time.time() - t0
print(f"select  {t_select:7.2f}s", flush=True)

triples = [(s.coords, s.radii, s.group_ids) for s in sels]

t0 = time.time()
packed = fused_kernel.pack_structures(triples, 1.4, 100)
t_pack = time.time() - t0
print(f"pack    {t_pack:7.2f}s  (M={packed[0].shape[1]})", flush=True)

engine = BatchedSasaEngine(SasaParams())
t0 = time.time()
outs = engine.compute(triples)
t_dev = time.time() - t0
print(f"device  {t_dev:7.2f}s  (compute incl. pack+transfer, warm?)", flush=True)

t0 = time.time()
outs2 = engine.compute(triples)
t_dev2 = time.time() - t0
print(f"device2 {t_dev2:7.2f}s  (second run, warm)", flush=True)


def emit(args):
    i, sel, sasa = args
    payload = fast_selection_json(sel, sasa, Level.RESIDUE)
    with open(os.path.join(OUT, f"{i}.json"), "w") as f:
        f.write(payload)


t0 = time.time()
list(pool.map(emit, [(i, s, o) for i, (s, o) in enumerate(zip(sels, outs))]))
t_emit = time.time() - t0
print(f"emit    {t_emit:7.2f}s", flush=True)

total = t_parse + t_select + t_dev2 + t_emit
print(
    f"sum(parse+select+device2+emit) = {total:.2f}s "
    f"for {len(files)} files / {n_atoms} atoms", flush=True,
)
