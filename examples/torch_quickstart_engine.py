"""StreamEngine quickstart over the PyTorch/CUDA port: stateful
multi-stream TEDA with ragged slots (the steps of `quickstart_engine.py`,
over `repro_torch`).

One engine, 8 tenant slots, chunks arriving at arbitrary lengths; slot 5
is recycled for a new tenant mid-flight.  Swap `backend=` between
"scan" / "cuda" / "cuda-q" — the streaming contract is identical.

    PYTHONPATH=src python examples/torch_quickstart_engine.py        # GPU
    PYTHONPATH=src python examples/torch_quickstart_engine.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.engine import StreamEngine
from repro_torch.engine.engine import resolve_device
from repro_torch.fixedpoint import QFormat

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="torch device (default: the GPU; 'cpu' runs the "
                     "kernels' plain PyTorch versions)")
dev = resolve_device(ap.parse_args().device)

rng = np.random.default_rng(0)
C = 8


def make_chunk(t):
    x = rng.normal(size=(t, C)).astype(np.float32)
    return x


eng = StreamEngine(capacity=C, backend="cuda", m=4.0, block_t=64,
                   device=dev)

# --- chunks of whatever length the gateway hands us -------------------
for t in (37, 128, 9):
    out = eng.process(make_chunk(t))
print(f"after 174 samples: per-slot k = {eng.samples_seen.tolist()}")

# --- slot 5: old tenant leaves, new tenant arrives mid-flight ---------
eng.reset([5])

# --- the new tenant misbehaves ----------------------------------------
chunk = make_chunk(60)
chunk[40:44, 5] += 25.0  # anomaly burst on slot 5 only
out = eng.process(chunk)
flags = np.asarray(out["outlier"].cpu())
print(f"slot 5 flagged at rows {np.flatnonzero(flags[:, 5]).tolist()}; "
      f"other slots flagged: {bool(flags[:, :5].any() or flags[:, 6:].any())}")
print(f"ragged per-slot k = {eng.samples_seen.tolist()}")

# --- same stream, bit-accurate FPGA datapath --------------------------
eng_q = StreamEngine(capacity=C, backend="cuda-q", m=4.0,
                     fmt=QFormat(32, 20), block_t=64, device=dev)
out_q = eng_q.process(chunk)
agree = (np.asarray(out_q["outlier"].cpu()) == flags).mean()
print(f"Q11.20 kernel verdict agreement on this chunk: {agree:.3f}")
print("OK")
