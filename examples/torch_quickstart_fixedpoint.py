"""Quickstart over the PyTorch/CUDA port: float vs bit-accurate
fixed-point TEDA on DAMADICS (the steps of `quickstart_fixedpoint.py`,
over `repro_torch`).

The paper's FPGA runs TEDA in fixed-point; this demo shows the port's
Q-format emulation reproducing the float pipeline's verdicts — and
degrading gracefully as the word length shrinks, which is the trade-off
the hardware designer sweeps before synthesis.

    PYTHONPATH=src python examples/torch_quickstart_fixedpoint.py   # GPU
    PYTHONPATH=src python examples/torch_quickstart_fixedpoint.py \\
        --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.core.teda import teda_stream
from repro_torch.data.damadics import make_benchmark
from repro_torch.engine.engine import resolve_device
from repro_torch.fixedpoint import QFormat, teda_q_scan_chan, teda_q_stream
from repro_torch.kernels.ops import teda_q_scan_verdict

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="torch device (default: the GPU; 'cpu' runs the "
                     "kernels' plain PyTorch versions)")
dev = resolve_device(ap.parse_args().device)

# A DAMADICS-style window around the Table-2 item-7 fault (f17 offset)
x, w = make_benchmark(6, t_len=40000)
seg = torch.as_tensor(x[w.start - 1500:w.stop + 500], device=dev)

# 1) float32 reference verdicts (Algorithm 1, m = 3)
_, out_f = teda_stream(seg, m=3.0)
flags_f = out_f.outlier.cpu().numpy()
print(f"float32 TEDA: {int(flags_f.sum())} outlier samples")

# 2) bit-accurate Q11.20 (WL=32) — the synthesis-ready word length
fmt32 = QFormat(32, 20)
_, out_q = teda_q_stream(seg, fmt32, m=3.0)
flags_q = out_q.outlier.cpu().numpy()
agree = float((flags_q == flags_f).mean())
print(f"{fmt32.label()}: {int(flags_q.sum())} outliers, "
      f"verdict agreement {agree:.2%}")
assert agree >= 0.99  # the acceptance bar for the bit-accurate datapath

# 3) a skinny 16-bit datapath: cheaper LUTs, coarser eccentricity
fmt16 = QFormat(16, 10)
_, out_16 = teda_q_stream(seg, fmt16, m=3.0)
agree16 = float((out_16.outlier.cpu().numpy() == flags_f).mean())
print(f"{fmt16.label()}: verdict agreement {agree16:.2%} "
      f"(resolution {fmt16.resolution:.2e})")

# 4) the integer kernel (CUDA; its plain PyTorch version on the CPU) is
# bit-exact with the Q scan — the same per-row step function
rng = np.random.default_rng(0)
xc = rng.normal(size=(256, 4)).astype(np.float32)
xc[200:204, 1] += 8.0
xc = torch.as_tensor(xc, device=dev)
_, out_kern = teda_q_scan_verdict(xc, fmt32, m=3.0, block_t=64)
_, out_scan = teda_q_scan_chan(xc, fmt32, m=3.0)
assert torch.equal(out_kern["ecc"], out_scan["ecc"])
assert torch.equal(out_kern["outlier"], out_scan["outlier"])
print(f"{dev.type} integer kernel: bit-exact with the Q-format scan")
