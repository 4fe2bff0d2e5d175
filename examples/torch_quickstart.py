"""Quickstart over the PyTorch/CUDA port: TEDA streaming anomaly
detection in 30 lines (the steps of `quickstart.py`, over `repro_torch`).

    PYTHONPATH=src python examples/torch_quickstart.py               # GPU
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.core import clouds_run, teda_scan, teda_stream
from repro_torch.engine.engine import resolve_device
from repro_torch.kernels.ops import teda_scan_verdict

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="torch device (default: the GPU; 'cpu' runs the "
                     "kernels' plain PyTorch versions)")
dev = resolve_device(ap.parse_args().device)

# a 2-channel stream with an anomaly burst at t in [600, 620)
rng = np.random.default_rng(0)
x = rng.normal(size=(1000, 2)).astype(np.float32)
x[600:620] += 6.0
xt = torch.as_tensor(x, device=dev)

# 1) paper-faithful sequential TEDA (Algorithm 1, m = 3)
state, out = teda_stream(xt, m=3.0)
flags = out.outlier.cpu().numpy()
hits = np.flatnonzero(flags)
print(f"sequential TEDA: {len(hits)} outliers, first at k={hits[0] + 1}")

# 2) parallel (associative-scan) form — same verdicts, log-depth
_, out_par = teda_scan(xt, m=3.0)
assert (out_par.outlier.cpu().numpy() == flags).all()
print("associative-scan form: identical verdicts")

# 3) the TEDA kernel (CUDA; its plain PyTorch version on the CPU), 128
# channels at once.  Smooth telemetry + small noise (pure white noise
# would trip Chebyshev's loose bound ~0.3%/sample on every channel — the
# paper's streams are smooth industrial signals).
base = rng.uniform(-1, 1, size=(1, 128))
xc = (base + 0.05 * rng.normal(size=(1000, 128))).astype(np.float32)
xc[500:510, 7] += 2.0
final, outs = teda_scan_verdict(torch.as_tensor(xc, device=dev), m=5.0)
ch_hits = np.flatnonzero(outs["outlier"].cpu().numpy().any(axis=0))
print(f"{dev.type} kernel: anomalous channels = {ch_hits.tolist()}")
assert ch_hits.tolist() == [7]

# 4) streaming restart: state carries across calls
st1, _ = teda_stream(xt[:500])
st2, out2 = teda_stream(xt[500:], state=st1)
assert bool(out2.outlier[100:120].any())  # the burst is still caught
print("stateful restart: burst detected across call boundary")

# 5) TEDA data clouds (TEDAClass-style evolving classifier): three
# sequential operating regimes -> three clouds, no parameters but m
regimes = np.concatenate([
    rng.normal(size=(40, 2)) * 0.1 + [0, 0],
    rng.normal(size=(40, 2)) * 0.1 + [4, 4],
    rng.normal(size=(40, 2)) * 0.1 + [-4, 4]]).astype(np.float32)
cstate, members = clouds_run(torch.as_tensor(regimes, device=dev),
                             capacity=8, m=3.0)
print(f"data clouds discovered: {int(cstate.n_active)} (expected 3)")
