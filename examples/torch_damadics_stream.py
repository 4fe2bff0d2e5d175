"""Figures 6-7 analog over the PyTorch/CUDA port: DAMADICS fault
detection with eccentricity curves (the steps of `damadics_stream.py`,
over `repro_torch`).

Reproduces the paper's validation: TEDA (m = 3) over actuator telemetry
with injected faults; the normalized eccentricity crosses the 5/k
threshold inside the fault window. ASCII-plots the curves.

    PYTHONPATH=src python examples/torch_damadics_stream.py [--item 0]
    PYTHONPATH=src python examples/torch_damadics_stream.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.core import teda_scan
from repro_torch.data.damadics import detection_report, make_benchmark
from repro_torch.engine.engine import resolve_device


def ascii_plot(y, thr, flags, width=72, height=12, title=""):
    n = len(y)
    step = max(1, n // width)
    ys = y[::step][:width]
    ts = thr[::step][:width]
    fs = flags[::step][:width]
    top = max(float(np.max(ys)), float(np.max(ts))) * 1.05 + 1e-9
    rows = []
    for r in range(height, 0, -1):
        lo, hi = top * (r - 1) / height, top * r / height
        line = ""
        for i in range(len(ys)):
            if lo <= ys[i] < hi:
                line += "!" if fs[i] else "*"
            elif lo <= ts[i] < hi:
                line += "-"
            else:
                line += " "
        rows.append(line)
    print(title)
    print("\n".join(rows))
    print("*" + " eccentricity  " + "-" + " threshold 5/k  "
          + "!" + " outlier")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--item", type=int, default=0,
                    help="Table-2 fault item (0-6)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    x, w = make_benchmark(args.item)
    lo = max(0, w.start - 20000)
    hi = min(len(x), w.stop + 2000)
    seg = torch.as_tensor(x[lo:hi], device=dev)
    print(f"fault item {args.item + 1}: type {w.kind}, window "
          f"[{w.start}, {w.stop}) of {len(x)} samples; scoring "
          f"[{lo}, {hi})")

    _, out = teda_scan(seg, m=3.0)
    zeta = out.zeta.cpu().numpy()
    thr = out.threshold.cpu().numpy()
    flags = out.outlier.cpu().numpy()

    shifted = type(w)(w.kind, w.start - lo, w.stop - lo)
    rep = detection_report(flags, shifted)
    print(f"hit={bool(rep['hit'])} latency={int(rep['latency_samples'])} "
          f"samples, false alarm rate={rep['false_alarm_rate']:.5f}")

    view = slice(max(0, shifted.start - 2000), shifted.stop + 1000)
    ascii_plot(zeta[view], thr[view], flags[view],
               title=f"normalized eccentricity vs 5/k (m=3), fault "
                     f"{w.kind}")


if __name__ == "__main__":
    main()
