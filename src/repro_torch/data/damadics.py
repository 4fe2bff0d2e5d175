"""Synthetic DAMADICS-like actuator streams (the paper's validation data).

The real DAMADICS server (diag.mchtr.pw.edu.pl) is offline; we synthesize
statistically similar 2-channel actuator telemetry (flow + valve-position
style signals: slow sinusoidal process trend + measurement noise) and
inject the paper's four artificial fault types (Table 1):

  f16 — positioner supply pressure drop   (level drop, ramp in/out)
  f17 — unexpected pressure change        (sustained offset)
  f18 — partly opened bypass valve        (step change on one channel)
  f19 — flow rate sensor fault            (stuck-at + noise burst)

`make_benchmark()` reproduces the Table-2 layout: a long stream with
fault windows at known sample indices, so Figures 6–7 (eccentricity vs
5/k threshold crossing inside the fault window) can be regenerated.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import numpy as np


class FaultWindow(NamedTuple):
    kind: str
    start: int
    stop: int


def base_signals(t_len: int, seed: int = 0) -> np.ndarray:
    """Nominal 2-channel actuator telemetry (T, 2)."""
    rng = np.random.default_rng(seed)
    t = np.arange(t_len)
    flow = (1.0 + 0.15 * np.sin(2 * np.pi * t / 9000.0)
            + 0.05 * np.sin(2 * np.pi * t / 613.0)
            + 0.02 * rng.normal(size=t_len))
    valve = (0.6 + 0.1 * np.sin(2 * np.pi * t / 9000.0 + 0.7)
             + 0.015 * rng.normal(size=t_len))
    return np.stack([flow, valve], axis=-1).astype(np.float32)


def inject(x: np.ndarray, w: FaultWindow, seed: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = x.copy()
    n = w.stop - w.start
    sl = slice(w.start, w.stop)
    if w.kind == "f16":  # supply pressure drop: ramped level drop
        ramp = np.minimum(np.arange(n) / max(n // 8, 1), 1.0)
        x[sl, 0] -= 0.55 * ramp  # ~4.5 sigma of the nominal signal
        x[sl, 1] -= 0.30 * ramp
    elif w.kind == "f17":  # pressure change across the valve
        x[sl, 0] += 0.4
        x[sl, 1] -= 0.15
    elif w.kind == "f18":  # partly opened bypass valve: step on flow
        x[sl, 0] += 0.5
    elif w.kind == "f19":  # sensor fault: stuck + noise burst
        x[sl, 0] = x[w.start, 0] + 0.2 * rng.normal(size=n)
    else:
        raise ValueError(w.kind)
    return x


# Table 2 analog: (kind, start, stop) in sample indices
TABLE2: List[FaultWindow] = [
    FaultWindow("f18", 58800, 59800),
    FaultWindow("f16", 57275, 57550),
    FaultWindow("f18", 58830, 58930),
    FaultWindow("f18", 58520, 58625),
    FaultWindow("f18", 54600, 54700),
    FaultWindow("f16", 56670, 56770),
    FaultWindow("f17", 37780, 38400),
]


def make_benchmark(item: int = 0, t_len: int = 60000, seed: int = 0
                   ) -> Tuple[np.ndarray, FaultWindow]:
    """Stream + its injected fault window (items index Table 2)."""
    w = TABLE2[item]
    x = base_signals(t_len, seed=seed + item)
    return inject(x, w, seed=seed + 100 + item), w


def detection_report(outlier: np.ndarray, w: FaultWindow,
                     guard_band: int = 50) -> Dict[str, float]:
    """Detection metrics for one run: latency, hit, false alarms."""
    flags = np.asarray(outlier, bool)
    inside = flags[w.start:w.stop]
    before = flags[:w.start - guard_band]
    hit = bool(inside.any())
    latency = int(np.argmax(inside)) if hit else -1
    return {
        "hit": float(hit),
        "latency_samples": float(latency),
        "false_alarm_rate": float(before.mean()),
        "in_window_rate": float(inside.mean()),
    }
