"""Float64 numpy oracle for the TEDA scan kernel.

Independent of `core/teda.py` (sequential steps) and `core/scan.py`
(parallel scan): prefix statistics from cumulative sums and a plain
sequential variance loop, in float64.  Shapes: x (T, C) — C independent
univariate streams.
"""
from __future__ import annotations

import numpy as np

__all__ = ["teda_ref"]


def teda_ref(x, m: float = 3.0, k0: int = 0, sum0=None, var0=None):
    """Reference TEDA over x (T, C) with optional carried state.

    Returns dict(mean, var, ecc, zeta, threshold, outlier) each (T, C),
    computed with numpy in float64.
    """
    x = np.asarray(x, np.float64)
    T, C = x.shape
    sum0 = np.zeros(C) if sum0 is None else np.asarray(sum0, np.float64)
    var0 = np.zeros(C) if var0 is None else np.asarray(var0, np.float64)

    k = (k0 + np.arange(1, T + 1, dtype=np.float64))[:, None]  # (T, 1)
    s = sum0[None] + np.cumsum(x, axis=0)
    mean = s / k
    d2 = (x - mean) ** 2
    first = k <= 1.0
    d2 = np.where(first, 0.0, d2)

    # var_k = (k-1)/k var_{k-1} + d2_k / k  — sequential reference loop.
    var = np.zeros((T, C))
    prev = var0
    for i in range(T):
        kk = k[i, 0]
        prev = np.where(first[i], 0.0, (kk - 1.0) / kk * prev + d2[i] / kk)
        var[i] = prev

    safe = var > 0.0
    ecc = 1.0 / k + np.where(safe, d2 / (k * np.where(safe, var, 1.0)), 0.0)
    zeta = ecc / 2.0
    thr = (m * m + 1.0) / (2.0 * k) * np.ones((1, C))
    outlier = (zeta > thr) & (k >= 2.0)
    return {
        "mean": mean, "var": var, "ecc": ecc, "zeta": zeta,
        "threshold": thr * np.ones_like(ecc), "outlier": outlier,
    }
