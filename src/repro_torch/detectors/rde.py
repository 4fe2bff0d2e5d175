"""Recursive density estimation (RDE) — Angelov's close TEDA cousin.

  mu_k    = S_k / k,          S_k  = sum_{i<=k} x_i
  X_k     = S2_k / k,         S2_k = sum_{i<=k} x_i^2
  sigma_k = X_k - mu_k^2      (biased variance)
  D_k     = 1 / (1 + (x_k - mu_k)^2 / sigma_k)

Outlier when (x_k - mu_k)^2 > m^2 * sigma_k, gated on k >= 2 and
sigma_k > 0.  This module is the row-recursive oracle (sequential in
time, per-channel carried state) the fused kernel's RDE lane is held
to; the port of the JAX package's `detectors/rde.py`.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.detectors._common import stack_rows, valid_rows
from repro_torch.kernels.ops import _row

__all__ = ["RdeState", "rde_init", "rde_scan"]


class RdeState(NamedTuple):
    """Per-channel carried RDE moments, all float32 (C,): samples
    absorbed `k`, running sum `s`, running sum of squares `s2`."""

    k: torch.Tensor
    s: torch.Tensor
    s2: torch.Tensor


def rde_init(c: int, dtype=torch.float32, device=None) -> RdeState:
    def z():
        return torch.zeros(c, dtype=dtype, device=device)

    return RdeState(k=z(), s=z(), s2=z())


def rde_scan(x, m=3.0, state: Optional[RdeState] = None, *,
             valid_lens=None) -> Tuple[RdeState, dict]:
    """RDE over x (T, C) — C independent univariate streams.

    Returns (final RdeState, {"outlier": (T, C) bool, "score": (T, C)
    Cauchy density in (0, 1]}).  `m` is a scalar or per-channel (C,)
    sensitivity; `valid_lens` freezes each channel after its own
    leading prefix and masks its flags beyond it.  Chunked calls that
    carry the state reproduce the single-shot run bit for bit.
    """
    x = torch.as_tensor(x).to(torch.float32)
    t_len, c = x.shape
    dev = x.device
    if state is None:
        state = rde_init(c, device=dev)
    mv = _row(m, c, torch.float32, dev)
    m2 = mv * mv
    valid = valid_rows(valid_lens, t_len, c, dev)
    k, s, s2 = state
    flags, scores = [], []
    for t in range(t_len):
        xr, v = x[t], valid[t]
        k = torch.where(v, k + 1.0, k)
        s = torch.where(v, s + xr, s)
        s2 = torch.where(v, s2 + xr * xr, s2)
        kd = k.clamp_min(1.0)
        mean = s / kd
        varb = s2 / kd - mean * mean
        d2 = (xr - mean) * (xr - mean)
        ok = varb > 0.0
        ratio = torch.where(ok, d2 / torch.where(ok, varb, 1.0), 0.0)
        scores.append(1.0 / (1.0 + ratio))
        flags.append(v & (k >= 2.0) & ok & (d2 > m2 * varb))
    out = {"outlier": stack_rows(flags, t_len, c, torch.bool, dev),
           "score": stack_rows(scores, t_len, c, torch.float32, dev)}
    return RdeState(k=k, s=s, s2=s2), out
