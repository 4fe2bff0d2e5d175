"""Sliding-window z-score detector: local moments over the last W samples.

  n_k     = min(k, W)
  mu_k    = (S_k  - S_{k-W})  / n_k        (window sum)
  X_k     = (S2_k - S2_{k-W}) / n_k
  sig_k   = X_k - mu_k^2                   (biased window variance)
  flag when (x_k - mu_k)^2 > m^2 * sig_k,  gated on k >= 2, sig_k > 0
  score   = (x_k - mu_k)^2 / sig_k         (the squared z-score)

This oracle carries the ring buffer of the last W samples; the fused
kernel carries the equivalent W-deep prefix-sum tail instead.  The port
of the JAX package's `detectors/zscore.py`.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.detectors._common import stack_rows, valid_rows
from repro_torch.kernels.ops import _row

__all__ = ["ZscoreState", "zscore_init", "zscore_scan"]


class ZscoreState(NamedTuple):
    """Per-channel carried window state: `k` (C,) samples absorbed and
    `ring` (W, C), where slot j holds the sample whose 1-based index i
    has (i - 1) % W == j (unwritten slots are zero)."""

    k: torch.Tensor
    ring: torch.Tensor


def zscore_init(c: int, window: int, dtype=torch.float32,
                device=None) -> ZscoreState:
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    return ZscoreState(k=torch.zeros(c, dtype=dtype, device=device),
                       ring=torch.zeros((window, c), dtype=dtype,
                                        device=device))


def zscore_scan(x, m=3.0, state: Optional[ZscoreState] = None, *,
                window: int = 8,
                valid_lens=None) -> Tuple[ZscoreState, dict]:
    """Windowed z-score over x (T, C) — C independent channel streams.

    Returns (final ZscoreState, {"outlier": (T, C) bool, "score": (T, C)
    squared z-score}).  `window` shapes the ring (a given `state`'s ring
    width wins); `valid_lens` freezes each channel after its own
    leading prefix.  Chunk-exact: the carry is the exact last-W ring.
    """
    x = torch.as_tensor(x).to(torch.float32)
    t_len, c = x.shape
    dev = x.device
    if state is None:
        state = zscore_init(c, window, device=dev)
    w = state.ring.shape[0]
    mv = _row(m, c, torch.float32, dev)
    m2 = mv * mv
    valid = valid_rows(valid_lens, t_len, c, dev)
    slots = torch.arange(w, dtype=torch.float32, device=dev)[:, None]
    k, ring = state
    flags, scores = [], []
    for t in range(t_len):
        xr, v = x[t], valid[t]
        k = torch.where(v, k + 1.0, k)
        # overwrite the oldest slot: 1-based index k lands in slot
        # (k - 1) mod W (exact in f32 for k < 2^24)
        pos = torch.remainder(k - 1.0, float(w))
        hit = (slots == pos[None, :]) & v[None, :]
        ring = torch.where(hit, xr[None, :], ring)
        n = k.clamp_min(1.0).clamp_max(float(w))
        mu = ring.sum(0) / n
        sig = (ring * ring).sum(0) / n - mu * mu
        d2 = (xr - mu) * (xr - mu)
        ok = sig > 0.0
        scores.append(torch.where(ok, d2 / torch.where(ok, sig, 1.0), 0.0))
        flags.append(v & (k >= 2.0) & ok & (d2 > m2 * sig))
    out = {"outlier": stack_rows(flags, t_len, c, torch.bool, dev),
           "score": stack_rows(scores, t_len, c, torch.float32, dev)}
    return ZscoreState(k=k, ring=ring), out
