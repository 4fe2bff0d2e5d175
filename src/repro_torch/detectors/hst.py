"""Streaming half-space-tree detector — the first non-moment member.

A fixed-depth half-space tree over a static input range is, for
univariate streams, a partition of [lo, hi) into `HST_LEAVES` equal
cells: a sample's leaf is `floor((x - lo) / cell)`, clamped to the
boundary cells.  Two per-leaf mass tables per channel — the reference
window's counts and the filling window's — plus a phase counter.  Each
sample:

  score  = ref[leaf(x)]                 (reference-window cell mass)
  flag   = filled & score * m < window  (low mass = anomalous; `filled`
           gates until the first reference window exists)
  cur[leaf(x)] += 1;  phase += 1
  when phase == window * HST_LEAVES:  ref <- cur; cur <- 0; phase <- 0

A NaN sample has no leaf: it scores 0, flags once the reference table
is filled, adds to no cell, and still advances the phase (the clamp
propagates NaN, as the JAX oracle's `jnp.clip` does).  Every carried
quantity is an exact small integer in float32, so this oracle, the
kernel's plain version and the CUDA kernel give identical bits.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.detectors._common import stack_rows, valid_rows
from repro_torch.detectors.spec import HST_LEAVES, HST_RANGE
from repro_torch.kernels.ops import _row

__all__ = ["HstState", "hst_init", "hst_scan", "hst_leaf"]


class HstState(NamedTuple):
    """Per-channel window-mass state: `ref` (L, C) masses of the last
    completed reference window, `cur` (L, C) of the filling window,
    `phase` (C,) samples absorbed into `cur` so far."""

    ref: torch.Tensor
    cur: torch.Tensor
    phase: torch.Tensor


def hst_init(c: int, dtype=torch.float32, device=None) -> HstState:
    return HstState(
        ref=torch.zeros((HST_LEAVES, c), dtype=dtype, device=device),
        cur=torch.zeros((HST_LEAVES, c), dtype=dtype, device=device),
        phase=torch.zeros(c, dtype=dtype, device=device))


def hst_leaf(x: torch.Tensor) -> torch.Tensor:
    """Leaf index of each sample (f32), clamped at the boundary cells;
    NaN stays NaN."""
    lo, hi = HST_RANGE
    scale = float(HST_LEAVES) / (hi - lo)
    return torch.clamp(torch.floor((x - lo) * scale), 0.0,
                       float(HST_LEAVES - 1))


def hst_scan(x, m=3.0, state: Optional[HstState] = None, *,
             window: int = 8, valid_lens=None) -> Tuple[HstState, dict]:
    """Streaming HS-tree over x (T, C) — C independent channel streams.

    Returns (final HstState, {"outlier": (T, C) bool, "score": (T, C)
    reference-window leaf mass, 0 past each channel's valid prefix}).
    `window` sizes the mass windows (window * HST_LEAVES samples each);
    `valid_lens` freezes each channel after its own leading prefix.
    """
    x = torch.as_tensor(x).to(torch.float32)
    t_len, c = x.shape
    dev = x.device
    if state is None:
        state = hst_init(c, device=dev)
    wn = float(int(window) * HST_LEAVES)
    mv = _row(m, c, torch.float32, dev)
    valid = valid_rows(valid_lens, t_len, c, dev)
    leaves = torch.arange(HST_LEAVES, dtype=torch.float32,
                          device=dev)[:, None]
    ref, cur, phase = state
    flags, scores = [], []
    for t in range(t_len):
        xr, v = x[t], valid[t]
        onehot = leaves == hst_leaf(xr)[None, :]
        score = torch.where(onehot, ref, 0.0).sum(0)
        filled = ref.sum(0) > 0.0
        flags.append(v & filled & (score * mv < float(window)))
        cur = cur + (onehot & v[None, :]).to(torch.float32)
        phase = phase + v.to(torch.float32)
        flip = phase == wn
        ref = torch.where(flip[None, :], cur, ref)
        cur = torch.where(flip[None, :], 0.0, cur)
        phase = torch.where(flip, 0.0, phase)
        scores.append(torch.where(v, score, 0.0))
    out = {"outlier": stack_rows(flags, t_len, c, torch.bool, dev),
           "score": stack_rows(scores, t_len, c, torch.float32, dev)}
    return HstState(ref=ref, cur=cur, phase=phase), out
