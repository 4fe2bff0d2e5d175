"""Parallel (scan) formulation of TEDA — the "scan" backend.

eqs (2)-(3) look sequential but are not:

  * eq (2) is a prefix sum:  mu_k = S_k / k,  S_k = sum_{i<=k} x_i.
  * eq (3) is a first-order linear recurrence
        var_k = a_k * var_{k-1} + b_k,
        a_k = (k-1)/k,   b_k = ||x_k - mu_k||^2 / k,
    whose maps compose associatively under
    (a1,b1) o (a2,b2) = (a1*a2, b1*a2 + b2).

So a stream is a cumulative sum, one log-depth affine scan and
elementwise work.  torch has no associative scan, so the affine scan is
a Hillis-Steele doubling scan over the time axis.  No kernel here: the
reference runs this backend outside Pallas too.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.teda import (TedaOutput, TedaState, teda_init,
                                   teda_threshold)

__all__ = ["teda_scan", "affine_scan", "linear_recurrence_scan",
           "WelfordState", "welford_of_block", "welford_combine"]


def _shift_down(v: torch.Tensor, d: int, fill: float) -> torch.Tensor:
    """Rows r >= d of axis 0 get v[r-d]; rows < d get `fill`."""
    pad = torch.full((d,) + tuple(v.shape[1:]), fill, dtype=v.dtype,
                     device=v.device)
    return torch.cat([pad, v[: v.shape[0] - d]], dim=0)


def affine_scan(a: torch.Tensor, b: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive prefix compositions of the maps y -> a_k * y + b_k over
    axis 0, by doubling: O(T log T) work, O(log T) depth.  Returns
    (A, B), where row k's composed map is y -> A_k * y + B_k."""
    d = 1
    while d < a.shape[0]:
        a_sh = _shift_down(a, d, 1.0)
        b_sh = _shift_down(b, d, 0.0)
        # the newer map (a, b) applied after the older shifted one
        a, b = a * a_sh, a * b_sh + b
        d *= 2
    return a, b


def linear_recurrence_scan(a: torch.Tensor, b: torch.Tensor
                           ) -> torch.Tensor:
    """All-prefix solutions of y_k = a_k * y_{k-1} + b_k with y_0 = 0,
    over axis 0."""
    return affine_scan(a, b)[1]


def teda_scan(x: torch.Tensor, m=3.0,
              state: Optional[TedaState] = None,
              valid_lens=None) -> Tuple[TedaState, TedaOutput]:
    """Parallel TEDA over x (T, ..., N): the results of `teda_stream` up
    to float32 reassociation.

    `valid_lens` (scalar or a tensor matching the batch shape of
    `state.k`) restricts each stream to its leading vlen rows: the
    counter plateaus there, invalid rows add nothing to the sum and
    compose as identity variance maps, so the final state equals a run
    of each stream's own prefix.  `None` keeps the uniform computation.
    """
    T = x.shape[0]
    if state is None:
        state = teda_init(tuple(x.shape[1:-1]), x.shape[-1], torch.float32,
                          x.device)
    x = x.to(state.mean.dtype)

    k0 = state.k  # (...,)
    t = torch.arange(1, T + 1, dtype=x.dtype, device=x.device)
    rows = t.reshape((T,) + (1,) * k0.ndim)
    if valid_lens is None:
        valid = None
        k = k0[None, ...] + rows  # (T, ...)
        kd = k  # always >= 1
    else:
        # clamp to [0, T] — the kernel wrappers' contract
        vlen = torch.as_tensor(valid_lens, device=x.device).to(x.dtype)
        vlen = vlen.clamp(0.0, T)
        valid = rows <= vlen[None]  # this row advances this stream
        k = k0[None, ...] + torch.minimum(rows, vlen[None])
        kd = k.clamp_min(1.0)  # k=0 (vlen=0 fresh stream) div guard

    # ---- eq (2): prefix sum
    s0 = state.mean * k0[..., None]  # carried running sum
    xs = x if valid is None else torch.where(valid[..., None], x,
                                             torch.zeros_like(x))
    s = s0[None] + torch.cumsum(xs, dim=0)  # (T, ..., N)
    mean = s / kd[..., None]

    # ---- eq (3): affine recurrence
    d2 = ((x - mean) ** 2).sum(-1)  # (T, ...)
    a = (k - 1.0) / kd
    b = d2 / kd
    if valid is not None:
        # invalid rows are identity maps: the recurrence freezes there
        a = torch.where(valid, a, torch.ones_like(a))
        b = torch.where(valid, b, torch.zeros_like(b))
        d2 = torch.where(valid, d2, torch.zeros_like(d2))
    # the carried variance enters through the a-prefix-product, which
    # telescopes to k0 / k over the valid rows
    var = linear_recurrence_scan(a, b) + state.var[None] * (k0[None] / kd)

    # ---- first-sample branch (Algorithm 1 lines 3..5)
    first_row = k <= 1.0
    var = torch.where(first_row, torch.zeros_like(var), var)
    d2 = torch.where(first_row, torch.zeros_like(d2), d2)

    # ---- eqs (1), (4), (5), (6)
    safe = var > 0.0
    ecc = 1.0 / kd + torch.where(
        safe, d2 / (kd * torch.where(safe, var, torch.ones_like(var))),
        torch.zeros_like(var))
    zeta = ecc / 2.0
    thr = teda_threshold(k, m)
    outlier = (zeta > thr) & (k >= 2.0)
    if valid is not None:
        outlier = outlier & valid

    out = TedaOutput(ecc=ecc, typ=1.0 - ecc, zeta=zeta, threshold=thr,
                     outlier=outlier, k=k)
    final = TedaState(k=k[-1], mean=mean[-1], var=var[-1])
    return final, out


class WelfordState(NamedTuple):
    """Exact first/second moments of a block: count, mean, M2 (= n*var)."""

    count: torch.Tensor  # (...,)
    mean: torch.Tensor  # (..., N)
    m2: torch.Tensor  # (...,)


def welford_of_block(x: torch.Tensor) -> WelfordState:
    """Exact moments of a block x (T, ..., N) (Chan et al. pairwise form)."""
    mean = x.mean(0)
    m2 = ((x - mean[None]) ** 2).sum(-1).sum(0)
    count = torch.full(tuple(x.shape[1:-1]), float(x.shape[0]),
                       dtype=x.dtype, device=x.device)
    return WelfordState(count=count, mean=mean, m2=m2)


def welford_combine(a: WelfordState, b: WelfordState) -> WelfordState:
    """Associative merge of two disjoint blocks' exact moments.  A block
    with count 0 leaves the other unchanged."""
    n = a.count + b.count
    safe_n = torch.where(n > 0, n, torch.ones_like(n))
    delta = b.mean - a.mean
    mean = a.mean + delta * (b.count / safe_n)[..., None]
    m2 = a.m2 + b.m2 + (delta ** 2).sum(-1) * a.count * b.count / safe_n
    return WelfordState(count=n, mean=mean, m2=m2)
