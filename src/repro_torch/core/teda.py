"""Paper-faithful TEDA (Typicality and Eccentricity Data Analytics).

Algorithm 1 of da Silva et al., "Hardware Architecture Proposal for
TEDA algorithm to Data Streaming Anomaly Detection", verbatim:

  eq (2)  mu_k    = (k-1)/k * mu_{k-1} + x_k / k
  eq (3)  var_k   = (k-1)/k * var_{k-1} + ||x_k - mu_k||^2 / k
  eq (1)  ecc_k   = 1/k + ||x_k - mu_k||^2 / (k * var_k)
  eq (4)  typ_k   = 1 - ecc_k
  eq (5)  zeta_k  = ecc_k / 2
  eq (6)  outlier = zeta_k > (m^2 + 1) / (2k)

State is O(1) per stream: (k, mu, var).  Streams are multivariate with
feature dimension N on the trailing axis; leading batch dims are
independent streams.  `teda_stream` is the sequential form (one sample
per loop step, the FPGA pipeline's analogue); the parallel form lives in
`core/scan.py` and the kernels in `kernels/`.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

__all__ = ["TedaState", "TedaOutput", "teda_init", "teda_step",
           "teda_stream", "teda_threshold", "teda_numpy_loop"]


class TedaState(NamedTuple):
    """O(1) recursive TEDA state for one (batch of) stream(s).

    k:    (...,)   — number of samples absorbed so far.
    mean: (..., N) — recursive mean, eq (2).
    var:  (...,)   — recursive variance, eq (3).
    """

    k: torch.Tensor
    mean: torch.Tensor
    var: torch.Tensor


class TedaOutput(NamedTuple):
    """Per-sample verdict, one entry per eq of the paper."""

    ecc: torch.Tensor  # eq (1) eccentricity xi_k
    typ: torch.Tensor  # eq (4) typicality tau_k
    zeta: torch.Tensor  # eq (5) normalized eccentricity
    threshold: torch.Tensor  # eq (6) RHS, (m^2+1)/(2k)
    outlier: torch.Tensor  # eq (6) verdict (bool); False while k < 2
    k: torch.Tensor  # iteration index of this verdict


def teda_init(batch_shape: Tuple[int, ...] = (), n_features: int = 1,
              dtype=torch.float32, device=None) -> TedaState:
    """Fresh state: k=0, mu=0, var=0 (Algorithm 1 initial conditions)."""
    return TedaState(
        k=torch.zeros(batch_shape, dtype=dtype, device=device),
        mean=torch.zeros(batch_shape + (n_features,), dtype=dtype,
                         device=device),
        var=torch.zeros(batch_shape, dtype=dtype, device=device),
    )


def teda_threshold(k: torch.Tensor, m) -> torch.Tensor:
    """RHS of eq (6): (m^2 + 1) / (2k)."""
    m = torch.as_tensor(m, dtype=torch.float32, device=k.device)
    return (m ** 2 + 1.0) / (2.0 * k)


def teda_step(state: TedaState, x: torch.Tensor, m=3.0
              ) -> Tuple[TedaState, TedaOutput]:
    """One iteration of Algorithm 1 (lines 3..15) for sample x (..., N).

    The k==1 branch sets mu <- x, var <- 0 and emits a non-outlier
    verdict (eq (5) is defined for k >= 2).
    """
    x = x.to(state.mean.dtype)
    k = state.k + 1.0  # discretization instant of this sample
    first = k <= 1.0

    # --- MEAN module, eq (2)
    kk = k[..., None]
    mean = torch.where(first[..., None], x,
                       (kk - 1.0) / kk * state.mean + x / kk)

    # --- VARIANCE module, eq (3)
    d2 = ((x - mean) ** 2).sum(-1)  # ||x_k - mu_k||^2
    var = torch.where(first, torch.zeros_like(k),
                      (k - 1.0) / k * state.var + d2 / k)

    # --- ECCENTRICITY module, eq (1), with the var > 0 guard
    safe = var > 0.0
    ecc = 1.0 / k + torch.where(
        safe, d2 / (k * torch.where(safe, var, torch.ones_like(var))),
        torch.zeros_like(var))

    # --- OUTLIER module, eqs (5)-(6)
    zeta = ecc / 2.0
    thr = teda_threshold(k, m)
    outlier = (zeta > thr) & (k >= 2.0)

    out = TedaOutput(ecc=ecc, typ=1.0 - ecc, zeta=zeta, threshold=thr,
                     outlier=outlier, k=k)
    return TedaState(k=k, mean=mean, var=var), out


def teda_stream(x: torch.Tensor, m=3.0,
                state: Optional[TedaState] = None,
                ) -> Tuple[TedaState, TedaOutput]:
    """Run Algorithm 1 over a stream x of shape (T, ..., N), one sample
    per loop step.  Returns the final state and per-sample outputs
    stacked on axis 0."""
    x = torch.as_tensor(x)
    if state is None:
        state = teda_init(tuple(x.shape[1:-1]), x.shape[-1],
                          torch.float32, x.device)
    outs = []
    for t in range(x.shape[0]):
        state, out = teda_step(state, x[t], m)
        outs.append(out)
    stacked = TedaOutput(*(torch.stack(f) for f in zip(*outs)))
    return state, stacked


def teda_numpy_loop(x, m: float = 3.0):
    """Plain-Python reference loop (the paper's 'software platform').

    An independent float64 oracle.  x: numpy (T, N).
    """
    import numpy as np

    T, _ = x.shape
    mu = np.zeros(x.shape[1], np.float64)
    var = 0.0
    ecc = np.zeros(T, np.float64)
    zeta = np.zeros(T, np.float64)
    thr = np.zeros(T, np.float64)
    outlier = np.zeros(T, bool)
    for i in range(T):
        k = i + 1.0
        xk = x[i].astype(np.float64)
        if i == 0:
            mu = xk.copy()
            var = 0.0
        else:
            mu = (k - 1.0) / k * mu + xk / k
            d2 = float(np.sum((xk - mu) ** 2))
            var = (k - 1.0) / k * var + d2 / k
        d2 = float(np.sum((xk - mu) ** 2))
        ecc[i] = 1.0 / k + (d2 / (k * var) if var > 0.0 else 0.0)
        zeta[i] = ecc[i] / 2.0
        thr[i] = (m * m + 1.0) / (2.0 * k)
        outlier[i] = (zeta[i] > thr[i]) and k >= 2
    return {"ecc": ecc, "zeta": zeta, "threshold": thr, "outlier": outlier,
            "mean": mu, "var": var}
