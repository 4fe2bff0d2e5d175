"""Algorithm 1 re-expressed in Q-format integer arithmetic.

Mirrors the paper's four pipeline modules on the quantized datapath:

  MEAN         mu_k  = (k-1)/k * mu_{k-1} + x_k / k          eq (2)
  VARIANCE     var_k = (k-1)/k * var_{k-1} + ||x-mu||^2 / k  eq (3)
  ECCENTRICITY ecc_k = 1/k + (d2 / var) / k                  eq (1)
  OUTLIER      ecc/2 > (m^2+1) / (2k)                        eqs (5)(6)

All quantities are int32 Q-values of one `QFormat`; the sample counter k
is a plain integer.  Division by k uses `div_qi`, the two Q/Q quotients
((k-1)/k and d2/var) use `div_qq`, and `zeta` is a 1-bit arithmetic
right shift.

Two stream functions, both Python loops over time with the counter-only
dividers hoisted out of the loop:
  * `teda_q_stream`    — multivariate (T, ..., N) streams;
  * `teda_q_scan_chan` — (T, C) univariate channels over `_q_step_u`,
    the oracle the Q kernel is held to bit for bit.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.teda import TedaOutput, TedaState
from repro_torch.fixedpoint.qformat import (QFormat, div_qi, div_qq, sat,
                                            sat_add, sat_mul, sat_sub)

__all__ = ["teda_q_init", "teda_q_step", "teda_q_stream",
           "teda_q_scan_chan", "msq1_const"]

_I32 = torch.int32


def msq1_const(fmt: QFormat, m):
    """The OUTLIER module's ROM constant: quantized m^2 + 1.

    Python scalars and float arrays (numpy or torch) are quantized
    exactly in float64 — per-slot m vectors give the same msq1 bits as
    the scalar path.  Integer input is taken as an already-quantized Q
    constant.  Returns an int for scalar input, else an int32 tensor.
    """
    if isinstance(m, (int, float)):
        return fmt.quantize_scalar(float(m) * float(m) + 1.0)
    mt = torch.as_tensor(m)
    if not torch.is_floating_point(mt):
        return mt.to(_I32)
    mv = mt.to(torch.float64)
    q = torch.round((mv * mv + 1.0) * fmt.scale).clamp(fmt.qmin, fmt.qmax)
    q = q.to(_I32)
    return int(q) if q.ndim == 0 else q


def teda_q_init(batch_shape: Tuple[int, ...] = (), n_features: int = 1,
                device=None) -> TedaState:
    """Fresh Q-state: k=0, mu=0, var=0 (all int32)."""
    return TedaState(
        k=torch.zeros(batch_shape, dtype=_I32, device=device),
        mean=torch.zeros(batch_shape + (n_features,), dtype=_I32,
                         device=device),
        var=torch.zeros(batch_shape, dtype=_I32, device=device),
    )


def _q_counter_terms(fmt: QFormat, k, msq1):
    """The three dividers that depend only on the counter k:
    rk=(k-1)/k, inv_k=1/k, thr=(m^2+1)/(2k).  Data-independent, so the
    stream functions compute them for every instant before the loop."""
    k = torch.as_tensor(k).to(_I32)
    rk = div_qq(fmt, k - 1, k)
    inv_k = div_qi(fmt, torch.full_like(k, fmt.one), k)
    thr = div_qi(fmt, torch.as_tensor(msq1, device=k.device).to(_I32)
                 .expand(k.shape), 2 * k)
    return rk, inv_k, thr


def _q_mean_update(fmt: QFormat, first, rk, k, mean_prev, xq):
    """MEAN module, eq (2): (k-1)/k * mu + x/k with the k=1 override."""
    return torch.where(first, xq,
                       sat_add(fmt, sat_mul(fmt, rk, mean_prev),
                               div_qi(fmt, xq, k)))


def _q_post_d2(fmt: QFormat, k, first, terms, d2, var_prev):
    """VARIANCE + ECCENTRICITY + OUTLIER modules from a reduced d2.

    Shared by the univariate and multivariate steps.  Returns
    (var', ecc, zeta, thr, outlier).
    """
    rk, inv_k, thr = terms
    var_n = torch.where(first, torch.zeros_like(var_prev),
                        sat_add(fmt, sat_mul(fmt, rk, var_prev),
                                div_qi(fmt, d2, k)))

    # ECCENTRICITY: 1/k + (d2/var)/k, var>0 guard as in the float path
    safe = var_n > 0
    ratio = div_qq(fmt, d2, torch.where(safe, var_n,
                                        torch.ones_like(var_n)))
    ecc = sat_add(fmt, inv_k, torch.where(safe, div_qi(fmt, ratio, k),
                                          torch.zeros_like(ratio)))

    # OUTLIER: zeta = ecc >> 1, thr = (m^2+1)/(2k)
    zeta = ecc >> 1
    outlier = (zeta > thr) & (k >= 2)
    return var_n, ecc, zeta, thr, outlier


def _q_step_u(fmt: QFormat, k, mean, var, xq, msq1, terms=None):
    """One univariate Q-TEDA step on tensors of identical shape.

    k is the (already incremented) integer instant, scalar or tensor.
    Returns (mean', var', ecc, zeta, thr, outlier).
    """
    k = torch.as_tensor(k, device=xq.device).to(_I32)
    first = k <= 1
    if terms is None:
        terms = _q_counter_terms(fmt, k, msq1)
    mean_n = _q_mean_update(fmt, first, terms[0], k, mean, xq)

    # VARIANCE: d2 = (x - mu_k)^2 via the widening multiplier
    d = sat_sub(fmt, xq, mean_n)
    d2 = sat_mul(fmt, d, d)
    var_n, ecc, zeta, thr, outlier = _q_post_d2(
        fmt, k, first, terms, d2, var)
    return mean_n, var_n, ecc, zeta, thr, outlier


def teda_q_step(fmt: QFormat, state: TedaState, xq: torch.Tensor,
                msq1, terms=None) -> Tuple[TedaState, TedaOutput]:
    """One multivariate Q-TEDA iteration; xq int32 Q of shape (..., N).

    ||x - mu||^2 is a saturating adder tree over the per-feature
    squares; everything after d2 is the shared `_q_post_d2`.
    """
    k = state.k + 1
    first = k <= 1
    if terms is None:
        terms = _q_counter_terms(fmt, k, msq1)
    rk = terms[0]
    mean = _q_mean_update(fmt, first[..., None], rk[..., None],
                          k[..., None], state.mean, xq)

    d = sat_sub(fmt, xq, mean)
    d2 = sat_mul(fmt, d[..., 0], d[..., 0])
    for j in range(1, xq.shape[-1]):
        d2 = sat_add(fmt, d2, sat_mul(fmt, d[..., j], d[..., j]))
    var, ecc, zeta, thr, outlier = _q_post_d2(
        fmt, k, first, terms, d2, state.var)

    one = sat(fmt, min(fmt.one, fmt.qmax))
    out = TedaOutput(ecc=ecc, typ=sat_sub(fmt, one, ecc), zeta=zeta,
                     threshold=thr, outlier=outlier, k=k)
    return TedaState(k=k, mean=mean, var=var), out


def _quantized(x, fmt: QFormat) -> torch.Tensor:
    """Float input goes through the ADC front-end; integer input is
    taken as already-quantized Q values."""
    x = torch.as_tensor(x)
    return fmt.quantize(x) if torch.is_floating_point(x) else x.to(_I32)


def teda_q_stream(x, fmt: QFormat, m: float = 3.0,
                  state: Optional[TedaState] = None,
                  ) -> Tuple[TedaState, TedaOutput]:
    """Bit-accurate Q-TEDA over a stream x (T, ..., N).

    Outputs are Q int32 (dequantize for plots); `outlier` is bool.
    """
    fmt.validate()
    xq = _quantized(x, fmt)
    if state is None:
        state = teda_q_init(tuple(xq.shape[1:-1]), xq.shape[-1], xq.device)
    msq1 = msq1_const(fmt, m)

    t_len = xq.shape[0]
    ks = (torch.arange(1, t_len + 1, dtype=_I32, device=xq.device)
          .reshape((t_len,) + (1,) * state.k.ndim) + state.k[None])
    terms = _q_counter_terms(fmt, ks, msq1)
    outs = []
    for t in range(t_len):
        state, out = teda_q_step(fmt, state, xq[t], msq1,
                                 terms=tuple(v[t] for v in terms))
        outs.append(out)
    return state, TedaOutput(*(torch.stack(f) for f in zip(*outs)))


def teda_q_scan_chan(x, fmt: QFormat, m: float = 3.0, k0=0,
                     mean0: Optional[torch.Tensor] = None,
                     var0: Optional[torch.Tensor] = None):
    """Q-TEDA over (T, C) — C independent univariate channels.

    A loop over `_q_step_u`, the function the Q kernel runs per row: the
    kernel must match it bit for bit.  `k0` may be a scalar or a
    per-channel (C,) vector.  Returns (final (k, mean, var), dict of
    (T, C) tensors).
    """
    fmt.validate()
    xq = _quantized(x, fmt)
    t_len, c = xq.shape
    dev = xq.device
    mean0 = (torch.zeros(c, dtype=_I32, device=dev) if mean0 is None
             else torch.as_tensor(mean0, device=dev).to(_I32))
    var0 = (torch.zeros(c, dtype=_I32, device=dev) if var0 is None
            else torch.as_tensor(var0, device=dev).to(_I32))
    k0v = torch.as_tensor(k0, device=dev).to(_I32).expand(c)
    msq1 = msq1_const(fmt, m)

    ks = k0v[None, :] + torch.arange(1, t_len + 1, dtype=_I32,
                                     device=dev)[:, None]
    terms = _q_counter_terms(fmt, ks, msq1)
    mean, var = mean0, var0
    rows = []
    for t in range(t_len):
        mean, var, ecc, zeta, thr, outl = _q_step_u(
            fmt, ks[t], mean, var, xq[t], msq1,
            terms=tuple(v[t] for v in terms))
        rows.append((mean, var, ecc, zeta, thr.expand(c), outl.expand(c)))
    names = ("mean", "var", "ecc", "zeta", "threshold", "outlier")
    if rows:
        outs = {n: torch.stack(v) for n, v in zip(names, zip(*rows))}
    else:
        outs = {n: torch.zeros((0, c), dtype=torch.bool if n == "outlier"
                               else _I32, device=dev) for n in names}
    final = (k0v + t_len, mean, var)
    return final, outs
