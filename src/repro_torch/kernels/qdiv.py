"""Host-width exact image of the fixed-point bit-serial divider.

`fixedpoint.qformat._div_mag` is the model: restoring shift-subtract
long division, one quotient bit per iteration.  This module computes
the same function with one integer divide: the first 31 iterations of
the model stream the numerator's 31 magnitude bits, after which
`q = n // d`, `r = n % d`; the remaining `shift` iterations stream zeros
and stay explicit restoring steps on the remainder.  Round-half-up, the
d == 0 saturation and the lost-bit tracking replicate the model's.

All arithmetic is int64 (torch has no uint32 shifts or division); the
32-bit quotient register is masked where uint32 would wrap.

The CUDA kernels compute the same function another way
(`q_recip_div_mag` in `csrc/qformat.cuh`): a quotient estimate from a
biased float64 reciprocal, a saturation test on it and one exact
correction step.  `recip_div_mag` is that algorithm step for step in int64 and
float64, so that the CPU tests can hold it against `fast_div_mag`; the
plain versions of the kernels keep `fast_div_mag`.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import torch

from repro_torch.fixedpoint.qformat import _MASK32, QFormat, _signed_div

__all__ = ["fast_div_mag", "fast_div_qq", "fast_div_qi", "recip",
           "recip_2k", "recip_div_mag", "recip_div_qq", "recip_div_qi",
           "half_way_pairs", "remainder_edge_pairs", "div_mag_call"]


def fast_div_mag(n: torch.Tensor, d: torch.Tensor, shift: int,
                 rounding: str, qmax: int) -> torch.Tensor:
    """floor((n << shift) / d) on 32-bit magnitudes (int64 tensors,
    n <= 2^31) — `_div_mag` bits.  Returns int64 in [0, qmax]."""
    n, d = torch.broadcast_tensors(n, d)
    dz = d == 0  # the model's guard-free divider saturates on d == 0
    ds = torch.where(dz, torch.ones_like(d), d)

    # iterations 0..30 of the model in one divide: q = n/d, r = n%d
    q = torch.div(n, ds, rounding_mode="floor")
    r = n - q * ds
    lost = torch.zeros_like(n)

    # iterations 31..31+shift-1: zero dividend bits; r < d <= 2^31, so
    # only q can shed a high bit
    for _ in range(shift):
        lost = lost | (q >> 31)
        r = r << 1
        ge = r >= ds
        q = ((q << 1) | ge.to(torch.int64)) & _MASK32
        r = torch.where(ge, r - ds, r)

    if rounding == "round":
        half_up = r >= (ds >> 1) + (ds & 1)
        q2 = (q + half_up.to(torch.int64)) & _MASK32
        lost = lost | (q2 < q).to(torch.int64)
        q = q2
    return torch.where(dz | (lost > 0) | (q > qmax),
                       torch.full_like(q, qmax), q)


def fast_div_qq(fmt: QFormat, num, den) -> torch.Tensor:
    """Saturating Q / Q -> Q, bit-equal to `qformat.div_qq`."""
    return _signed_div(fmt, num, den, fmt.frac_len, fast_div_mag)


def fast_div_qi(fmt: QFormat, num, k) -> torch.Tensor:
    """Saturating Q / int -> Q, bit-equal to `qformat.div_qi`."""
    return _signed_div(fmt, num, k, 0, fast_div_mag)


# ------------------------------------------------- the kernels' divider
_U32_MAX = (1 << 32) - 1
_BIAS = 1.0 - 2.0 ** -40  # the estimate never exceeds N / d


def recip(d: torch.Tensor) -> torch.Tensor:
    """rn(rn(1 / max(d, 1)) * (1 - 2^-40)) in float64: `q_recip`."""
    d = torch.as_tensor(d, dtype=torch.int64)
    return (1.0 / torch.where(d == 0, 1, d).to(torch.float64)) * _BIAS


def recip_2k(k: torch.Tensor, rcp_k: torch.Tensor) -> torch.Tensor:
    """The reciprocal of |2k| from that of |k|, `q_recip_2k`: halved
    (exact), or its own where the int32 2k wraps."""
    k = torch.as_tensor(k, dtype=torch.int64)
    k2 = ((2 * k + (1 << 31)) & _MASK32) - (1 << 31)  # int32 wrap
    own = k2.abs() != 2 * k.abs()
    return torch.where(own, recip(k2.abs()), rcp_k * 0.5)


def recip_div_mag(n: torch.Tensor, d: torch.Tensor, shift: int,
                  rounding: str, qmax: int, rcp=None) -> torch.Tensor:
    """`fast_div_mag`'s function by the CUDA kernels' algorithm: the
    estimate qe = rn(rn(N) * rcp) of N = n << shift with the biased
    reciprocal rcp = `recip(d)` (the default), saturation where
    qe >= qmax + 2 or d == 0, q = trunc(qe), the remainder in 32 bits,
    one step up, round half up."""
    n, d = torch.broadcast_tensors(torch.as_tensor(n, dtype=torch.int64),
                                   torch.as_tensor(d, dtype=torch.int64))
    if rcp is None:
        rcp = recip(d)
    big_n = n << shift
    qe = big_n.to(torch.float64) * rcp
    sat = (d == 0) | (qe >= qmax + 2.0)
    # cvt.rzi.u32.f64 truncates; its saturation only matters where sat
    q = torch.where(sat, 0, qe.clamp(0, _U32_MAX).to(torch.int64))
    r = ((big_n & _MASK32) - q * d) & _MASK32  # uint32 arithmetic
    up = r >= d
    q, r = torch.where(up, q + 1, q), torch.where(up, r - d, r)
    if rounding == "round":
        q = q + (r >= d - r).to(torch.int64)
    return torch.where(sat | (q > qmax), torch.full_like(q, qmax), q)


def recip_div_qq(fmt: QFormat, num, den, rcp=None) -> torch.Tensor:
    """Saturating Q / Q -> Q by the kernels' divider (`q_div_qq_r`)."""
    return _signed_div(fmt, num, den, fmt.frac_len,
                       partial(recip_div_mag, rcp=rcp))


def recip_div_qi(fmt: QFormat, num, k, rcp=None) -> torch.Tensor:
    """Saturating Q / int -> Q by the kernels' divider (`q_div_qi_r`)."""
    return _signed_div(fmt, num, k, 0, partial(recip_div_mag, rcp=rcp))


def half_way_pairs(rng, shift: int, count: int):
    """(n, d) magnitudes, int64 numpy arrays, whose remainder of
    (n << shift) / d sits at d/2 (even d) or at (d -+ 1)/2 (odd d): the
    rounding edge, where round half up decides.  `rng` is a numpy
    Generator; the divider's tests and `chip_smoke.py` draw from it."""
    ns, ds = [], []
    for _ in range(count):
        # even d = u 2^(shift+1), u odd: n = u (2v + 1) leaves d/2
        u = 2 * int(rng.integers(0, 1 << max(0, 29 - shift))) + 1
        v = int(rng.integers(0, (2**31 // u - 1) // 2 + 1))
        ns.append(u * (2 * v + 1))
        ds.append(u << (shift + 1))
        # odd d: n = (d -+ 1)/2 * 2^-shift mod d
        d = 2 * int(rng.integers(1, 2**30)) + 1
        for h in ((d - 1) // 2, (d + 1) // 2):
            ns.append(h * pow(2, -shift, d) % d)
            ds.append(d)
    return np.array(ns, np.int64), np.array(ds, np.int64)


def remainder_edge_pairs(rng, shift: int, count: int):
    """(n, d) magnitudes, int64 numpy arrays, whose remainder of
    (n << shift) / d is 0, 1 or d - 1 for odd d of every magnitude, n as
    large as 2^31 allows: the quotients whose estimate lands just below
    or just above an integer."""
    ns, ds = [], []
    for _ in range(count):
        top = int(rng.integers(2, 32))
        d = 2 * int(rng.integers(1, 1 << (top - 1))) + 1
        for rem in (0, 1, d - 1):
            base = rem * pow(2, -shift, d) % d
            j = int(rng.integers(0, (2**31 - base) // d + 1))
            ns.append(base + j * d)
            ds.append(d)
    return np.array(ns, np.int64), np.array(ds, np.int64)


def div_mag_call(n: torch.Tensor, d: torch.Tensor, shift: int,
                 rounding: str, qmax: int) -> torch.Tensor:
    """`fast_div_mag`'s function on (count,) magnitudes in [0, 2^31]:
    the kernels' divider itself (`csrc/qdiv_probe.cu`) on CUDA tensors,
    `fast_div_mag` on CPU tensors.  Returns int64 in [0, qmax]."""
    n, d = torch.broadcast_tensors(n.to(torch.int64), d.to(torch.int64))
    if n.device.type == "cpu":
        return fast_div_mag(n, d, shift, rounding, qmax)
    if n.device.type != "cuda":
        raise ValueError(f"div_mag_call: unsupported device {n.device}")
    from repro_torch.kernels import _build

    n, d = n.contiguous(), d.to(n.device).contiguous()
    out = torch.empty(n.shape, dtype=torch.int32, device=n.device)
    err = _build.library().qdiv_probe_u32(
        n.data_ptr(), d.data_ptr(), out.data_ptr(), n.numel(), shift,
        int(rounding == "round"), qmax, n.device.index,
        torch.cuda.current_stream(n.device).cuda_stream)
    _build.check(err, "qdiv_probe_u32")
    return out.to(torch.int64)
