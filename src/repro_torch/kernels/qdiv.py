"""Host-width exact image of the fixed-point bit-serial divider.

`fixedpoint.qformat._div_mag` is the model: restoring shift-subtract
long division, one quotient bit per iteration.  This module computes
the same function with one integer divide: the first 31 iterations of
the model stream the numerator's 31 magnitude bits, after which
`q = n // d`, `r = n % d`; the remaining `shift` iterations stream zeros
and stay explicit restoring steps on the remainder.  Round-half-up, the
d == 0 saturation and the lost-bit tracking replicate the model's.

All arithmetic is int64 (torch has no uint32 shifts or division); the
32-bit quotient register is masked where uint32 would wrap.  The CUDA
kernels carry the same function as `q_fast_div_mag` in
`csrc/qformat.cuh`.
"""
from __future__ import annotations

import torch

from repro_torch.fixedpoint.qformat import _MASK32, QFormat, _signed_div

__all__ = ["fast_div_mag", "fast_div_qq", "fast_div_qi"]


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
