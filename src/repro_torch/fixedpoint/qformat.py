"""Q-format fixed-point arithmetic emulating the paper's FPGA datapath.

A `QFormat(word_len, frac_len)` value is a signed two's-complement
integer of `word_len` bits with `frac_len` fractional bits, held in an
int32 tensor.  Every operator reproduces what the synthesized datapath
does, bit for bit with the JAX package's `fixedpoint/qformat.py`:

  * saturating add/sub over the symmetric range [-(2^(WL-1)-1),
    2^(WL-1)-1];
  * `sat_mul` — the full 2*WL-bit product, >> FL with truncation toward
    zero (or round-half-away), saturating;
  * `div_qq` / `div_qi` — the bit-serial restoring divider, one quotient
    bit per clock.

PyTorch has no shifts, floor division or comparisons on uint32, so the
uint32 magnitude arithmetic of the reference runs here on int64: the
magnitudes are at most 2^31, their products at most 2^62, and the
divider's 32-bit registers are masked where uint32 would wrap.  The
results are narrowed back to int32.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = ["QFormat", "sat", "sat_add", "sat_sub", "sat_mul",
           "div_qq", "div_qi"]

_MASK32 = 0xFFFFFFFF
_I32_MIN = -(1 << 31)


def _i64(v) -> torch.Tensor:
    return torch.as_tensor(v).to(torch.int64)


def _pair64(a, b):
    """Two operands as broadcast int64 tensors on one device (a Python
    int or CPU scalar follows the other operand's device)."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    dev = a.device if a.device.type != "cpu" else b.device
    return torch.broadcast_tensors(a.to(device=dev, dtype=torch.int64),
                                   b.to(device=dev, dtype=torch.int64))


class QFormat(NamedTuple):
    """Fixed-point spec: `word_len` total bits, `frac_len` fractional.

    `rounding` is the post-shift policy of mul/div: "trunc" (toward
    zero, the cheap hardware default) or "round" (half away from zero).
    """

    word_len: int = 32
    frac_len: int = 16
    rounding: str = "trunc"

    @property
    def int_len(self) -> int:
        return self.word_len - 1 - self.frac_len

    @property
    def qmax(self) -> int:
        return (1 << (self.word_len - 1)) - 1

    @property
    def qmin(self) -> int:
        return -self.qmax  # symmetric saturation

    @property
    def one(self) -> int:
        """Raw representation of 1.0 (may exceed qmax when FL=WL-1)."""
        return 1 << self.frac_len

    @property
    def scale(self) -> float:
        return float(1 << self.frac_len)

    @property
    def resolution(self) -> float:
        return 1.0 / self.scale

    def validate(self) -> "QFormat":
        if not (2 <= self.word_len <= 32):
            raise ValueError(f"word_len {self.word_len} not in [2, 32]")
        if not (0 <= self.frac_len <= min(self.word_len - 1, 30)):
            raise ValueError(
                f"frac_len {self.frac_len} not in [0, "
                f"{min(self.word_len - 1, 30)}] for word_len "
                f"{self.word_len}")
        if self.rounding not in ("trunc", "round"):
            raise ValueError(f"rounding {self.rounding!r}")
        return self

    def quantize(self, x) -> torch.Tensor:
        """Float -> Q (round-to-nearest ADC front-end, saturating).

        float32 product, round half to even, NaN -> 0, then a saturating
        convert.  XLA's float->int32 convert saturates (infinities
        included) where torch's wraps, so the value is clamped in
        float64 to +-2^32 first, converted to int64 and clamped to
        [qmin, qmax] before narrowing.
        """
        v = torch.round(torch.as_tensor(x).to(torch.float32) * self.scale)
        v = torch.where(torch.isnan(v), torch.zeros_like(v), v)
        v = v.to(torch.float64).clamp(-2.0 ** 32, 2.0 ** 32)
        return v.to(torch.int64).clamp(self.qmin, self.qmax).to(torch.int32)

    def quantize_scalar(self, x: float) -> int:
        """Exact host-side quantization of a Python float constant."""
        v = int(round(float(x) * self.scale))
        return max(self.qmin, min(self.qmax, v))

    def dequantize(self, q) -> torch.Tensor:
        return torch.as_tensor(q).to(torch.float32) / self.scale

    def dequantize_np(self, q) -> np.ndarray:
        """Exact float64 dequantization for analysis/oracle comparison."""
        if isinstance(q, torch.Tensor):
            q = q.cpu().numpy()
        return np.asarray(q, np.float64) / self.scale

    def label(self) -> str:
        return f"Q{self.int_len}.{self.frac_len}(wl={self.word_len})"


# --------------------------------------------------------------- add/sub
def sat(fmt: QFormat, v) -> torch.Tensor:
    """Clamp an integer value into the WL-bit symmetric range."""
    return _i64(v).clamp(fmt.qmin, fmt.qmax).to(torch.int32)


def sat_add(fmt: QFormat, a, b) -> torch.Tensor:
    """Saturating Q + Q.  Operands must already be in-format.

    The exact int64 sum clamped to the format equals the reference's
    int32 add with its wrap detection (a wrapped sum is pinned to the
    extreme of the operands' sign, which is where the clamp lands too).
    """
    a, b = _pair64(a, b)
    return sat(fmt, a + b)


def sat_sub(fmt: QFormat, a, b) -> torch.Tensor:
    # int32 negation wraps at -2^31 in the reference: keep that
    b = _i64(b)
    nb = torch.where(b == _I32_MIN, b, -b)
    return sat_add(fmt, a, nb)


# -------------------------------------------------------------- multiply
def sat_mul(fmt: QFormat, a, b) -> torch.Tensor:
    """Saturating Q * Q -> Q: full product, >> FL, round/trunc, clamp.

    The reference builds the 64-bit product of the uint32 magnitudes
    from four 16x16 partial products (hi, lo); that is the exact
    product, which int64 holds directly (magnitudes <= 2^31).
    """
    a, b = _pair64(a, b)
    neg = (a < 0) != (b < 0)
    p = a.abs() * b.abs()
    fl = fmt.frac_len
    if fmt.rounding == "round" and fl > 0:
        p = p + (1 << (fl - 1))
    # saturate iff product >= 2^(WL-1+FL)  (i.e. (P >> FL) > qmax)
    over = p >= (1 << (fmt.word_len - 1 + fl))
    q = torch.where(over, torch.full_like(p, fmt.qmax), p >> fl)
    return torch.where(neg, -q, q).to(torch.int32)


# ---------------------------------------------------------------- divide
def _div_mag(n: torch.Tensor, d: torch.Tensor, shift: int,
             rounding: str, qmax: int) -> torch.Tensor:
    """floor((n << shift) / d) on 32-bit magnitudes, bit-serial (int64).

    Restoring shift-subtract long division, one quotient bit per
    iteration; bit i of (n << shift) is streamed MSB-first and the wide
    dividend is never materialized.  d == 0 saturates to qmax.  The
    remainder and quotient registers are 32 bits wide: masked wherever
    the reference's uint32 shifts wrap.  Returns int64 in [0, qmax].
    """
    n, d = torch.broadcast_tensors(n, d)
    zero = torch.zeros_like(n)
    r, q, lost = zero, zero, zero
    for j in range(31 + shift):
        bit = (n >> (30 - j)) & 1 if j <= 30 else zero
        lost = lost | (r >> 31)
        r = ((r << 1) | bit) & _MASK32
        ge = r >= d
        lost = lost | (q >> 31)
        q = ((q << 1) | ge.to(torch.int64)) & _MASK32
        r = torch.where(ge, r - d, r)
    if rounding == "round":
        half_up = (r >= (d >> 1) + (d & 1)) & (d > 0)
        q2 = (q + half_up.to(torch.int64)) & _MASK32
        lost = lost | (q2 < q).to(torch.int64)
        q = q2
    return torch.where((lost > 0) | (q > qmax), torch.full_like(q, qmax), q)


def _signed_div(fmt: QFormat, num, den, shift: int, mag_fn) -> torch.Tensor:
    """Sign-magnitude wrapper shared by the Q/Q and Q/int dividers."""
    num, den = _pair64(num, den)
    neg = (num < 0) != (den < 0)
    q = mag_fn(num.abs(), den.abs(), shift, fmt.rounding, fmt.qmax)
    return torch.where(neg, -q, q).to(torch.int32)


def div_qq(fmt: QFormat, num, den) -> torch.Tensor:
    """Saturating Q / Q -> Q: computes (num << FL) / den bit-serially."""
    return _signed_div(fmt, num, den, fmt.frac_len, _div_mag)


def div_qi(fmt: QFormat, num, k) -> torch.Tensor:
    """Saturating Q / int -> Q (no FL pre-shift): the divider the
    pipeline uses for every division by the sample counter k."""
    return _signed_div(fmt, num, k, 0, _div_mag)
