"""Algorithm 1 (TEDA) on the bit-accurate Q-format datapath, the Q
configurations' reference.

Frozen copy.  The arithmetic is that of the port's Q oracle
(`src/repro_torch/fixedpoint/qformat.py` and
`src/repro_torch/fixedpoint/teda_q.py::teda_q_scan_chan`, the FPGA
pipeline of da Silva et al., arXiv:2003.03837): int32 words of one
Q(WL, FL) format, saturating add and subtract over the symmetric range,
multiplies as the full product shifted right by FL (truncated toward
zero), and the bit-serial restoring divider,
whose function is the integer quotient of the magnitudes, saturated.
For each channel and sample k = 1, 2, ...

    rk = (k-1)/k [Q/Q]   inv = 1/k [Q/int]   thr = (m^2+1)/(2k) [Q/int]
    mean = x at k = 1, else mean*rk + x/k
    d2   = (x - mean)^2
    var  = 0 at k = 1, else var*rk + d2/k
    ecc  = inv + (d2/var)/k  (inv where var = 0)
    flag = ecc >> 1 > thr and k >= 2

in int64 PyTorch, so that it runs on the card or the host alike, with
a per-channel valid length (rows at or past it leave the state as it
is and never flag).  Frozen in the benchmark so that the yardstick
stays fixed while the program changes; it imports nothing of the
program and nothing of the JAX package.

`control_scan` is the control of `correct`: the same datapath with
every divider computed through a float32 quotient (24 bits of mantissa
in place of the exact quotient), the shortcut a faster divider would
take.  It has to fail.

States are dicts of (C,) int32 words {"k", "mean", "var"}.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["state0", "from_program", "scan", "slack", "Gaps",
           "control_scan", "control_state0", "control_to_program"]

I32, I64 = torch.int32, torch.int64


class Fmt:
    """Q(WL, FL) with truncation, the only rounding a configuration
    states."""

    def __init__(self, word_len: int, frac_len: int,
                 rounding: str = "trunc"):
        if rounding != "trunc":
            raise ValueError(f"only the truncating datapath is frozen, "
                             f"got rounding {rounding!r}")
        self.wl, self.fl = int(word_len), int(frac_len)
        self.qmax = (1 << (self.wl - 1)) - 1
        self.one = 1 << self.fl


def _sat(f: Fmt, v):
    return v.clamp(-f.qmax, f.qmax)


def _add(f: Fmt, a, b):
    return _sat(f, a + b)


def _sub(f: Fmt, a, b):
    nb = torch.where(b == -(1 << 31), b, -b)
    return _sat(f, a + nb)


def _mul(f: Fmt, a, b):
    """The full product of the magnitudes, >> FL, saturated, with the
    operands' sign."""
    q = ((a.abs() * b.abs()) >> f.fl).clamp_max(f.qmax)
    return q * (torch.sign(a) * torch.sign(b))


def _div_exact(f: Fmt, num, den):
    """floor(num / den) of non-negative int64 operands, den > 0."""
    return torch.div(num, den, rounding_mode="floor")


def _div_f32(f: Fmt, num, den):
    """The control's divider: the quotient through float32."""
    q = num.to(torch.float32) / den.to(torch.float32)
    return torch.floor(q).to(I64)


def _div(f: Fmt, num, den, shift: int, mag):
    num, den = torch.broadcast_tensors(num, den)
    neg = (num < 0) != (den < 0)
    n = (num.abs() & 0x7FFFFFFF) << shift
    d = den.abs()
    pos = d > 0
    q = mag(f, n, torch.where(pos, d, torch.ones_like(d)))
    q = torch.where(~pos | (q > f.qmax), torch.full_like(q, f.qmax), q)
    return torch.where(neg, -q, q)


def state0(n: int, device) -> dict:
    z = torch.zeros(n, dtype=I32, device=device)
    return {"k": z, "mean": z, "var": z}


def from_program(k, mean, var) -> dict:
    return {"k": k.to(I32), "mean": mean.to(I32), "var": var.to(I32)}


# channels up to which the carried loops run in numpy on the host: on
# short rows PyTorch's per-call cost outweighs the work
HOST_LOOP_MAX_C = 16384


def _recur(f: Fmt, rk, add, v0, first, at_first, valid):
    """The carried multiply-add v = v*rk + add, row by row (the value
    `at_first` where k = 1); the carry holds still past a channel's
    valid length.  Returns every row's value, (T, C) int64, on rk's
    device."""
    has_first = first.any(1).tolist()
    ragged = not bool(valid.all())
    if rk.shape[1] <= HOST_LOOP_MAX_C:
        rows = _recur_host(f, *(t.cpu().numpy() for t in (
            rk, add, v0.to(I64), first, at_first, valid)), has_first,
            ragged)
        return torch.from_numpy(rows).to(rk.device)
    out = torch.empty_like(rk)
    v = v0.to(I64)
    for t in range(rk.shape[0]):
        q = ((v.abs() * rk[t]) >> f.fl).clamp_max(f.qmax)
        new = (q * (v.sign() * rk[t].sign()) + add[t]).clamp(-f.qmax,
                                                             f.qmax)
        if has_first[t]:
            new = torch.where(first[t], at_first[t], new)
        out[t] = new
        v = torch.where(valid[t], new, v) if ragged else new
    return out


def _recur_host(f, rk, add, v0, first, at_first, valid, has_first,
                ragged):
    """`_recur`'s loop in numpy, the same integer operations in place."""
    out = np.empty(rk.shape, np.int64)
    sr = np.sign(rk)
    v, a, s = v0.copy(), np.empty_like(v0), np.empty_like(v0)
    for t in range(rk.shape[0]):
        np.abs(v, out=a)
        a *= rk[t]
        a >>= f.fl
        np.minimum(a, f.qmax, out=a)
        np.sign(v, out=s)
        s *= sr[t]
        a *= s
        a += add[t]
        np.minimum(a, f.qmax, out=a)
        np.maximum(a, -f.qmax, out=a)
        if has_first[t]:
            a = np.where(first[t], at_first[t], a)
        out[t] = a
        if ragged:
            np.copyto(v, a, where=valid[t])
        else:
            v, a = a, v
    return out


def _carry(rows, v0, valid):
    """Each channel's value at its last valid row (v0 where none)."""
    n = valid.sum(0)
    if not rows.shape[0]:
        return v0.to(I64)
    last = rows.gather(0, (n - 1).clamp_min(0)[None, :])[0]
    return torch.where(n > 0, last, v0.to(I64))


def _scan(f: Fmt, x, st: dict, msq1: int, vlen, mag):
    t_len, c = x.shape
    dev = x.device
    rows = torch.arange(t_len, dtype=I64, device=dev)[:, None]
    valid = (torch.ones((t_len, c), dtype=torch.bool, device=dev)
             if vlen is None else rows < vlen.to(dev, I64)[None, :])
    k = st["k"].to(I64)[None, :] + rows + 1
    x64 = x.to(I64)

    def qq(a, b):
        return _div(f, a, b, f.fl, mag)

    def qi(a, b):
        return _div(f, a, b, 0, mag)

    rk = qq(k - 1, k)
    inv = qi(torch.full_like(k, f.one), k)
    thr = qi(torch.full_like(k, int(msq1)), 2 * k)
    xk = qi(x64, k)
    first = k <= 1
    mean_rows = _recur(f, rk, xk, st["mean"], first, x64, valid)
    d = _sub(f, x64, mean_rows)
    d2 = _mul(f, d, d)
    e = qi(d2, k)
    var_rows = _recur(f, rk, e, st["var"], first, torch.zeros_like(e),
                      valid)
    mean, var = (_carry(rows_, v0, valid) for rows_, v0 in
                 ((mean_rows, st["mean"]), (var_rows, st["var"])))
    safe = var_rows > 0
    ratio = qq(d2, torch.where(safe, var_rows, torch.ones_like(var_rows)))
    ecc = _add(f, inv, torch.where(safe, qi(ratio, k),
                                   torch.zeros_like(ratio)))
    flag = valid & ((ecc >> 1) > thr) & (k >= 2)
    n_valid = valid.sum(0).to(I32)
    new_st = {"k": st["k"] + n_valid, "mean": mean.to(I32),
              "var": var.to(I32)}
    return {"ecc": ecc.to(I32), "flag": flag, "valid": valid}, new_st


def msq1_of(f: Fmt, m: float) -> int:
    """The quantized m^2 + 1, rounded to nearest in float64."""
    v = int(round((float(m) * float(m) + 1.0) * (1 << f.fl)))
    return max(-f.qmax, min(f.qmax, v))


def scan(x, st: dict, m: float, vlen=None, *, fmt):
    """One (T, C) chunk of Q words from state `st`.  Returns ({"ecc",
    "flag", "valid"}, state')."""
    f = Fmt(*fmt)
    return _scan(f, x, st, msq1_of(f, m), vlen, _div_exact)


def slack(out: dict, band: float) -> torch.Tensor:
    """Bit for bit: no flag may decide either way."""
    return torch.zeros(out["flag"].shape[1], dtype=I64,
                       device=out["flag"].device)


class Gaps:
    """The numbers compared for a Q configuration; every one is exact
    (limit 0):

    ecc_words_off    valid samples whose ecc word differs
    state_words_off  carried words (k, mean, var) that differ
    flags_off        flags that differ (and flags past a valid length)
    summary_off      per (call, channel), |host flag count - reference
                     count|, summed
    """

    band = 0.0

    def __init__(self, limits: dict):
        self.limits = limits
        self.v = {"ecc_words_off": 0, "state_words_off": 0,
                  "flags_off": 0, "summary_off": 0}

    def outputs(self, ecc, flag, out: dict):
        v = out["valid"]
        self.v["ecc_words_off"] += int(((ecc.to(I32) != out["ecc"])
                                        & v).sum())
        self.v["flags_off"] += int((flag.to(torch.bool) != out["flag"])
                                   .sum())

    def state(self, k, mean, var, st: dict):
        for got, name in ((k, "k"), (mean, "mean"), (var, "var")):
            self.v["state_words_off"] += int((got.to(I32) != st[name])
                                             .sum())

    def counts(self, got, want, allowed):
        self.v["summary_off"] += int((got.to(I64) - want.to(I64)).abs()
                                     .sum())

    def readings(self):
        return [(n, self.v[n], float(self.limits[n])) for n in self.v]


# ------------------------------------------------------------- control
def control_state0(n: int, device) -> dict:
    return state0(n, device)


def control_scan(x, st: dict, m: float, vlen=None, *, fmt):
    """The datapath with float32 dividers.  Returns ({"ecc",
    "outlier"}, state') in the program's domain."""
    f = Fmt(*fmt)
    out, new = _scan(f, x, st, msq1_of(f, m), vlen, _div_f32)
    return {"ecc": out["ecc"], "outlier": out["flag"]}, new


def control_to_program(st: dict):
    return st["k"], st["mean"], st["var"]
