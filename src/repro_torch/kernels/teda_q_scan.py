"""Q-format TEDA scan: the CUDA kernel's wrapper and its plain version.

`teda_q_scan_call` launches `csrc/teda_q_scan.cu` for CUDA tensors and
runs `teda_q_scan_plain` for CPU tensors.  The CUDA kernel replaces the
JAX package's Pallas TPU kernel
`src/repro/kernels/teda_q_scan.py::teda_q_scan_kernel`, bit for bit.

The plain version keeps the reference kernel's structure, in int64:
whole-block divider passes (rk = (k-1)/k, 1/k, thr = msq1/2k, x/k,
d2/k, d2/var, ratio/k through `kernels/qdiv.py`) around two sequential
row loops, one saturating multiply-add per row for the mean and for the
variance.  The CUDA kernel runs the same passes on register tiles of
rows, one thread per channel (`q_teda_tile` in `csrc/qformat.cuh`).

On the card the kernel is bound by integer operations: six dividers
per sample (a float64 reciprocal estimate and one exact correction
step each, `q_recip_div_mag`), beside 9 B of traffic per sample in the
verdict contract.  It walks each channel in tiles of rows, with the
dividers of a tile off the two carried multiply-add chains.  One
thread per channel under-fills the card at small C; time-parallel
designs are later work.

Contract: x (T, C) int32 Q; msq1, k0, mean0, var0 (C,) int32; vlen
(C,) int32, clamped to [0, T] by `teda_q_scan_call`.  Rows at or past
vlen[c] leave channel c's carries untouched and never flag.  Returns
(mean, var, ecc, outlier, fk, fmean, fvar) with mean/var None in the
verdict contract; outlier is bool.
"""
from __future__ import annotations

import torch

from repro_torch.fixedpoint.qformat import QFormat, sat_add, sat_mul, sat_sub
from repro_torch.kernels import _build
from repro_torch.kernels.qdiv import fast_div_qi, fast_div_qq

__all__ = ["teda_q_scan_call", "teda_q_scan_plain", "launches"]

launches = 0  # kernel launches made by `teda_q_scan_call`

_I32, _I64 = torch.int32, torch.int64


def teda_q_scan_plain(x, msq1, vlen, k0, mean0, var0, *, fmt: QFormat,
                      full: bool = False):
    """The reference kernel's structure in plain PyTorch (int64)."""
    t_len, c = x.shape
    dev = x.device
    rows = torch.arange(t_len, dtype=_I64, device=dev)[:, None]
    kv = k0.to(_I64)[None, :] + rows + 1           # (T, C) counter
    valid = rows < vlen.to(_I64)[None, :]
    x64 = x.to(_I64)

    # the data-independent dividers, one whole-block pass each
    rk = fast_div_qq(fmt, kv - 1, kv)
    inv = fast_div_qi(fmt, fmt.one, kv)
    thr = fast_div_qi(fmt, msq1[None, :], 2 * kv)
    xk = fast_div_qi(fmt, x64, kv)

    # MEAN recurrence, eq (2): mu = rk * mu + x/k; the k = 1 override is
    # the multiply-add itself (rk = 0 and x/1 = x there)
    mean_b = torch.empty((t_len, c), dtype=_I32, device=dev)
    mean = mean0.to(_I32)
    for r in range(t_len):
        mean_n = sat_add(fmt, sat_mul(fmt, rk[r], mean), xk[r])
        mean_b[r] = mean_n
        mean = torch.where(valid[r], mean_n, mean)

    # VARIANCE divider d2/k (0 at k = 1) from the banked mean rows
    d = sat_sub(fmt, x64, mean_b)
    d2 = sat_mul(fmt, d, d)
    e = torch.where(kv <= 1, 0, fast_div_qi(fmt, d2, kv))

    # VARIANCE recurrence: var = rk * var + d2/k
    var_b = torch.empty((t_len, c), dtype=_I32, device=dev)
    var = var0.to(_I32)
    for r in range(t_len):
        var_n = sat_add(fmt, sat_mul(fmt, rk[r], var), e[r])
        var_b[r] = var_n
        var = torch.where(valid[r], var_n, var)

    # ECCENTRICITY + OUTLIER, eqs (1)(5)(6), from the banked rows
    safe = var_b > 0
    ratio = fast_div_qq(fmt, d2, torch.where(safe, var_b, 1))
    ecc = sat_add(fmt, inv, torch.where(safe, fast_div_qi(fmt, ratio, kv),
                                        0))
    outlier = ((ecc >> 1) > thr) & (kv >= 2) & valid
    fk = k0.to(_I32) + vlen.to(_I32)
    if not full:
        mean_b = var_b = None
    return mean_b, var_b, ecc, outlier, fk, mean, var


def _launch(x, msq1, vlen, k0, mean0, var0, fmt, full):
    global launches
    t_len, c = x.shape
    dev = x.device

    def rows(dtype=_I32):
        return torch.empty((t_len, c), dtype=dtype, device=dev)

    ecc, outlier = rows(), rows(torch.bool)
    mean, var = (rows(), rows()) if full else (None, None)
    fk, fmean, fvar = (torch.empty(c, dtype=_I32, device=dev)
                       for _ in range(3))
    if c == 0:
        return mean, var, ecc, outlier, fk, fmean, fvar

    def ptr(v):
        return None if v is None else v.data_ptr()

    err = _build.library().teda_q_scan_i32(
        ptr(x), ptr(msq1), ptr(vlen), ptr(k0), ptr(mean0), ptr(var0),
        ptr(mean), ptr(var), ptr(ecc), ptr(outlier), ptr(fk), ptr(fmean),
        ptr(fvar), t_len, c, fmt.word_len, fmt.frac_len,
        int(fmt.rounding == "round"), int(full), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "teda_q_scan_i32")
    launches += 1
    return mean, var, ecc, outlier, fk, fmean, fvar


def teda_q_scan_call(x, msq1, vlen, k0, mean0, var0, *, fmt: QFormat,
                     full: bool = False):
    """Run the Q TEDA scan: the CUDA kernel on CUDA tensors, the plain
    version on CPU tensors.  The rows are moved to x's device, cast to
    int32 and made contiguous; vlen is clamped to [0, T]."""
    fmt.validate()
    dev, (t_len, c) = x.device, x.shape

    def i32(v):
        return v.to(device=dev, dtype=_I32).contiguous()

    vlen = i32(vlen).clamp(0, t_len)
    args = tuple(i32(v) for v in (x, msq1, vlen, k0, mean0, var0))
    if x.ndim != 2 or any(a.shape != (c,) for a in args[1:]):
        raise ValueError(f"x must be (T, C) and each row ({c},)")
    if dev.type == "cuda":
        return _launch(*args, fmt, full)
    if dev.type == "cpu":
        return teda_q_scan_plain(*args, fmt=fmt, full=full)
    raise ValueError(f"teda_q_scan: unsupported device {dev}")
