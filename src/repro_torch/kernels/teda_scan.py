"""Float TEDA scan: the CUDA kernel's wrapper and its plain version.

`teda_scan_call` launches `csrc/teda_scan.cu` for CUDA tensors and runs
`teda_scan_plain`, the same arithmetic in plain PyTorch, for CPU
tensors.  The CUDA kernel replaces the JAX package's Pallas TPU kernel
`src/repro/kernels/teda_scan.py::teda_scan_kernel`.

On the card the kernel is bound by bytes: the verdict contract moves
4 B in and 5 B out per sample (ecc f32, flag u8), the full contract 4 B
in and 13 B out.  It runs one thread per channel, walking the rows in
order with the running sum and variance in registers, and stages x
through shared memory in tiles of `STAGE_ROWS` rows x 128 channels,
several tiles in flight per block (cp.async).  At small C one thread
per channel under-fills the card (C = 65,536 is about 496 threads per
SM of 132); time-parallel designs are later work.

Contract: x (T, C) float32; m, k0, sum0, var0 (C,) float32; vlen (C,)
int32 in [0, T].  Rows at or past vlen[c] leave channel c's carries
untouched and never flag.  Returns (mean, var, ecc, outlier, fk, fsum,
fvar) with mean/var None in the verdict contract; outlier is bool.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

__all__ = ["teda_scan_call", "teda_scan_plain", "launches", "STAGE_ROWS"]

launches = 0  # kernel launches made by `teda_scan_call`
STAGE_ROWS = 32  # rows per staged tile: kRows in csrc/teda_scan.cu


def _rows(t_len, c, dtype, device, full=True):
    """An uninitialized (T, C) output, or None when `full` is false."""
    return (torch.empty((t_len, c), dtype=dtype, device=device) if full
            else None)


def teda_scan_plain(x, m, vlen, k0, sum0, var0, *, full: bool = False):
    """The kernel's arithmetic in plain PyTorch: one loop step per row,
    vectorized over channels, rounding where the kernel rounds."""
    t_len, c = x.shape
    s, var = sum0.clone(), var0.clone()
    msq1 = m * m + 1.0
    ecc = _rows(t_len, c, torch.float32, x.device)
    outlier = _rows(t_len, c, torch.bool, x.device)
    mean_rows = _rows(t_len, c, torch.float32, x.device, full)
    var_rows = _rows(t_len, c, torch.float32, x.device, full)
    for t in range(t_len):
        xv = x[t]
        valid = t < vlen
        k = k0 + float(t) + 1.0
        s = torch.where(valid, s + xv, s)
        mean = s / k
        first = k <= 1.0
        d2 = torch.where(first | ~valid, 0.0, (xv - mean) * (xv - mean))
        a = torch.where(valid, torch.where(first, 0.0, (k - 1.0) / k), 1.0)
        var = a * var + d2 / k
        safe = var > 0.0
        e = 1.0 / k + torch.where(safe, d2 / (k * var), 0.0)
        ecc[t] = e
        outlier[t] = valid & (e * 0.5 > msq1 / (2.0 * k)) & (k >= 2.0)
        if full:
            mean_rows[t] = mean
            var_rows[t] = var
    fk = k0 + vlen.to(torch.float32)
    return mean_rows, var_rows, ecc, outlier, fk, s, var


def _ptr(v):
    return None if v is None else v.data_ptr()


def _launch(x, m, vlen, k0, sum0, var0, full):
    global launches
    t_len, c = x.shape
    dev = x.device
    ecc = _rows(t_len, c, torch.float32, dev)
    outlier = _rows(t_len, c, torch.bool, dev)
    mean = _rows(t_len, c, torch.float32, dev, full)
    var = _rows(t_len, c, torch.float32, dev, full)
    fk, fsum, fvar = (torch.empty(c, dtype=torch.float32, device=dev)
                      for _ in range(3))
    if c == 0:
        return mean, var, ecc, outlier, fk, fsum, fvar
    err = _build.library().teda_scan_f32(
        _ptr(x), _ptr(m), _ptr(vlen), _ptr(k0), _ptr(sum0), _ptr(var0),
        _ptr(mean), _ptr(var), _ptr(ecc), _ptr(outlier), _ptr(fk),
        _ptr(fsum), _ptr(fvar), t_len, c, int(full), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "teda_scan_f32")
    launches += 1
    return mean, var, ecc, outlier, fk, fsum, fvar


def teda_scan_call(x, m, vlen, k0, sum0, var0, *, full: bool = False):
    """Run the float TEDA scan: the CUDA kernel on CUDA tensors, the
    plain version on CPU tensors.  The rows are moved to x's device,
    cast to the contract's dtypes and made contiguous."""
    dev, c = x.device, x.shape[1]

    def f32(v):
        return v.to(device=dev, dtype=torch.float32).contiguous()

    args = (f32(x), f32(m), vlen.to(device=dev, dtype=torch.int32)
            .contiguous(), f32(k0), f32(sum0), f32(var0))
    if x.ndim != 2 or any(a.shape != (c,) for a in args[1:]):
        raise ValueError(f"x must be (T, C) and each row ({c},)")
    if dev.type == "cuda":
        return _launch(*args, full)
    if dev.type == "cpu":
        return teda_scan_plain(*args, full=full)
    raise ValueError(f"teda_scan: unsupported device {dev}")
