"""Fused detector ensemble: the CUDA kernel's wrapper and its plain version.

`ensemble_scan_call` launches `csrc/ensemble_scan.cu` for CUDA tensors
and runs `ensemble_scan_plain`, the same arithmetic in plain PyTorch,
for CPU tensors.  The CUDA kernel replaces the JAX package's Pallas TPU
kernel `src/repro/kernels/ensemble_scan.py::ensemble_scan_kernel`: K
detectors x C channels in one pass over the packed `StateSpec` aux
block (`detectors/spec.py`), emitting a selection-gated int32 detector
bitmask, a float32 weighted vote in detector order and K float score
streams.

The plain version keeps the kernel's operation order, so on the card
the two agree bit for bit: the running sums advance row by row (no
block cumsum, which would sum in another order), the TEDA lane is
`teda_scan_plain`'s arithmetic, the hst lane is the row-recursive
oracle `detectors/hst.py` (exact small-integer arithmetic), and the
teda-q lane is `teda_q_scan_plain` — the reference kernel's schedule of
whole-block divider passes through `kernels/qdiv.py` around two slim
mean and var row loops — fed the float32-quantized m^2+1 constant.

On the card the kernel is bound by bytes at K = 5: 4 B in and
4 + 1 + 4K B out per sample, with the teda-q lane's six integer
dividers and the float lanes' IEEE divides per sample close behind.
With teda-q a block runs the integer lane in warps of its own beside
the float warps, handing its flags over through shared memory; without
it a block is the float warps alone.

Contract: x (T, C) float32; vlen (C,) int32 in [0, T]; k0, m, thr (C,)
float32; sel (K, C) float32; aux (spec.rows, C) float32 whose i32
regions hold int32 payloads bit for bit.  Returns (bits (T, C) int32,
vote (T, C) bool, fk (C,) float32, aux' (spec.rows, C) float32, scores
(K, T, C) float32).  Rows at or past vlen[c] advance nothing, flag
nothing and score 0.
"""
from __future__ import annotations

import torch

from repro_torch.detectors._common import valid_rows
from repro_torch.detectors.hst import HstState, hst_scan
from repro_torch.detectors.spec import (HST_LEAVES, MEMBERS, MOMENT_MEMBERS,
                                        check_detectors, check_fmt,
                                        ensemble_spec)
from repro_torch.detectors.teda_q import member_msq1
from repro_torch.fixedpoint.qformat import QFormat
from repro_torch.kernels import _build
from repro_torch.kernels.teda_q_scan import teda_q_scan_plain

__all__ = ["ensemble_scan_call", "ensemble_scan_plain", "launches"]

launches = 0  # kernel launches made by `ensemble_scan_call`

_F32, _I32 = torch.float32, torch.int32


def _moment_lanes(x, valid, k, m, aux, aux_out, detectors, w):
    """The shared moment fabric and the teda / rde / zscore lanes.
    Returns ({name: flags}, {name: scores}) and writes the fabric rows
    of `aux_out` that the members own."""
    t_len, c = x.shape
    need_s2 = "rde" in detectors or "zscore" in detectors
    m2 = m * m
    # running sums, one row at a time in the kernel's order
    s, s2 = aux[w - 1].clone(), aux[2 * w - 1].clone()
    s_rows = torch.empty((t_len, c), dtype=_F32, device=x.device)
    s2_rows = torch.empty_like(s_rows) if need_s2 else None
    for r in range(t_len):
        v, xr = valid[r], x[r]
        s = torch.where(v, s + xr, s)
        s_rows[r] = s
        if need_s2:
            s2 = torch.where(v, s2 + xr * xr, s2)
            s2_rows[r] = s2
    mean = s_rows / k
    dr = (x - mean) * (x - mean)
    flags, scores = {}, {}

    if "teda" in detectors:  # eqs (1)-(6), as `teda_scan_plain`
        first = k <= 1.0
        d2 = torch.where(first | ~valid, 0.0, dr)
        a = torch.where(valid, torch.where(first, 0.0, (k - 1.0) / k), 1.0)
        b = d2 / k
        var = aux[2 * w].clone()
        var_rows = torch.empty_like(s_rows)
        for r in range(t_len):
            var = a[r] * var + b[r]
            var_rows[r] = var
        safe = var_rows > 0.0
        ecc = 1.0 / k + torch.where(safe, d2 / (k * var_rows), 0.0)
        flags["teda"] = (ecc * 0.5 > (m2 + 1.0) / (2.0 * k)) & (k >= 2.0)
        scores["teda"] = ecc
        aux_out[2 * w] = var

    if "rde" in detectors:  # biased variance from the running moments
        varb = s2_rows / k - mean * mean
        ok = varb > 0.0
        flags["rde"] = ok & (k >= 2.0) & (dr > m2 * varb)
        scores["rde"] = 1.0 / (1.0 + torch.where(
            ok, dr / torch.where(ok, varb, 1.0), 0.0))

    if "zscore" in detectors:
        # window sums against the prefix sum W rows back: row r's lag is
        # s_full[r] (the carried tail first, then this call's rows)
        s_full = torch.cat([aux[0:w], s_rows])
        s2_full = torch.cat([aux[w:2 * w], s2_rows])
        n = k.clamp_max(float(w))
        muw = (s_rows - s_full[:t_len]) / n
        sigw = (s2_rows - s2_full[:t_len]) / n - muw * muw
        dz = (x - muw) * (x - muw)
        ok = sigw > 0.0
        flags["zscore"] = ok & (k >= 2.0) & (dz > m2 * sigw)
        scores["zscore"] = torch.where(ok, dz / torch.where(ok, sigw, 1.0),
                                       0.0)
        # the tails advance to each channel's valid extent: new row j is
        # s_full[n_valid + j]
        n_valid = valid.sum(0)
        idx = n_valid[None, :] + torch.arange(w, device=x.device)[:, None]
        aux_out[0:w] = s_full.gather(0, idx)
        aux_out[w:2 * w] = s2_full.gather(0, idx)
    else:
        aux_out[w - 1] = s
        if need_s2:
            aux_out[2 * w - 1] = s2
    return flags, scores


def ensemble_scan_plain(x, vlen, k0, m, thr, sel, aux, *, detectors,
                        window: int, fmt: QFormat = None):
    """The kernel's arithmetic in plain PyTorch, vectorized over
    channels, in the kernel's operation order."""
    detectors = tuple(detectors)
    t_len, c = x.shape
    dev = x.device
    w = int(window)
    spec = ensemble_spec(detectors, w)
    aux_out = aux.clone()
    rows = torch.arange(t_len, dtype=_F32, device=dev)[:, None]
    valid = valid_rows(vlen, t_len, c, dev)
    k = (k0[None, :] + rows) + 1.0

    flags, scores = {}, {}
    if any(d in MOMENT_MEMBERS for d in detectors):
        flags, scores = _moment_lanes(x, valid, k, m, aux, aux_out,
                                      detectors, w)
    if "hst" in detectors:
        sl = spec.slc("hst:ref").start
        ref, cur = aux[sl:sl + HST_LEAVES], aux[sl + HST_LEAVES:
                                                sl + 2 * HST_LEAVES]
        fin, out = hst_scan(x, m, HstState(ref, cur, aux[sl + 2 *
                                                         HST_LEAVES]),
                            window=w, valid_lens=vlen)
        aux_out[sl:sl + HST_LEAVES] = fin.ref
        aux_out[sl + HST_LEAVES:sl + 2 * HST_LEAVES] = fin.cur
        aux_out[sl + 2 * HST_LEAVES] = fin.phase
        flags["hst"], scores["hst"] = out["outlier"], out["score"]
    if "teda-q" in detectors:
        qa = aux_out.view(_I32)
        om, ov = spec.offset("teda-q:mean"), spec.offset("teda-q:var")
        _, _, ecc, outl, _, qmean, qvar = teda_q_scan_plain(
            fmt.quantize(x), member_msq1(fmt, m), vlen, k0.to(_I32),
            qa[om], qa[ov], fmt=fmt)
        qa[om], qa[ov] = qmean, qvar
        flags["teda-q"] = outl
        scores["teda-q"] = fmt.dequantize(ecc)

    # selection-gated bitmask, weighted vote in detector order, scores
    bits = torch.zeros((t_len, c), dtype=_I32, device=dev)
    votew = torch.zeros((t_len, c), dtype=_F32, device=dev)
    totw = torch.zeros(c, dtype=_F32, device=dev)
    score_out = torch.empty((len(detectors), t_len, c), dtype=_F32,
                            device=dev)
    for d, name in enumerate(detectors):
        wrow = sel[d]
        f = flags[name] & (wrow > 0.0)[None, :] & valid
        bits = bits | (f.to(_I32) << d)
        votew = votew + f.to(_F32) * wrow[None, :]
        totw = totw + wrow
        score_out[d] = torch.where(valid, scores[name], 0.0)
    vote = (votew >= thr[None, :]) & (totw > 0.0)[None, :] & valid
    fk = k0 + vlen.to(_F32)
    return bits, vote, fk, aux_out, score_out


def _launch(x, vlen, k0, m, thr, sel, aux, detectors, window, fmt):
    global launches
    t_len, c = x.shape
    dev = x.device
    n_det = len(detectors)
    bits = torch.empty((t_len, c), dtype=_I32, device=dev)
    vote = torch.empty((t_len, c), dtype=torch.bool, device=dev)
    fk = torch.empty(c, dtype=_F32, device=dev)
    aux_out = torch.empty_like(aux)
    scores = torch.empty((n_det, t_len, c), dtype=_F32, device=dev)
    if c == 0:
        return bits, vote, fk, aux_out, scores
    spec = ensemble_spec(detectors, window)
    types = [MEMBERS.index(d) for d in detectors] + [-1] * (5 - n_det)
    hst_off = spec.offset("hst:ref") if "hst" in detectors else -1
    tq_off = spec.offset("teda-q:mean") if "teda-q" in detectors else -1
    q = fmt if fmt is not None else QFormat(32, 16)
    err = _build.library().ensemble_scan_f32(
        x.data_ptr(), vlen.data_ptr(), k0.data_ptr(), m.data_ptr(),
        thr.data_ptr(), sel.data_ptr(), aux.data_ptr(), bits.data_ptr(),
        vote.data_ptr(), fk.data_ptr(), aux_out.data_ptr(),
        scores.data_ptr(), t_len, c, n_det, window, spec.rows, *types,
        hst_off, tq_off, q.word_len, q.frac_len, int(q.rounding == "round"),
        dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ensemble_scan_f32")
    launches += 1
    return bits, vote, fk, aux_out, scores


def ensemble_scan_call(x, vlen, k0, m, thr, sel, aux, *, detectors,
                       window: int, fmt: QFormat = None):
    """Run the fused ensemble: the CUDA kernel on CUDA tensors, the
    plain version on CPU tensors.  The rows are moved to x's device,
    cast to the contract's dtypes (aux keeps its bits: an int32 tensor
    is viewed, never converted) and made contiguous; vlen is clamped to
    [0, T]."""
    detectors = check_detectors(detectors)
    fmt = check_fmt(detectors, fmt)
    dev, window = x.device, int(window)
    t_len, c = x.shape

    def f32(v):
        return v.to(device=dev, dtype=_F32).contiguous()

    if aux.dtype == _I32:
        aux = aux.view(_F32)
    vlen = vlen.to(device=dev, dtype=_I32).clamp(0, t_len).contiguous()
    args = (f32(x), vlen, f32(k0),
            f32(m), f32(thr), f32(sel), aux.to(device=dev).contiguous())
    rows = ensemble_spec(detectors, window).rows
    if x.ndim != 2 or any(a.shape != (c,) for a in args[1:5]) \
            or args[5].shape != (len(detectors), c) \
            or args[6].shape != (rows, c) or args[6].dtype != _F32:
        raise ValueError(
            f"x must be (T, C), vlen/k0/m/thr ({c},), sel "
            f"({len(detectors)}, {c}) and aux ({rows}, {c}) float32")
    if dev.type == "cuda":
        return _launch(*args, detectors, window, fmt)
    if dev.type == "cpu":
        return ensemble_scan_plain(*args, detectors=detectors,
                                   window=window, fmt=fmt)
    raise ValueError(f"ensemble_scan: unsupported device {dev}")
