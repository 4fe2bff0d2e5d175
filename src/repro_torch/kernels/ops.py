"""Public wrappers around the TEDA kernels: one contract layer for the
four entry points (full and verdict-only, float and Q-format).

`state_vectors` normalizes carried state to per-channel (C,) vectors —
a per-channel `k` is kept end to end, never collapsed to a scalar.  The
float carry crosses the kernel as a running *sum* (`mean0 * k0` in,
`fsum / max(fk, 1)` out), which is what makes chunked runs equal full
ones.

`m` may be a scalar or a per-channel (C,) vector; either way the kernels
take it as a (C,) row and evaluate eq (6) per channel, with the same
arithmetic the reference applies outside its kernel for a vector `m`
(`fast_div_qi`, bit-equal to `div_qi`, on the Q path).

`valid_lens` may be None (every row valid), a scalar or a (C,) vector
of leading valid row counts, clamped to [0, T]: channel c's state
freezes after its own vlen[c] rows and no flag appears beyond them.
Per-sample outputs at rows >= vlen[c] are otherwise unspecified.

`block_t`, `block_c` and `lane_pad` are accepted for the reference's
signatures; the CUDA kernels take unpadded (T, C) tensors and mask the
edges themselves, so results never depend on them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.teda import TedaState
from repro_torch.fixedpoint.qformat import QFormat
from repro_torch.fixedpoint.teda_q import msq1_const
from repro_torch.kernels.qdiv import fast_div_qi
from repro_torch.kernels.ragged import norm_block_c, vlen_vec
from repro_torch.kernels.teda_q_scan import teda_q_scan_call
from repro_torch.kernels.teda_scan import teda_scan_call

__all__ = ["teda_scan_full", "teda_scan_verdict", "teda_q_scan_full",
           "teda_q_scan_verdict", "state_vectors"]


def state_vectors(state: Optional[TedaState], c: int, dtype, device
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Normalize carried state to per-channel (k, mean, var) (C,) vectors.

    `k` may be a scalar or a per-channel vector, `mean` (C,), (C, 1) or
    scalar, and `var` likewise.
    """
    if state is None:
        z = torch.zeros(c, dtype=dtype, device=device)
        return z, z, z

    def vec(v):
        v = torch.as_tensor(v, device=device).to(dtype).reshape(-1)
        return v.expand(c) if v.numel() == 1 else v.reshape(c)

    return vec(state.k), vec(state.mean), vec(state.var)


def _row(v, c: int, dtype, device) -> torch.Tensor:
    """A scalar or (C,) per-channel value as a (C,) row on `device`; a
    host scalar is filled in on the device, with no host-to-device
    copy."""
    v = torch.as_tensor(v)
    if v.numel() == 1 and v.device.type == "cpu":
        return torch.full((c,), v.item(), dtype=dtype, device=device)
    return v.to(device=device, dtype=dtype).expand(c)


def _k_rows(k0, t_len):
    """Global iteration index of every row: k0 + 1 .. k0 + T, (T, C)."""
    return k0[None, :] + torch.arange(1, t_len + 1, dtype=k0.dtype,
                                      device=k0.device)[:, None]


def _float_call(x, m, state, valid_lens, block_c, full):
    x = torch.as_tensor(x)
    norm_block_c(block_c)
    t_len, c = x.shape
    dev = x.device
    k0, mean0, var0 = state_vectors(state, c, torch.float32, dev)
    vlen, _ = vlen_vec(valid_lens, t_len, c, torch.int32, dev)
    m_row = _row(m, c, torch.float32, dev)
    mean, var, ecc, outlier, fk, fsum, fvar = teda_scan_call(
        x, m_row, vlen, k0, mean0 * k0, var0, full=full)
    final = TedaState(k=fk, mean=(fsum / fk.clamp_min(1.0))[:, None],
                      var=fvar)
    return final, m_row, k0, mean, var, ecc, outlier


def teda_scan_verdict(x, m=3.0, state: Optional[TedaState] = None, *,
                      valid_lens=None, block_t: int = 256,
                      block_c: Optional[int] = None, lane_pad: int = 128
                      ) -> Tuple[TedaState, dict]:
    """Slim-output float TEDA: (final state, {ecc, outlier}).

    9 B of device traffic per sample (x in, ecc and the flag out) — the
    engine's float hot path.  x is (T, C): C independent univariate
    streams.
    """
    final, *_, ecc, outlier = _float_call(x, m, state, valid_lens,
                                          block_c, full=False)
    return final, {"ecc": ecc, "outlier": outlier}


def teda_scan_full(x, m=3.0, state: Optional[TedaState] = None, *,
                   valid_lens=None, block_t: int = 256,
                   block_c: Optional[int] = None, lane_pad: int = 128
                   ) -> Tuple[TedaState, dict]:
    """Float TEDA over x (T, C) with the whole trajectory.

    Returns (final TedaState with k (C,) / mean (C, 1) / var (C,),
    dict of (T, C) tensors: mean, var, ecc, zeta, threshold, outlier).
    """
    final, m_row, k0, mean, var, ecc, outlier = _float_call(
        x, m, state, valid_lens, block_c, full=True)
    thr = (m_row ** 2 + 1.0) / (2.0 * _k_rows(k0, ecc.shape[0]))
    outs = {"mean": mean, "var": var, "ecc": ecc, "zeta": ecc * 0.5,
            "threshold": thr, "outlier": outlier}
    return final, outs


def _quantize_in(x, fmt: QFormat) -> torch.Tensor:
    """Float input goes through the format's quantizer; integer input is
    taken as already-quantized Q values."""
    x = torch.as_tensor(x)
    return fmt.quantize(x) if torch.is_floating_point(x) \
        else x.to(torch.int32)


def _q_call(x, fmt, m, state, valid_lens, block_c, full):
    fmt.validate()
    norm_block_c(block_c)
    xq = _quantize_in(x, fmt)
    t_len, c = xq.shape
    dev = xq.device
    k0, mean0, var0 = state_vectors(state, c, torch.int32, dev)
    vlen, _ = vlen_vec(valid_lens, t_len, c, torch.int32, dev)
    msq1 = _row(msq1_const(fmt, m), c, torch.int32, dev)
    mean, var, ecc, outlier, fk, fmean, fvar = teda_q_scan_call(
        xq, msq1, vlen, k0, mean0, var0, fmt=fmt, full=full)
    final = TedaState(k=fk, mean=fmean[:, None], var=fvar)
    return final, msq1, k0, mean, var, ecc, outlier


def teda_q_scan_verdict(x, fmt: QFormat, m=3.0,
                        state: Optional[TedaState] = None, *,
                        valid_lens=None, block_t: int = 256,
                        block_c: Optional[int] = None,
                        lane_pad: int = 128) -> Tuple[TedaState, dict]:
    """Slim-output Q-format TEDA: (final state, {ecc, outlier}).

    Bit-exact with `teda_q_scan_full` and with the `teda_q_scan_chan`
    oracle; the engine's Q hot path.  `ecc` is Q int32.
    """
    final, *_, ecc, outlier = _q_call(x, fmt, m, state, valid_lens,
                                      block_c, full=False)
    return final, {"ecc": ecc, "outlier": outlier}


def teda_q_scan_full(x, fmt: QFormat, m=3.0,
                     state: Optional[TedaState] = None, *,
                     valid_lens=None, block_t: int = 256,
                     block_c: Optional[int] = None,
                     lane_pad: int = 128) -> Tuple[TedaState, dict]:
    """Bit-accurate Q-format TEDA over x (T, C) with the trajectory.

    Float input is quantized through `fmt`; int32 input is taken as Q.
    Returns (TedaState with k (C,) int32, Q int32 mean (C, 1) / var
    (C,), dict of (T, C) tensors: mean, var, ecc, zeta, threshold — Q
    int32 — and bool outlier).
    """
    final, msq1, k0, mean, var, ecc, outlier = _q_call(
        x, fmt, m, state, valid_lens, block_c, full=True)
    k_all = _k_rows(k0, ecc.shape[0])
    thr = fast_div_qi(fmt, msq1[None, :], 2 * k_all)
    outs = {"mean": mean, "var": var, "ecc": ecc, "zeta": ecc >> 1,
            "threshold": thr, "outlier": outlier}
    return final, outs
