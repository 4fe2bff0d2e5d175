"""TEDA-Q ensemble member: the bit-accurate Q-format path as a voter.

A row loop over exactly the `_q_step_u` the Q kernels execute, with a
per-channel prefix freeze (the engine's ragged contract) and the
detector contract `(state', {"outlier", "score"})`; the score is the
dequantized eccentricity.  In the fused kernel the member owns the
opaque `teda-q:mean` / `teda-q:var` aux regions (int32 payloads held bit
for bit in the f32 block); this oracle is the bit-exactness target of
that lane.

The m^2+1 ROM constant is quantized through the format's float32
quantizer from the per-channel f32 `m` (`member_msq1`), as the kernel
derives it — not in float64 as `fixedpoint.teda_q.msq1_const` does:
from m = 4 up the two can differ in the last bit.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.detectors._common import stack_rows
from repro_torch.fixedpoint.qformat import QFormat
from repro_torch.fixedpoint.teda_q import _q_counter_terms, _q_step_u
from repro_torch.kernels.ops import _row
from repro_torch.kernels.ragged import vlen_vec

__all__ = ["TedaQMemberState", "teda_q_member_init", "teda_q_member_scan",
           "member_msq1"]

_I32 = torch.int32


class TedaQMemberState(NamedTuple):
    """Per-channel carried Q registers: `k` (C,) int32 sample count,
    `mean` / `var` (C,) int32 Q-values."""

    k: torch.Tensor
    mean: torch.Tensor
    var: torch.Tensor


def teda_q_member_init(c: int, device=None) -> TedaQMemberState:
    def z():
        return torch.zeros(c, dtype=_I32, device=device)

    return TedaQMemberState(k=z(), mean=z(), var=z())


def member_msq1(fmt: QFormat, m) -> torch.Tensor:
    """The OUTLIER ROM constant as the fused kernel derives it: float32
    quantization of m^2 + 1 from the f32 m."""
    mf = torch.as_tensor(m).to(torch.float32)
    return fmt.quantize(mf * mf + 1.0)


def teda_q_member_scan(x, fmt: QFormat, m=3.0,
                       state: Optional[TedaQMemberState] = None, *,
                       valid_lens=None) -> Tuple[TedaQMemberState, dict]:
    """Q-format TEDA over x (T, C) with the engine's ragged contract.

    Returns (final TedaQMemberState, {"outlier": (T, C) bool, "score":
    (T, C) f32 dequantized eccentricity, "ecc": (T, C) raw Q int32}).
    Float input is quantized through `fmt`; int32 input is taken as
    already-quantized Q values.  `valid_lens` freezes each channel's Q
    registers after its own leading prefix; flags and scores are zero
    beyond it.
    """
    fmt.validate()
    x = torch.as_tensor(x)
    xq = fmt.quantize(x) if torch.is_floating_point(x) else x.to(_I32)
    t_len, c = xq.shape
    dev = xq.device
    if state is None:
        state = teda_q_member_init(c, dev)
    msq1 = member_msq1(fmt, _row(m, c, torch.float32, dev))
    vl, _ = vlen_vec(valid_lens, t_len, c, _I32, dev)
    rows = torch.arange(t_len, dtype=_I32, device=dev)
    valid = rows[:, None] < vl[None, :]

    # the counter-only dividers for every instant before the loop: row t
    # of a channel is instant k0 + t + 1 (past the valid prefix the
    # frozen carry masks every output anyway)
    ks = state.k.to(_I32)[None, :] + (rows + 1)[:, None]
    terms = _q_counter_terms(fmt, ks, msq1)
    mean, var = state.mean.to(_I32), state.var.to(_I32)
    flags, scores, eccs = [], [], []
    for t in range(t_len):
        v = valid[t]
        mean_n, var_n, ecc, _zeta, _thr, outl = _q_step_u(
            fmt, ks[t], mean, var, xq[t], msq1,
            terms=tuple(term[t] for term in terms))
        flags.append(outl.expand(c) & v)
        scores.append(torch.where(v, fmt.dequantize(ecc), 0.0))
        eccs.append(torch.where(v, ecc, 0))
        mean = torch.where(v, mean_n, mean)
        var = torch.where(v, var_n, var)
    final = TedaQMemberState(k=state.k.to(_I32) + vl, mean=mean, var=var)
    return final, {"outlier": stack_rows(flags, t_len, c, torch.bool, dev),
                   "score": stack_rows(scores, t_len, c, torch.float32,
                                       dev),
                   "ecc": stack_rows(eccs, t_len, c, _I32, dev)}
