"""Public wrapper around the fused ensemble kernel, and its oracle.

`ensemble_scan` is the contract layer (`kernels/ops.py`'s role for the
TEDA kernels): it normalizes carried state to the packed
`EnsembleState(k, aux)` layout — the `StateSpec` of `detectors/spec.py`
— defaults the per-channel selection weights and vote threshold, and
returns per-sample detector bitmasks, fused votes and per-detector
score streams beside the advanced state.  The CUDA kernel masks its
own ragged edges, so there is no padding here; `block_t`, `block_c` and
`lane_pad` are the reference's grid arguments, accepted and without
effect on the results.

`ensemble_ref` is the conformance target: it composes the per-detector
row-recursive oracles and fuses their flags with the kernel's float32
detector-order vote.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.detectors import (DEFAULT_DETECTORS, DEFAULT_WINDOW,
                                   DETECTORS, ensemble_spec)
from repro_torch.detectors._common import valid_rows
from repro_torch.detectors.hst import hst_init, hst_scan
from repro_torch.detectors.spec import check_detectors, check_fmt
from repro_torch.detectors.teda_q import teda_q_member_scan
from repro_torch.detectors.zscore import zscore_init, zscore_scan
from repro_torch.kernels.ensemble_scan import ensemble_scan_call
from repro_torch.kernels.ops import _row
from repro_torch.kernels.ragged import norm_block_c, vlen_vec

__all__ = ["EnsembleState", "ensemble_init", "ensemble_scan",
           "ensemble_ref"]


class EnsembleState(NamedTuple):
    """Packed shared state of the fused ensemble over C channels.

    k:   (C,) float32 samples absorbed per channel (shared by every
         member).
    aux: (spec.rows, C) float32 — the `ensemble_spec(detectors, window)`
         block: the moment fabric in rows [0, 2W], then each non-moment
         member's opaque regions in detector order.
    """

    k: torch.Tensor
    aux: torch.Tensor


def ensemble_init(c: int, window: int = DEFAULT_WINDOW,
                  dtype=torch.float32, detectors=DEFAULT_DETECTORS,
                  device=None) -> EnsembleState:
    spec = ensemble_spec(detectors, window)
    return EnsembleState(k=torch.zeros(c, dtype=dtype, device=device),
                         aux=spec.init_aux(c, dtype, device))


def _sel_thr(sel, thr, n_det: int, c: int, device):
    """Normalize selection weights to (K, C) and the vote threshold to
    (C,) on `device`; `thr=None` is majority of the selected weight."""
    if sel is None:
        sel = torch.ones((n_det, c), dtype=torch.float32, device=device)
    else:
        sel = (sel.to(device=device, dtype=torch.float32)
               if isinstance(sel, torch.Tensor) else
               torch.tensor(np.asarray(sel, np.float32), device=device))
        sel = sel[:, None] if sel.ndim == 1 else sel
        sel = sel.expand(n_det, c)
    if thr is None:
        thr = sel.sum(0) / 2.0  # majority (ties flag)
    else:
        thr = _row(thr, c, torch.float32, device)
    return sel, thr


def ensemble_scan(x, m=3.0, state: Optional[EnsembleState] = None, *,
                  detectors=DEFAULT_DETECTORS,
                  window: int = DEFAULT_WINDOW, sel=None, thr=None,
                  fmt=None, valid_lens=None, block_t: int = 256,
                  block_c: Optional[int] = None,
                  lane_pad: int = 128) -> Tuple[EnsembleState, dict]:
    """Fused K-detector ensemble over x (T, C) channel streams.

    Returns (final EnsembleState, {"det_flags": (T, C) int32 bitmask —
    bit d set iff detectors[d] flagged the sample on a channel where it
    is selected, "vote": (T, C) bool fused verdict, "scores": (K, T, C)
    float32 per-detector score streams, zero beyond a channel's valid
    prefix and not selection-gated}).  `m` is a scalar or per-channel
    (C,) sensitivity shared by every member; `sel` the (K,) or (K, C)
    selection weights (0 = unselected; None = all at unit weight);
    `thr` the per-channel vote threshold (None: majority of the
    selected weight); `fmt` the QFormat of the "teda-q" member
    (required iff present).  `valid_lens` is the per-channel ragged
    prefix.  Runs on x's device: the CUDA kernel for a CUDA tensor, its
    plain version for a CPU tensor (numpy input lands on the CPU).
    """
    detectors = check_detectors(detectors)
    norm_block_c(block_c)
    x = torch.as_tensor(x).to(torch.float32)
    t_len, c = x.shape
    dev = x.device
    if state is None:
        state = ensemble_init(c, window, detectors=detectors, device=dev)
    spec = ensemble_spec(detectors, window)
    spec.validate_aux(state.aux, c)
    k0 = _row(state.k, c, torch.float32, dev)
    vlen, _ = vlen_vec(valid_lens, t_len, c, torch.int32, dev)
    sel, thr = _sel_thr(sel, thr, len(detectors), c, dev)
    bits, vote, fk, auxf, scores = ensemble_scan_call(
        x, vlen, k0, _row(m, c, torch.float32, dev), thr, sel, state.aux,
        detectors=detectors, window=window, fmt=fmt)
    return (EnsembleState(k=fk, aux=auxf),
            {"det_flags": bits, "vote": vote, "scores": scores})


def ensemble_ref(x, m=3.0, *, detectors=DEFAULT_DETECTORS,
                 window: int = DEFAULT_WINDOW, sel=None, thr=None,
                 fmt=None, valid_lens=None) -> dict:
    """Oracle composition: every member's row-recursive oracle from a
    fresh stream start, fused with the kernel's vote (bit d of
    `det_flags` is detectors[d], selection-masked; the vote weight sum
    accumulates in detector order in float32).  Returns {"det_flags",
    "vote", "per_detector": {name: (T, C) bool}, "per_score": {name:
    (T, C) float32, zero past the valid prefix}}."""
    detectors = check_detectors(detectors)
    fmt = check_fmt(detectors, fmt)
    x = torch.as_tensor(x).to(torch.float32)
    t_len, c = x.shape
    dev = x.device
    sel, thr = _sel_thr(sel, thr, len(detectors), c, dev)
    per, per_score = {}, {}
    for name in detectors:
        if name == "zscore":
            _, out = zscore_scan(x, m, zscore_init(c, window, device=dev),
                                 valid_lens=valid_lens)
        elif name == "hst":
            _, out = hst_scan(x, m, hst_init(c, device=dev), window=window,
                              valid_lens=valid_lens)
        elif name == "teda-q":
            _, out = teda_q_member_scan(x, fmt, m, None,
                                        valid_lens=valid_lens)
        else:
            _, out = DETECTORS[name](x, m, None, valid_lens=valid_lens)
        per[name] = out["outlier"]
        per_score[name] = out["score"]
    live = valid_rows(valid_lens, t_len, c, dev)
    # the kernel zeroes score streams beyond a channel's valid prefix;
    # the moment oracles emit unspecified values there
    per_score = {n: torch.where(live, s, 0.0) for n, s in per_score.items()}
    bits = torch.zeros((t_len, c), dtype=torch.int32, device=dev)
    votew = torch.zeros((t_len, c), dtype=torch.float32, device=dev)
    for d, name in enumerate(detectors):
        f = per[name] & (sel[d] > 0.0)[None, :]
        bits = bits | (f.to(torch.int32) << d)
        votew = votew + f.to(torch.float32) * sel[d][None, :]
    totw = sel.sum(0)
    vote = (votew >= thr[None, :]) & (totw > 0.0)[None, :] & live
    return {"det_flags": bits, "vote": vote, "per_detector": per,
            "per_score": per_score}
