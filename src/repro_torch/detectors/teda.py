"""TEDA as an ensemble detector: the paper's eq (6) behind the shared
detector contract.

A thin adapter over the port's parallel-scan oracle (`core/scan.py`),
so the conformance suite treats every detector alike:
`(state', {"outlier", "score"})` per (T, C) chunk, with `score` the
eccentricity stream.  Inside the fused ensemble kernel the TEDA lane
is not this function: it is the arithmetic of `csrc/teda_scan.cu`, row
for row, which is why its flags and eccentricity are bit-identical to
the "cuda" backend's.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.scan import teda_scan
from repro_torch.core.teda import TedaState

__all__ = ["teda_detector_scan"]


def teda_detector_scan(x, m=3.0, state: Optional[TedaState] = None, *,
                       valid_lens=None) -> Tuple[TedaState, dict]:
    """TEDA oracle over x (T, C) in the detector contract.

    Returns (final TedaState, {"outlier": (T, C) bool, "score": (T, C)
    eccentricity}).  `m` is a scalar or per-channel (C,) sensitivity;
    `valid_lens` the per-channel ragged prefix (see `core/scan.py`).
    """
    x = torch.as_tensor(x).to(torch.float32)
    final, out = teda_scan(x[..., None], m, state, valid_lens=valid_lens)
    return final, {"outlier": out.outlier, "score": out.ecc}
