"""Composable streaming anomaly detectors behind one state-carry contract.

K detectors are evaluated per channel in one fused CUDA kernel
(`kernels/ensemble_scan.py`, `csrc/ensemble_scan.cu`), selected per slot
at `attach(detectors=...)` and fused into a verdict by a weighted vote.
Every detector speaks the engine's contract — (T, C) chunks of C
independent univariate channel streams, per-channel carried state,
ragged `valid_lens` prefixes — and has a plain PyTorch row-recursive
oracle here, the port of the JAX package's `lax.scan` oracle:

  * "teda"   — the paper's eccentricity detector (eq (6)).
  * "rde"    — recursive density estimation: biased variance from the
               running sum and sum of squares.
  * "zscore" — sliding-window z-score over the last `window` samples.
  * "hst"    — streaming half-space tree (leaf-mass tables).
  * "teda-q" — the bit-accurate Q-format TEDA datapath as a voter.

The packed aux layout is `spec.ensemble_spec`: the moment fabric that
teda/rde/zscore share, then the opaque regions of hst and teda-q.
"""
from __future__ import annotations

import numpy as np

from repro_torch.detectors.hst import HstState, hst_scan
from repro_torch.detectors.rde import RdeState, rde_scan
from repro_torch.detectors.spec import (MEMBERS, MOMENT_MEMBERS, Region,
                                        StateSpec, ensemble_spec)
from repro_torch.detectors.teda import teda_detector_scan
from repro_torch.detectors.teda_q import (TedaQMemberState,
                                          teda_q_member_scan)
from repro_torch.detectors.zscore import ZscoreState, zscore_scan

__all__ = ["DETECTORS", "DEFAULT_DETECTORS", "DEFAULT_WINDOW",
           "VOTE_MODES", "MOMENT_MEMBERS", "Region", "StateSpec",
           "ensemble_spec", "aux_rows", "vote_threshold", "RdeState",
           "ZscoreState", "HstState", "TedaQMemberState", "rde_scan",
           "zscore_scan", "teda_detector_scan", "hst_scan",
           "teda_q_member_scan"]

#: each member's row-recursive oracle, in the canonical order `MEMBERS`
#: (index d is bit d of the fused kernel's per-sample detector bitmask)
DETECTORS = dict(zip(MEMBERS, (teda_detector_scan, rde_scan, zscore_scan,
                               hst_scan, teda_q_member_scan)))
DEFAULT_DETECTORS = ("teda", "rde", "zscore")
DEFAULT_WINDOW = 8
VOTE_MODES = ("any", "majority", "all")


def aux_rows(window: int = DEFAULT_WINDOW, detectors=None) -> int:
    """Per-channel packed aux rows: the moment fabric alone (2W + 1)
    with `detectors=None`, else the ensemble's full `StateSpec` rows."""
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if detectors is None:
        return 2 * int(window) + 1
    return ensemble_spec(detectors, window).rows


def vote_threshold(vote, weights) -> float:
    """The weighted-vote decision threshold for one slot.

    `weights` are the slot's per-detector selection weights (0 =
    unselected); the verdict fires when the weight-sum of flagging
    detectors is >= the returned threshold (and at least one detector
    is selected).  `vote` is "any" / "majority" / "all", or a float
    fraction f in (0, 1] of the total selected weight.  The float32
    arithmetic is the JAX package's, so the thresholds are bit-equal.
    """
    w = np.asarray(weights, np.float32).reshape(-1)
    w = w[w > 0]
    tot = float(np.float32(w.sum(dtype=np.float32))) if w.size else 0.0
    if isinstance(vote, bool) or vote is None:
        raise ValueError(f"vote must be a mode or fraction, got {vote!r}")
    if isinstance(vote, (int, float)):
        if not 0.0 < float(vote) <= 1.0:
            raise ValueError(
                f"fractional vote must lie in (0, 1], got {vote}")
        return float(np.float32(vote)) * tot
    if vote == "any":
        return float(w.min()) if w.size else 0.0
    if vote == "majority":
        return tot / 2.0
    if vote == "all":
        return tot
    raise ValueError(
        f"unknown vote mode {vote!r}; expected one of {VOTE_MODES} "
        "or a fraction in (0, 1]")
