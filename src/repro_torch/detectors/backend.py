"""The "ensemble" engine backend: K detectors behind the one-slot
streaming contract.

Registered in `engine/backends.py` as an unlisted backend (it is a
different detection algorithm, not another TEDA executor, so it stays
out of `list_backends()`).  Construct it through the engine:

    eng = StreamEngine(65536, "ensemble", detectors=ALL5, vote="majority",
                       window=8, fmt=QFormat(32, 20))
    eng.attach([3], detectors=("rde",))   # slot 3 runs RDE alone

The backend's packed state grows the `aux` block (`EngineState.aux`)
whose per-channel row layout is `state_spec`, the `StateSpec` of
`detectors/spec.py`.  The packed `mean`/`var` vectors are derived
mirrors (running mean, TEDA variance) kept for introspection parity
with the TEDA backends.  `process` returns a 7-tuple `(k', mean', var',
aux', det_bits, vote, scores)`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.detectors import (DEFAULT_DETECTORS, DEFAULT_WINDOW,
                                   ensemble_spec, vote_threshold)
from repro_torch.detectors.ensemble import EnsembleState, ensemble_scan
from repro_torch.detectors.spec import check_detectors, check_fmt
from repro_torch.engine.backends import Backend

__all__ = ["EnsembleBackend"]


class EnsembleBackend(Backend):
    """Fused multi-detector ensemble executor (the CUDA ensemble kernel).

    `detectors` fixes the members and their bitmask order (bit d =
    detectors[d]); per-slot selection among them is the runtime `sel`
    weight matrix the engine threads through `attach(detectors=...)`.
    `vote` / `weights` set the default vote mode and per-member weights
    (see `detectors.vote_threshold`); `window` sizes the zscore and hst
    windows and the carried aux block; `fmt` is the "teda-q" member's
    QFormat (required iff present).  `block_t`, `block_c` and
    `lane_pad` are accepted and do not change results.
    """

    name = "ensemble"
    state_dtype = torch.float32

    def __init__(self, m: float = 3.0, detectors=DEFAULT_DETECTORS,
                 window: int = DEFAULT_WINDOW, vote="majority",
                 weights=None, fmt=None, block_t: int = 256,
                 block_c: Optional[int] = None, lane_pad: int = 128,
                 **_ignored):
        self.detectors = check_detectors(detectors)
        self.window = int(window)
        self.fmt = check_fmt(self.detectors, fmt)
        if self.fmt is not None:
            self.fmt.validate()
        #: the per-member aux layout this backend carries
        self.state_spec = ensemble_spec(self.detectors, self.window)
        self.aux_rows = self.state_spec.rows
        self.vote = vote
        if weights is None:
            w = np.ones((len(self.detectors),), np.float32)
        elif isinstance(weights, dict):
            unknown = sorted(set(weights) - set(self.detectors))
            if unknown:
                raise ValueError(
                    f"weights for unknown detectors {unknown}; ensemble "
                    f"members: {list(self.detectors)}")
            w = np.asarray([weights.get(d, 1.0) for d in self.detectors],
                           np.float32)
        else:
            w = np.asarray(weights, np.float32).reshape(-1)
            if w.shape != (len(self.detectors),):
                raise ValueError(
                    f"weights must have one entry per detector "
                    f"{list(self.detectors)}, got shape {w.shape}")
        if (w <= 0).any():
            raise ValueError(f"detector weights must be positive: {w}")
        self.weights = w
        # validates the mode (and the weights) at construction
        self.default_threshold = vote_threshold(vote, w)
        self.m = m
        self.block_t = block_t
        self.block_c = block_c
        self.lane_pad = lane_pad

    def process(self, x, k, mean, var, aux=None, m=None, valid_lens=None,
                sel=None, thr=None) -> Tuple[torch.Tensor, ...]:
        """One fused (T, C) ensemble call.

        `aux` is the packed state block ((state_spec.rows, C)); `sel`
        the (K, C) per-slot selection weights and `thr` the (C,) vote
        thresholds (None: every member at its default weight, the
        backend's vote mode).  Returns (k', mean', var', aux', det_bits,
        vote, scores): mean'/var' are the derived mirrors of the fabric
        rows, `scores` the (K, T, C) per-member score streams.
        """
        if aux is None:
            raise ValueError(
                "the ensemble backend needs the packed aux state "
                "(engine_init(aux_rows=backend.aux_rows))")
        c = x.shape[1]
        if sel is None:
            sel = torch.as_tensor(self.weights, device=x.device)[:, None] \
                .expand(len(self.detectors), c)
        if thr is None:
            thr = self.default_threshold
        final, out = ensemble_scan(
            x, self._m(m), EnsembleState(k=k, aux=aux),
            detectors=self.detectors, window=self.window, sel=sel,
            thr=thr, fmt=self.fmt, valid_lens=valid_lens,
            block_t=self.block_t, block_c=self.block_c,
            lane_pad=self.lane_pad)
        w = self.window
        meanf = final.aux[w - 1] / final.k.clamp_min(1.0)
        varf = final.aux[2 * w]
        return (final.k, meanf, varf, final.aux, out["det_flags"],
                out["vote"], out["scores"])
