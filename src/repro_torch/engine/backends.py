"""Detector backend registry: interchangeable TEDA executors.

One streaming contract — `process(x, k, mean, var)` over (T, C) chunks
of C independent univariate channel streams with per-channel carried
state — behind which the TEDA implementations are interchangeable:

  * "scan"   — plain PyTorch parallel scan (`core/scan.py`), any device.
  * "cuda"   — the float CUDA kernel, slim verdict outputs (the serving
               hot path; `kernels/teda_scan.py`).  The reference's
               "pallas".
  * "cuda-q" — the bit-accurate Q-format CUDA kernel (needs a
               `QFormat`).  The reference's "pallas-q".

On CPU tensors the two kernel backends run the kernels' plain PyTorch
versions.  Every backend carries state as per-channel (C,) vectors and
is chunk-exact: feeding a stream in arbitrary chunk sizes reproduces
the single-shot result (bit for bit on the Q path).

Register out-of-tree executors with `@register_backend("name")`.
`listed=False` registers a backend that `get_backend` resolves but
`list_backends()` omits: "ensemble", the fused detector ensemble
(`detectors/backend.py`), is registered so.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.core.scan import teda_scan
from repro_torch.core.teda import TedaState
from repro_torch.fixedpoint.qformat import QFormat
from repro_torch.fixedpoint.teda_q import msq1_const
from repro_torch.kernels.ops import (teda_q_scan_full, teda_q_scan_verdict,
                                     teda_scan_verdict)

__all__ = ["Backend", "register_backend", "get_backend", "list_backends"]

_REGISTRY: Dict[str, Callable[..., "Backend"]] = {}
_LISTED: Set[str] = set()


class Backend:
    """Streaming detector contract.

    `process(x, k, mean, var, m=None, valid_lens=None)` consumes one
    (T, C) chunk with carried per-channel state vectors (C,) and
    returns `(k', mean', var', ecc, outlier)`.  `m` overrides the
    constructed threshold per call (scalar or (C,)).  `valid_lens`
    (scalar or (C,)) restricts each channel to its leading vlen rows;
    `outlier` is False at rows >= vlen[c].  `state_dtype` is int32 for
    the Q datapath and float32 otherwise; `ecc` is in the backend's
    native domain (Q int32 for "cuda-q").
    """

    name: str = "abstract"
    state_dtype = torch.float32

    def process(self, x: torch.Tensor, k: torch.Tensor, mean: torch.Tensor,
                var: torch.Tensor, m=None,
                valid_lens=None) -> Tuple[torch.Tensor, ...]:
        raise NotImplementedError

    def quantize_m(self, m):
        """Host-side preparation of an m override: float32 as-is; the Q
        backend turns it into its exact msq1 constant."""
        return np.asarray(m, np.float32)

    def _m(self, m):
        return self.m if m is None else m


def register_backend(name: str, listed: bool = True):
    """Decorator: register a backend factory under `name`."""

    def deco(factory):
        _REGISTRY[name] = factory
        if listed:
            _LISTED.add(name)
        else:
            _LISTED.discard(name)
        return factory

    return deco


def get_backend(name: str, **opts) -> Backend:
    """Instantiate a registered backend with the engine's options."""
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown backend {name!r}; registered: {list_backends()}"
        ) from None
    return factory(**opts)


def list_backends(all: bool = False):
    return sorted(_REGISTRY) if all else sorted(_LISTED)


def _as_teda_state(k, mean, var) -> TedaState:
    return TedaState(k=k, mean=mean[:, None], var=var)


@register_backend("scan")
class ScanBackend(Backend):
    """Plain PyTorch parallel-scan TEDA (`core/scan.py`)."""

    name = "scan"
    state_dtype = torch.float32

    def __init__(self, m: float = 3.0, **_ignored):
        self.m = m

    def process(self, x, k, mean, var, m=None, valid_lens=None):
        final, out = teda_scan(x[..., None], self._m(m),
                               _as_teda_state(k, mean, var),
                               valid_lens=valid_lens)
        return final.k, final.mean[:, 0], final.var, out.ecc, out.outlier


class _KernelBackend(Backend):
    """Shared options of the two kernel backends.  `block_t`, `block_c`
    and `lane_pad` are the reference's grid arguments: accepted, and the
    results do not depend on them."""

    def __init__(self, m: float = 3.0, block_t: int = 256,
                 block_c: Optional[int] = None, lane_pad: int = 128):
        self.m = m
        self.block_t = block_t
        self.block_c = block_c
        self.lane_pad = lane_pad

    def _grid(self):
        return {"block_t": self.block_t, "block_c": self.block_c,
                "lane_pad": self.lane_pad}


@register_backend("cuda")
class CudaBackend(_KernelBackend):
    """The float CUDA kernel, slim verdict outputs (the hot path)."""

    name = "cuda"
    state_dtype = torch.float32

    def __init__(self, m: float = 3.0, block_t: int = 256,
                 block_c: Optional[int] = None, lane_pad: int = 128,
                 **_ignored):
        super().__init__(m, block_t, block_c, lane_pad)

    def process(self, x, k, mean, var, m=None, valid_lens=None):
        final, out = teda_scan_verdict(
            x, self._m(m), _as_teda_state(k, mean, var),
            valid_lens=valid_lens, **self._grid())
        return (final.k, final.mean[:, 0], final.var, out["ecc"],
                out["outlier"])


@register_backend("cuda-q")
class CudaQBackend(_KernelBackend):
    """The bit-accurate Q-format CUDA kernel (the FPGA datapath)."""

    name = "cuda-q"
    state_dtype = torch.int32

    def __init__(self, fmt: Optional[QFormat] = None, m: float = 3.0,
                 block_t: int = 256, block_c: Optional[int] = None,
                 lane_pad: int = 128, verdict: bool = True, **_ignored):
        if fmt is None:
            raise ValueError("backend 'cuda-q' needs fmt=QFormat(...)")
        self.fmt = fmt.validate()
        super().__init__(m, block_t, block_c, lane_pad)
        # verdict=True is the serving hot path (no per-row mean/var
        # streams); verdict=False keeps the full (T, C) Q trajectory
        self.verdict = verdict

    def quantize_m(self, m):
        """Exact host msq1 (int32 Q): per-slot thresholds get the same
        bits as a scalar-m run."""
        return np.asarray(msq1_const(self.fmt, np.asarray(m, np.float64)),
                          np.int32)

    def process(self, x, k, mean, var, m=None, valid_lens=None):
        scan = teda_q_scan_verdict if self.verdict else teda_q_scan_full
        final, out = scan(x, self.fmt, self._m(m),
                          _as_teda_state(k, mean, var),
                          valid_lens=valid_lens, **self._grid())
        return (final.k, final.mean[:, 0], final.var, out["ecc"],
                out["outlier"])


@register_backend("ensemble", listed=False)
def _ensemble_factory(**opts) -> Backend:
    """The fused multi-detector ensemble backend, imported on first use:
    `repro_torch.detectors.backend` imports this module for `Backend`."""
    from repro_torch.detectors.backend import EnsembleBackend
    return EnsembleBackend(**opts)
