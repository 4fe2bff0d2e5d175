"""TEDAGuard — the paper's detector as a training-loop feature.

Wraps a train step with streaming anomaly detection over its telemetry
(loss, global grad norm).  An outlier verdict (eq (6)) masks the
optimizer update for that step (the gradients are dropped, the model
never sees the bad batch): the loss-spike / corrupt-batch defense of
production LLM training, with O(1) state per monitored channel.

The guard state lives beside the train state on the device and the
skip is a device `bool` tensor: `guard_step` reads nothing back to the
host, so the masked update costs no synchronisation.  The monitored
channels are packed `repro_torch.engine` state (one slot per telemetry
channel) advanced with the engine's single-sample path, `engine_step`,
which is plain PyTorch: the guard launches no TEDA kernel.

Also provides a host-side `StragglerDetector` (TEDA over per-step wall
times) used by the launcher.
"""
from __future__ import annotations

import time
from typing import TYPE_CHECKING, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.teda import TedaOutput
from repro_torch.tree import tree_map

if TYPE_CHECKING:  # type-only: repro_torch.core <-> engine.state cycle
    from repro_torch.engine.state import EngineState


def _engine():
    """Lazy import of the engine's functional core.

    `repro_torch.core.__init__` imports this module while
    `repro_torch.engine.state` may itself be mid-import of
    `repro_torch.core.teda`; deferring to call time breaks the cycle.
    """
    from repro_torch.engine import state
    return state


__all__ = ["GuardConfig", "GuardState", "GuardVerdict", "guard_init",
           "guard_step", "apply_guard", "StragglerDetector"]


class GuardConfig(NamedTuple):
    m: float = 3.0           # eq (6) threshold multiplier
    warmup_steps: int = 20   # never skip before statistics stabilize
    exclude_outliers: bool = True  # don't absorb outliers into (mu, var)
    channels: int = 2        # monitored telemetry channels


class GuardState(NamedTuple):
    teda: "EngineState"      # packed per-channel engine state
    skipped: torch.Tensor    # () int32 — total skipped steps
    last_outlier: torch.Tensor  # (channels,) bool


class GuardVerdict(NamedTuple):
    skip: torch.Tensor       # () bool — whether the update was masked
    per_channel: TedaOutput  # raw TEDA verdicts per channel


def guard_init(cfg: GuardConfig, device=None) -> GuardState:
    """Fresh guard state on `device` (the card unless the caller names
    another; raises without CUDA)."""
    from repro_torch.engine.engine import resolve_device
    dev = resolve_device(device)
    return GuardState(
        teda=_engine().engine_init(cfg.channels, device=dev),
        skipped=torch.zeros((), dtype=torch.int32, device=dev),
        last_outlier=torch.zeros((cfg.channels,), dtype=torch.bool,
                                 device=dev),
    )


def guard_step(state: GuardState, metrics: torch.Tensor, cfg: GuardConfig
               ) -> Tuple[GuardState, GuardVerdict]:
    """Score one step's telemetry vector metrics (channels,).

    Non-finite telemetry (NaN/inf loss or grad norm) is always an
    outlier.  With `exclude_outliers`, flagged samples do not
    contaminate the TEDA statistics (the state update is rolled back
    after warmup), so a run of spikes stays detectable.
    """
    eng = _engine()
    metrics = metrics.to(state.teda.mean.dtype)
    finite = torch.isfinite(metrics)
    clean = torch.where(finite, metrics, state.teda.mean)
    new_teda, out = eng.engine_step(state.teda, clean, cfg.m)

    in_warmup = state.teda.k[0] < cfg.warmup_steps
    outlier = out.outlier | ~finite
    trip = outlier.any() & ~in_warmup

    if cfg.exclude_outliers:
        keep = ~outlier | in_warmup
        new_teda = eng.EngineState(
            k=torch.where(keep, new_teda.k, state.teda.k),
            mean=torch.where(keep, new_teda.mean, state.teda.mean),
            var=torch.where(keep, new_teda.var, state.teda.var),
            active=new_teda.active,
        )

    new_state = GuardState(
        teda=new_teda,
        skipped=state.skipped + trip.to(torch.int32),
        last_outlier=outlier,
    )
    return new_state, GuardVerdict(skip=trip, per_channel=out)


def apply_guard(skip: torch.Tensor, new_tree, old_tree):
    """Mask a tree update: where skip, keep old leaves (grad dropped)."""
    return tree_map(lambda n, o: torch.where(skip, o, n), new_tree,
                    old_tree)


class StragglerDetector:
    """Host-side TEDA over per-step wall-times (straggler mitigation).

    The launcher feeds it one duration per step; `check()` returns True
    when the latest step is eccentric per eq (6).
    """

    def __init__(self, m: float = 3.0, warmup: int = 10):
        self.m = float(m)
        self.warmup = int(warmup)
        self.k = 0
        self.mean = 0.0
        self.var = 0.0
        self.trips = 0
        self.last_s: Optional[float] = None  # the latest tick-to-tock time
        self._t0: Optional[float] = None

    def tick(self) -> None:
        self._t0 = time.perf_counter()

    def tock(self) -> bool:
        if self._t0 is None:
            raise RuntimeError("tick() before tock()")
        self.last_s = time.perf_counter() - self._t0
        return self.check(self.last_s)

    def check(self, duration_s: float) -> bool:
        self.k += 1
        k = float(self.k)
        if self.k == 1:
            self.mean, self.var = duration_s, 0.0
            return False
        self.mean = (k - 1.0) / k * self.mean + duration_s / k
        d2 = (duration_s - self.mean) ** 2
        self.var = (k - 1.0) / k * self.var + d2 / k
        if self.var <= 0.0 or self.k <= self.warmup:
            return False
        ecc = 1.0 / k + d2 / (k * self.var)
        trip = ecc / 2.0 > (self.m ** 2 + 1.0) / (2.0 * k)
        self.trips += int(trip)
        return bool(trip)
