"""Autoscaling slot pool: bucketed capacities over `StreamEngine`.

Growing or shrinking tenancy should not change the chunk shape on
every attach/detach: `SlotPool` quantizes capacity to a fixed bucket
ladder (e.g. 8/16/32/64).  Acquiring a slot beyond the current bucket
re-pads the packed state up to the next bucket, releasing the last
tenants of a bucket re-pads it down, and every bucket's engine is
cached, so a tenancy level seen before builds nothing new.  Slot
indices are stable across resizes (state is padded at the tail, never
compacted), which is what lets a scheduler treat a slot as a request
lifecycle (`launch/batching.py`).

A resize pads on the engine's device (a new zero tensor, then a slice
copy) and is enqueued on the same stream as every `process` call, so it
follows the calls still in flight and never races them.  The
ensemble's aux block moves as raw 32-bit words: some teda-q payloads
are float NaN patterns, which a float copy may canonicalise.

`PoolFull` (capacity exhausted at the top bucket) is the backpressure
signal — explicit, with occupancy attached, never a silent drop.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.engine.engine import StreamEngine
from repro_torch.engine.state import EngineState
from repro_torch.obs import NULL_TRACER, MetricsRegistry, auto_name

__all__ = ["SlotPool", "PoolFull"]


class PoolFull(RuntimeError):
    """All buckets are full: acquisition must wait for a release."""

    def __init__(self, msg: str, occupancy: int, capacity: int):
        super().__init__(msg)
        self.occupancy = occupancy
        self.capacity = capacity


def _pad(v: torch.Tensor, bucket: int, keep: int) -> torch.Tensor:
    """`v`'s first `keep` entries along its last (slot) axis in a zero
    tensor of `bucket` slots, on `v`'s device.  Float blocks move as
    their int32 words."""
    words = v.view(torch.int32) if v.dtype == torch.float32 else v
    out = torch.zeros(words.shape[:-1] + (bucket,), dtype=words.dtype,
                      device=words.device)
    out[..., :keep] = words[..., :keep]
    return out.view(v.dtype)


class SlotPool:
    """Bucketed autoscaling pool of TEDA engine slots.

    >>> pool = SlotPool("cuda", buckets=(8, 16, 32, 64))
    >>> a, b = pool.acquire(2, m=2.5)       # capacity snaps to 8
    >>> out = pool.process(chunk)           # chunk: (T, pool.capacity)
    >>> pool.release([a])                   # may shrink back a bucket

    All engine options (`device`, `fmt`, `block_t`, ...) pass through
    to the per-bucket `StreamEngine`s.
    """

    def __init__(self, backend: str = "scan", *,
                 buckets: Tuple[int, ...] = (8, 16, 32, 64),
                 m: float = 3.0, registry=None, tracer=None,
                 name: Optional[str] = None, **engine_opts):
        if not buckets or any(b <= 0 for b in buckets):
            raise ValueError(f"buckets must be positive: {buckets}")
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.backend_name = backend
        self.default_m = float(m)
        self._opts = dict(engine_opts, m=m)
        self._engines: dict[int, StreamEngine] = {}
        self._bucket = self.buckets[0]
        # observability: the registry/tracer are shared with every
        # per-bucket engine (engine series are labelled `<pool>/capN`),
        # so one snapshot covers the whole pool
        self.registry = (MetricsRegistry() if registry is None
                         else registry)
        self.tracer = NULL_TRACER if tracer is None else tracer
        self.name = auto_name("pool") if name is None else str(name)
        lbl = {"pool": self.name}
        self._g_occupancy = self.registry.gauge(
            "pool_occupancy", "attached tenant slots",
            ("pool",)).labels(**lbl)
        self._g_capacity = self.registry.gauge(
            "pool_capacity", "current bucket capacity",
            ("pool",)).labels(**lbl)
        self._g_capacity.set(self._bucket)
        self._c_grows = self.registry.counter(
            "pool_grows_total", "bucket grow transitions",
            ("pool",)).labels(**lbl)
        self._c_shrinks = self.registry.counter(
            "pool_shrinks_total", "bucket shrink transitions",
            ("pool",)).labels(**lbl)
        self._c_full = self.registry.counter(
            "pool_full_total",
            "PoolFull backpressure raises (acquire beyond top bucket)",
            ("pool",)).labels(**lbl)

    # ------------------------------------------------------- engines
    def _engine_for(self, bucket: int) -> StreamEngine:
        eng = self._engines.get(bucket)
        if eng is None:
            eng = StreamEngine(bucket, self.backend_name,
                               auto_attach=False,
                               registry=self.registry,
                               tracer=self.tracer,
                               name=f"{self.name}/cap{bucket}",
                               **self._opts)
            self._engines[bucket] = eng
        return eng

    @property
    def engine(self) -> StreamEngine:
        """The live engine at the current bucket capacity."""
        return self._engine_for(self._bucket)

    @property
    def device(self) -> torch.device:
        return self.engine.device

    @property
    def capacity(self) -> int:
        return self._bucket

    @property
    def max_capacity(self) -> int:
        return self.buckets[-1]

    @property
    def resizes(self) -> int:
        """Grow + shrink transitions (read from the obs registry)."""
        return int(self._c_grows.value + self._c_shrinks.value)

    @property
    def occupancy(self) -> int:
        return len(self.engine.active_slots)

    @property
    def free_slots(self) -> np.ndarray:
        return np.flatnonzero(~self._active_host())

    def _active_host(self) -> np.ndarray:
        """The live engine's active mask on the host.  It is read back
        from the device once after each attach/detach (a sync that waits
        for the calls in flight), then served from the engine's mirror."""
        return self.engine._active_mask_host()

    # ------------------------------------------------------- resizing
    def _resize(self, bucket: int) -> None:
        """Re-pad the packed state into `bucket`'s cached engine."""
        if bucket == self._bucket:
            return
        src, dst = self.engine, self._engine_for(bucket)
        st, keep = src.state, min(self._bucket, bucket)
        dst.state = EngineState(
            k=_pad(st.k, bucket, keep), mean=_pad(st.mean, bucket, keep),
            var=_pad(st.var, bucket, keep),
            active=_pad(st.active, bucket, keep),
            aux=None if st.aux is None else _pad(st.aux, bucket, keep))
        new_m = np.full((bucket,), self.default_m, np.float32)
        new_m[:keep] = src.slot_m[:keep]
        dst.set_m(None, new_m)
        if src._ensemble:
            # per-slot detector selection rides along with the state;
            # both engines' device copies of the rows are stale now
            dst._det_w[:, :keep] = src._det_w[:, :keep]
            dst._det_w[:, keep:] = np.asarray(
                dst.backend.weights, np.float32)[:, None]
            dst._det_thr[:keep] = src._det_thr[:keep]
            dst._det_thr[keep:] = dst.backend.default_threshold
            dst._det_dev = None
            src._reset_detectors(np.ones((self._bucket,), bool))
        # the old engine keeps only its cached program shapes, not
        # tenants
        src.state = EngineState(
            k=torch.zeros_like(st.k), mean=torch.zeros_like(st.mean),
            var=torch.zeros_like(st.var),
            active=torch.zeros_like(st.active),
            aux=None if st.aux is None else torch.zeros_like(st.aux))
        (self._c_grows if bucket > self._bucket
         else self._c_shrinks).inc()
        if self.tracer.enabled:
            self.tracer.instant("pool.resize", pool=self.name,
                                frm=self._bucket, to=bucket)
        self._bucket = bucket
        self._g_capacity.set(bucket)

    def _bucket_holding(self, n_slots: int, max_idx: int) -> Optional[int]:
        """Smallest bucket with room for `n_slots` keeping index
        `max_idx` addressable; None if even the top bucket is too small."""
        for b in self.buckets:
            if b >= n_slots and b > max_idx:
                return b
        return None

    # ------------------------------------------------------- tenancy
    def acquire(self, n: int = 1, *, m: Optional[float] = None,
                detectors=None, vote=None) -> np.ndarray:
        """Attach `n` new tenants, growing the bucket if needed.

        Returns the acquired slot indices (stable across resizes).
        Raises `PoolFull` when the top bucket cannot hold them — the
        scheduler's backpressure signal.  `detectors` / `vote` select
        the new tenants' detector subset and vote mode under the
        ensemble backend (`StreamEngine.attach`).
        """
        act = self._active_host()
        need = int(act.sum()) + n
        if need > self._bucket:
            max_idx = int(np.flatnonzero(act).max()) if act.any() else -1
            target = self._bucket_holding(need, max_idx)
            if target is None:
                self._c_full.inc()
                raise PoolFull(
                    f"pool full: want {n} more slots with "
                    f"{int(act.sum())}/{self.max_capacity} active at the "
                    f"top bucket", int(act.sum()), self.max_capacity)
            self._resize(target)
        idx = self.engine.attach(n=n, m=m, detectors=detectors,
                                 vote=vote)
        self._g_occupancy.set(need)
        return idx

    def release(self, slots) -> None:
        """Detach tenants; shrink to the smallest bucket that still
        addresses every remaining active slot."""
        self.engine.detach(slots)
        act = self._active_host()
        self._g_occupancy.set(int(act.sum()))
        max_idx = int(np.flatnonzero(act).max()) if act.any() else -1
        target = self._bucket_holding(int(act.sum()), max_idx)
        if target is not None and target < self._bucket:
            self._resize(target)

    # ------------------------------------------------------- processing
    def process(self, x, active=None, valid_lens=None) -> dict:
        """Feed one (T, capacity) chunk to the current bucket's engine.

        `active` is the per-call participation mask and `valid_lens`
        the per-slot ragged retire counts (see `StreamEngine.process`);
        chunk width — and the `valid_lens` vector length — must equal
        the *current* `pool.capacity`: schedulers re-read it after
        acquire/release (`_resize` re-pads the packed *state* across
        buckets, but per-call vectors are built fresh each tick).

        Non-blocking: the returned verdicts are on the device and the
        kernels may still be running (see `StreamEngine.process`).
        Resizes never invalidate outputs already dispatched at the old
        capacity.
        """
        return self.engine.process(x, active=active,
                                   valid_lens=valid_lens)

    def programs(self) -> list:
        """Every (capacity, T) chunk shape executed so far, across all
        cached bucket engines.  Flat after warmup = the adaptive-chunk
        path adds no new shape."""
        return sorted((cap, t) for cap, eng in self._engines.items()
                      for t in eng.program_shapes)

    def stats(self) -> dict:
        return {"bucket": self._bucket, "buckets": list(self.buckets),
                "occupancy": self.occupancy, "resizes": self.resizes,
                "compiled_buckets": sorted(self._engines),
                "programs": self.programs()}
