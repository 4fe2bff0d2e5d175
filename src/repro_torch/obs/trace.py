"""Tick-level tracer: bounded ring buffer of span events, Chrome
trace-event JSON export.

Records the serving pipeline's spans (dispatch, retire, compiles, pool
resizes) with monotonic timestamps and tick/rid/slot attribution, in a
preallocated ring buffer so a forever-running process traces at
O(capacity) memory.  `to_chrome_trace()` emits the Chrome trace-event
JSON that Perfetto (ui.perfetto.dev) and `chrome://tracing` open.

Off by default and zero-cost when disabled: components hold the
`NULL_TRACER` singleton (``enabled = False``, no-op `span`/`instant`)
and guard argument assembly behind ``tracer.enabled``.

With ``annotate_device=True``, spans marked ``device=True`` also enter
a `torch.profiler.record_function` range, so host spans line up with
the CUDA kernels when a run is captured under `torch.profiler.profile`.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import List, Optional

from torch.profiler import record_function

__all__ = ["TickTracer", "NullTracer", "NULL_TRACER"]


class _NullSpan:
    """Reusable no-op context manager (one shared instance)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """The disabled recorder: every call is a no-op."""

    enabled = False

    def span(self, name: str, device: bool = False, **args):
        return _NULL_SPAN

    def instant(self, name: str, **args) -> None:
        return None

    def events(self) -> List[dict]:
        return []

    def to_chrome_trace(self) -> dict:
        return {"traceEvents": [], "displayTimeUnit": "ms"}


NULL_TRACER = NullTracer()


class _Span:
    """Context manager recording one duration ("X") event on exit."""

    __slots__ = ("_tracer", "_name", "_args", "_t0", "_ann")

    def __init__(self, tracer: "TickTracer", name: str, device: bool,
                 args: dict):
        self._tracer = tracer
        self._name = name
        self._args = args
        self._ann = (record_function(name)
                     if device and tracer._annotate_device else None)

    def __enter__(self):
        if self._ann is not None:
            self._ann.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self._ann is not None:
            self._ann.__exit__(*exc)
        self._tracer._record(self._name, "X", self._t0,
                             dur_s=t1 - self._t0, args=self._args)
        return False


class TickTracer:
    """Bounded ring-buffer recorder of scheduler/pool/engine events.

    >>> tracer = TickTracer(capacity=4096)
    >>> with tracer.span("dispatch", device=True, tick=3, t=32):
    ...     out = engine.process(x, valid_lens=vlens)
    >>> tracer.instant("pool.resize", frm=8, to=16)
    >>> tracer.dump("trace.json")          # open in ui.perfetto.dev

    `capacity` bounds memory: past it the oldest events are overwritten
    (`dropped` counts them).  Timestamps are `time.perf_counter()`
    microseconds relative to construction.
    """

    enabled = True

    def __init__(self, capacity: int = 65536,
                 annotate_device: bool = False):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1: {capacity}")
        self.capacity = int(capacity)
        self._annotate_device = bool(annotate_device)
        self._buf: List[Optional[dict]] = [None] * self.capacity
        self._head = 0          # next write position
        self.total = 0          # events ever recorded
        self._t0 = time.perf_counter()
        self._pid = os.getpid()
        self._lock = threading.Lock()

    # ------------------------------------------------------ recording
    def _record(self, name: str, ph: str, t_start: float, *,
                dur_s: Optional[float] = None,
                args: Optional[dict] = None) -> None:
        ev = {"name": name, "ph": ph, "pid": self._pid,
              "tid": threading.get_ident(),
              "ts": (t_start - self._t0) * 1e6}
        if dur_s is not None:
            ev["dur"] = dur_s * 1e6
        if args:
            ev["args"] = args
        with self._lock:
            self._buf[self._head] = ev
            self._head = (self._head + 1) % self.capacity
            self.total += 1

    def span(self, name: str, device: bool = False, **args) -> _Span:
        """Context manager recording a duration span; `device=True`
        also enters a `torch.profiler.record_function` range when the
        tracer was built with ``annotate_device=True``."""
        return _Span(self, name, device, args)

    def instant(self, name: str, **args) -> None:
        """Record a zero-duration instant event."""
        self._record(name, "i", time.perf_counter(), args=args)

    # ------------------------------------------------------ inspection
    def __len__(self) -> int:
        return min(self.total, self.capacity)

    @property
    def dropped(self) -> int:
        """Events overwritten by ring wraparound."""
        return max(0, self.total - self.capacity)

    def events(self) -> List[dict]:
        """Retained events, oldest first."""
        with self._lock:
            if self.total < self.capacity:
                return list(self._buf[:self._head])
            return self._buf[self._head:] + self._buf[:self._head]

    def to_chrome_trace(self) -> dict:
        """The Chrome trace-event JSON document (Perfetto-loadable);
        events are sorted by timestamp as the viewers expect."""
        evs = sorted(self.events(), key=lambda e: e["ts"])
        return {"traceEvents": evs, "displayTimeUnit": "ms",
                "otherData": {"recorded": self.total,
                              "dropped": self.dropped}}

    def dump(self, path) -> None:
        """Write the Chrome trace JSON to `path`."""
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)
            f.write("\n")
