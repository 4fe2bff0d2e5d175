"""Streaming event bus: verdicts stream at retirement, not completion.

Results in the serving stack materialise in full only when a request
completes (`BatchingScheduler.results()`); production traffic wants
them as they retire.  `EventBus` is the in-process primitive for
that: the scheduler publishes structured `Event`s the moment the
fused call that produced them is fetched to host —

    admitted       request acquired a slot      (slot, priority)
    chunk_retired  one member of a fused call   (slot, n, flags,
                   retired its samples           outlier[, ecc])
    done           request completed             (samples, flags)
    evicted        finished record aged out of
                   the retention window

Subscribers pull: `subscribe()` returns a `Subscription` whose
iterator drains the events queued so far without blocking (the
scheduler tick is single-threaded; a subscriber polls between
`step()` calls, or from another thread).  Each subscription has its
own bounded queue — a slow consumer drops its *own* oldest events
(counted in `Subscription.dropped`), never stalls the scheduler, and
never affects other subscribers.  `attach(callback)` is the push
alternative for in-process hooks (`serve_streams(on_event=...)`):
the callback runs synchronously at publish time, in retirement order.

Publishing is zero-cost with no consumers: `bus.active` is False and
the scheduler skips event assembly entirely.
"""
from __future__ import annotations

import itertools
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Iterator, List, Optional

__all__ = ["Event", "EventBus", "Subscription"]


@dataclass
class Event:
    """One structured scheduler event.

    `seq` is the bus-wide publish sequence number: events compare in
    retirement order across kinds (the event-bus ordering contract —
    concatenating a request's `chunk_retired` payloads reproduces its
    `results()` bit-for-bit).
    """

    kind: str
    seq: int
    tick: int
    rid: Optional[str] = None
    data: dict = field(default_factory=dict)


class Subscription:
    """A pull-side queue of events, bounded, drop-oldest."""

    def __init__(self, bus: "EventBus", maxlen: int):
        self._bus = bus
        self._q: deque = deque()
        self._maxlen = int(maxlen)
        self.dropped = 0
        self.closed = False
        self._lock = threading.Lock()

    def _push(self, ev: Event) -> None:
        with self._lock:
            if len(self._q) >= self._maxlen:
                self._q.popleft()
                self.dropped += 1
            self._q.append(ev)

    def poll(self) -> List[Event]:
        """Drain and return every event queued so far (never blocks)."""
        with self._lock:
            out = list(self._q)
            self._q.clear()
        return out

    def __iter__(self) -> Iterator[Event]:
        """Yield queued events until the queue is momentarily empty
        (non-blocking: iterate again after the next scheduler tick)."""
        while True:
            with self._lock:
                if not self._q:
                    return
                ev = self._q.popleft()
            yield ev

    def close(self) -> None:
        """Unsubscribe: the bus stops delivering to this queue."""
        if not self.closed:
            self.closed = True
            self._bus._drop(self)

    def __enter__(self) -> "Subscription":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


class EventBus:
    """Publish/subscribe fan-out for scheduler events (in-process)."""

    def __init__(self):
        self._subs: List[Subscription] = []
        self._callbacks: List[Callable[[Event], None]] = []
        self._seq = itertools.count()
        self._lock = threading.Lock()

    @property
    def active(self) -> bool:
        """True when anyone is listening — publishers use this to skip
        event assembly entirely on the silent path."""
        return bool(self._subs or self._callbacks)

    def subscribe(self, maxlen: int = 4096) -> Subscription:
        """A new independent subscription (bounded at `maxlen`)."""
        sub = Subscription(self, maxlen)
        with self._lock:
            self._subs.append(sub)
        return sub

    def attach(self, callback: Callable[[Event], None]):
        """Register a synchronous push callback; returns it (pass to
        `detach` to remove).  Exceptions propagate to the publisher —
        a hook that raises aborts the scheduler tick that fired it."""
        with self._lock:
            self._callbacks.append(callback)
        return callback

    def detach(self, callback) -> None:
        with self._lock:
            if callback in self._callbacks:
                self._callbacks.remove(callback)

    def _drop(self, sub: Subscription) -> None:
        with self._lock:
            if sub in self._subs:
                self._subs.remove(sub)

    def publish(self, kind: str, tick: int, rid: Optional[str] = None,
                **data) -> Optional[Event]:
        """Deliver one event to every subscription and callback; the
        assigned `seq` makes publish order observable.  No-op (returns
        None) when nothing is listening."""
        if not self.active:
            return None
        ev = Event(kind=kind, seq=next(self._seq), tick=tick, rid=rid,
                   data=data)
        for sub in list(self._subs):
            sub._push(ev)
        for cb in list(self._callbacks):
            cb(ev)
        return ev
