"""Dependency-free metrics registry: Counter / Gauge / Histogram.

The paper validates its pipeline with measured occupation and
throughput tables; the serving stack deserves the same rigor about
itself.  This module is the first-class replacement for the ad-hoc
integer attributes the scheduler/pool/engine used to keep behind
`stats()`: Prometheus-shaped instruments (monotonic counters, gauges,
fixed-bucket histograms, all with label axes) collected in a
`MetricsRegistry` that snapshots to plain-JSON dicts and renders
Prometheus text exposition — with zero third-party dependencies, so it
runs wherever the kernels do.

Design points that differ from a full Prometheus client, on purpose:

  * `Histogram.observe(value, weight=)` takes a weight: the serving
    scheduler weights each fused-call wall time by the samples the
    call retired, so a 1-sample decode tick does not count the same
    as a full prefill chunk, at O(1) per `stats()` read.
  * `Histogram.quantile(q)` gives a weighted nearest-rank estimate
    over the bucket upper edges (exact whenever observations land on
    bucket edges).
  * Instruments are get-or-create: registering the same name twice
    with the same type/labels returns the same instrument; a
    conflicting re-registration raises.

Components take an injectable `registry=` (default: a private
registry per component, so two schedulers never mix values) and label
every instrument with their instance name; `get_registry()` returns
the process-global default for apps that want one scrape surface.
"""
from __future__ import annotations

import itertools
import threading
from collections import defaultdict
from typing import Dict, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "get_registry", "auto_name", "LATENCY_MS_BUCKETS",
           "TICK_BUCKETS"]

# fused-call wall times in milliseconds: log-ish spacing from 50us
# (warm interpret-mode decode ticks) to 5s (cold compiles)
LATENCY_MS_BUCKETS: Tuple[float, ...] = (
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
    100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0)

# tick-valued quantities (queue waits, request latencies): exact for
# small integer values, log-spaced past 16 so the vector stays short
TICK_BUCKETS: Tuple[float, ...] = (
    0.0, 1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0, 24.0, 32.0, 48.0,
    64.0, 96.0, 128.0, 192.0, 256.0, 384.0, 512.0, 768.0, 1024.0,
    1536.0, 2048.0)

_instance_seq: Dict[str, itertools.count] = defaultdict(itertools.count)


def auto_name(kind: str) -> str:
    """Process-unique instance name for a component kind
    (``sched0``, ``sched1``, ``pool0``, ...) — the label value that
    keeps two components' series apart in a shared registry."""
    return f"{kind}{next(_instance_seq[kind])}"


def _fmt(v: float) -> str:
    """Exposition number format: integral floats print as ints."""
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


def _escape(v) -> str:
    return (str(v).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


class _Child:
    """One labelled series of a metric family."""

    __slots__ = ("_lock",)

    def __init__(self):
        self._lock = threading.Lock()


class _CounterChild(_Child):
    __slots__ = ("_value",)

    def __init__(self):
        super().__init__()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counters only go up, got inc({amount})")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class _GaugeChild(_Child):
    __slots__ = ("_value",)

    def __init__(self):
        super().__init__()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        return self._value


class _HistogramChild(_Child):
    __slots__ = ("_uppers", "_counts", "_sum", "_count", "_max")

    def __init__(self, uppers: Tuple[float, ...]):
        super().__init__()
        self._uppers = uppers                 # finite, sorted
        self._counts = [0.0] * (len(uppers) + 1)  # + the +Inf bucket
        self._sum = 0.0
        self._count = 0.0
        self._max = 0.0

    def observe(self, value: float, weight: float = 1.0) -> None:
        """Record `value` with multiplicity `weight` (weight must be
        positive; le edges are inclusive, Prometheus-style)."""
        if weight <= 0:
            raise ValueError(f"observation weight must be > 0: {weight}")
        value = float(value)
        # first bucket whose upper edge >= value (bisect is overkill
        # for <= ~23 edges and this keeps the hot path allocation-free)
        idx = len(self._uppers)
        for i, ub in enumerate(self._uppers):
            if value <= ub:
                idx = i
                break
        with self._lock:
            self._counts[idx] += weight
            self._sum += value * weight
            self._count += weight
            if value > self._max:
                self._max = value

    @property
    def count(self) -> float:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def quantile(self, q: float) -> float:
        """Weighted nearest-rank quantile estimated at bucket upper
        edges: the first bucket whose cumulative weight fraction
        reaches `q` (the searchsorted rule the scheduler's old exact
        computation used).  Observations in the +Inf bucket report the
        maximum value seen.  Exact whenever observations equal bucket
        edges; 0.0 on an empty histogram."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must lie in [0, 1], got {q}")
        with self._lock:
            total = self._count
            if total == 0:
                return 0.0
            cum = 0.0
            for i, c in enumerate(self._counts):
                cum += c
                if cum / total >= q:
                    if i < len(self._uppers):
                        return float(self._uppers[i])
                    return float(self._max)
            return float(self._max)  # fp slack: the tail is the max

    def buckets(self):
        """[(upper_edge, cumulative_count), ...] ending at +Inf."""
        out, cum = [], 0.0
        with self._lock:
            for ub, c in zip(self._uppers, self._counts):
                cum += c
                out.append((ub, cum))
            out.append((float("inf"), cum + self._counts[-1]))
        return out


class _Family:
    """A named metric family: children keyed by label values."""

    kind = "untyped"
    _child_cls = _Child

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._children: Dict[tuple, _Child] = {}
        self._lock = threading.Lock()

    def _make_child(self) -> _Child:
        return self._child_cls()

    def labels(self, **labelvalues):
        """The child series for this exact label assignment (created
        on first use); label names must match the family's axes."""
        if set(labelvalues) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {tuple(sorted(labelvalues))}")
        key = tuple(str(labelvalues[k]) for k in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._make_child()
                self._children[key] = child
        return child

    def _default_child(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} has label axes {self.labelnames}; "
                "use .labels(...)")
        return self.labels()

    def series(self):
        """[(labels_dict, child), ...] in creation order."""
        with self._lock:
            items = list(self._children.items())
        return [(dict(zip(self.labelnames, key)), ch)
                for key, ch in items]

    def signature(self) -> tuple:
        return (self.kind, self.labelnames)


class Counter(_Family):
    kind = "counter"
    _child_cls = _CounterChild

    def inc(self, amount: float = 1.0) -> None:
        self._default_child().inc(amount)

    @property
    def value(self) -> float:
        return self._default_child().value


class Gauge(_Family):
    kind = "gauge"
    _child_cls = _GaugeChild

    def set(self, value: float) -> None:
        self._default_child().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._default_child().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default_child().dec(amount)

    @property
    def value(self) -> float:
        return self._default_child().value


class Histogram(_Family):
    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = LATENCY_MS_BUCKETS):
        super().__init__(name, help, labelnames)
        ub = tuple(sorted(float(b) for b in buckets
                          if b != float("inf")))
        if not ub or len(set(ub)) != len(ub):
            raise ValueError(f"bad histogram buckets: {buckets}")
        self.bucket_uppers = ub

    def _make_child(self) -> _HistogramChild:
        return _HistogramChild(self.bucket_uppers)

    def observe(self, value: float, weight: float = 1.0) -> None:
        self._default_child().observe(value, weight)

    def quantile(self, q: float) -> float:
        return self._default_child().quantile(q)

    @property
    def count(self) -> float:
        return self._default_child().count

    @property
    def sum(self) -> float:
        return self._default_child().sum

    def signature(self) -> tuple:
        return (self.kind, self.labelnames, self.bucket_uppers)


class MetricsRegistry:
    """Instrument container with get-or-create registration, a plain
    JSON snapshot, and Prometheus text exposition.

    >>> reg = MetricsRegistry()
    >>> ticks = reg.counter("sched_ticks_total", "ticks", ("sched",))
    >>> ticks.labels(sched="sched0").inc()
    >>> reg.snapshot()["sched_ticks_total"]["samples"]
    [{'labels': {'sched': 'sched0'}, 'value': 1.0}]
    """

    def __init__(self):
        self._families: Dict[str, _Family] = {}
        self._lock = threading.Lock()

    def _register(self, cls, name: str, help: str, labelnames,
                  **kwargs) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = cls(name, help, labelnames, **kwargs)
                self._families[name] = fam
                return fam
        new_sig = cls(name, help, labelnames, **kwargs).signature()
        if fam.signature() != new_sig:
            raise ValueError(
                f"metric {name!r} already registered as "
                f"{fam.signature()}, conflicting with {new_sig}")
        return fam

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._register(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = LATENCY_MS_BUCKETS
                  ) -> Histogram:
        return self._register(Histogram, name, help, labelnames,
                              buckets=buckets)

    def get(self, name: str) -> Optional[_Family]:
        return self._families.get(name)

    def __contains__(self, name: str) -> bool:
        return name in self._families

    # ---------------------------------------------------- exposition
    def snapshot(self) -> dict:
        """Every family as plain JSON-ready dicts (sorted by name):
        counters/gauges carry ``value`` per series, histograms carry
        ``count`` / ``sum`` / cumulative ``buckets`` plus the p50/p95
        nearest-rank estimates."""
        out = {}
        for name in sorted(self._families):
            fam = self._families[name]
            samples = []
            for labels, ch in fam.series():
                if fam.kind == "histogram":
                    samples.append({
                        "labels": labels, "count": ch.count,
                        "sum": ch.sum,
                        "p50": ch.quantile(0.5),
                        "p95": ch.quantile(0.95),
                        "buckets": [["+Inf" if ub == float("inf")
                                     else ub, c]
                                    for ub, c in ch.buckets()]})
                else:
                    samples.append({"labels": labels,
                                    "value": ch.value})
            out[name] = {"type": fam.kind, "help": fam.help,
                         "labelnames": list(fam.labelnames),
                         "samples": samples}
        return out

    def to_text(self) -> str:
        """Prometheus text exposition format (the scrape payload)."""
        lines = []
        for name in sorted(self._families):
            fam = self._families[name]
            if fam.help:
                lines.append(f"# HELP {name} {_escape(fam.help)}")
            lines.append(f"# TYPE {name} {fam.kind}")
            for labels, ch in fam.series():
                base = ",".join(f'{k}="{_escape(v)}"'
                                for k, v in labels.items())
                if fam.kind == "histogram":
                    for ub, cum in ch.buckets():
                        le = "+Inf" if ub == float("inf") else _fmt(ub)
                        lbl = (base + "," if base else "") + f'le="{le}"'
                        lines.append(
                            f"{name}_bucket{{{lbl}}} {_fmt(cum)}")
                    sfx = f"{{{base}}}" if base else ""
                    lines.append(f"{name}_sum{sfx} {_fmt(ch.sum)}")
                    lines.append(f"{name}_count{sfx} {_fmt(ch.count)}")
                else:
                    sfx = f"{{{base}}}" if base else ""
                    lines.append(f"{name}{sfx} {_fmt(ch.value)}")
        return "\n".join(lines) + ("\n" if lines else "")


_DEFAULT_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-global default registry — pass it as `registry=` to
    components that should share one scrape surface (components default
    to a private registry so independent instances never mix values)."""
    return _DEFAULT_REGISTRY
