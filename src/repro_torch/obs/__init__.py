"""repro_torch.obs — dependency-free observability for the engine.

  * `metrics` — Counter/Gauge/Histogram instruments with labels in a
    `MetricsRegistry` (JSON snapshot + Prometheus text exposition).
  * `trace` — `TickTracer`, a bounded ring buffer of span events
    exportable as Chrome trace-event JSON; `NULL_TRACER` is the free
    disabled default.
"""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     LATENCY_MS_BUCKETS, MetricsRegistry,
                                     TICK_BUCKETS, auto_name, get_registry)
from repro_torch.obs.trace import NULL_TRACER, NullTracer, TickTracer

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "get_registry",
    "auto_name", "LATENCY_MS_BUCKETS", "TICK_BUCKETS",
    "TickTracer", "NullTracer", "NULL_TRACER",
]
