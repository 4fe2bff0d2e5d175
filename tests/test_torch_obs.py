"""The port's observability layer against the JAX package's `repro.obs`.

The metrics module is a copy: the same operations must render the same
Prometheus text and JSON snapshot, and the port's engine must account
calls, retired samples and program shapes exactly as the reference
engine does.  The tracer must keep the Chrome trace-event schema, with
device spans entering `torch.profiler.record_function`.
"""
import json

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.engine import StreamEngine as JEngine
from repro.fixedpoint import QFormat as JQ
from repro_torch import obs as tobs
from repro_torch.engine import StreamEngine as TEngine
from repro_torch.fixedpoint import QFormat as TQ

torch.set_num_threads(2)


def _exercise(mod):
    reg = mod.MetricsRegistry()
    c = reg.counter("sched_ticks_total", "scheduler ticks", ("sched",))
    c.labels(sched="s0").inc(7)
    c.labels(sched='s"1').inc(0.5)
    reg.gauge("pool_occupancy").set(3)
    h = reg.histogram("wall_ms", "wall", buckets=(1.0, 10.0))
    h.observe(0.5)
    h.observe(10.0, weight=2)
    t = reg.histogram("ticks", "t", ("cls",), buckets=mod.TICK_BUCKETS)
    for v in (0, 1, 3, 17, 5000):
        t.labels(cls="bulk").observe(v)
    lat = reg.histogram("lat_ms", buckets=mod.LATENCY_MS_BUCKETS)
    for v in (0.07, 0.3, 2.0, 40.0):
        lat.observe(v, weight=3)
    return reg


def test_prometheus_text_and_snapshot_equal_reference():
    j, t = _exercise(jobs), _exercise(tobs)
    assert t.to_text() == j.to_text()
    assert json.dumps(t.snapshot()) == json.dumps(j.snapshot())
    assert tobs.LATENCY_MS_BUCKETS == jobs.LATENCY_MS_BUCKETS
    assert tobs.TICK_BUCKETS == jobs.TICK_BUCKETS


def test_registry_errors_match_reference():
    for mod in (jobs, tobs):
        reg = mod.MetricsRegistry()
        reg.counter("x_total", "x", ("a",))
        with pytest.raises(ValueError):
            reg.gauge("x_total")
        with pytest.raises(ValueError):
            reg.counter("x_total", "x", ("a",)).labels(a="1").inc(-1)


@pytest.mark.parametrize("tname,jname", [("cuda-q", "pallas-q"),
                                         ("scan", "scan")])
def test_engine_metrics_equal_reference(tname, jname):
    x = np.random.default_rng(0).normal(size=(16, 6)).astype(np.float32)
    jreg, treg = jobs.MetricsRegistry(), tobs.MetricsRegistry()
    jeng = JEngine(6, jname, fmt=JQ(32, 20), block_t=16, registry=jreg,
                   name="e0")
    teng = TEngine(6, tname, device="cpu", fmt=TQ(32, 20), registry=treg,
                   name="e0")
    for eng in (jeng, teng):
        eng.process(x)
        eng.detach([1])
        eng.process(x[:8], valid_lens=np.array([8, 8, 3, 0, 8, 1]))
        eng.process(x, active=[0, 2])
    assert treg.to_text() == jreg.to_text()
    assert "engine_samples_retired_total" in treg.to_text()


def test_chrome_trace_schema_and_device_spans():
    tr = tobs.TickTracer(capacity=64, annotate_device=True)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        with tr.span("dispatch", device=True, tick=1, t=8):
            torch.ones(4).sum()
    tr.instant("pool.resize", frm=4, to=8)
    doc = tr.to_chrome_trace()
    json.loads(json.dumps(doc))
    assert set(doc) == {"traceEvents", "displayTimeUnit", "otherData"}
    assert doc["otherData"] == {"recorded": 2, "dropped": 0}
    span = next(e for e in doc["traceEvents"] if e["name"] == "dispatch")
    assert span["ph"] == "X" and span["dur"] >= 0
    assert {"pid", "tid", "ts"} <= set(span)
    assert span["args"] == {"tick": 1, "t": 8}
    inst = next(e for e in doc["traceEvents"]
                if e["name"] == "pool.resize")
    assert inst["ph"] == "i" and "dur" not in inst
    assert "dispatch" in {e.key for e in prof.key_averages()}


def test_tracer_ring_and_null_tracer():
    tr = tobs.TickTracer(capacity=8)
    for i in range(20):
        tr.instant(f"ev{i}", i=i)
    assert (len(tr), tr.total, tr.dropped) == (8, 20, 12)
    assert [e["name"] for e in tr.events()] == [f"ev{i}"
                                               for i in range(12, 20)]
    assert tobs.NULL_TRACER.enabled is False
    with tobs.NULL_TRACER.span("x", device=True):
        pass
    assert tobs.NULL_TRACER.to_chrome_trace()["traceEvents"] == []
    eng = TEngine(4, "scan", device="cpu", tracer=tr)
    eng.process(np.zeros((3, 4), np.float32))
    assert [e["name"] for e in tr.events()][-1] == "engine.compile"
