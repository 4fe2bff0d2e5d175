"""The port's event bus against the JAX package's, on the CPU.

`repro_torch.obs.events` is pure Python; the bus is held against the
reference's on the same publish sequence (kinds, sequence numbers,
payloads), and the scheduler's event stream against both the port's own
`results()` and the reference scheduler's stream on the same workload:
on the Q path ("cuda-q" against "pallas-q") every payload is bit-exact.
"""
import json

import numpy as np

from repro.fixedpoint import QFormat as JQ
from repro.launch.batching import BatchingScheduler as JSched
from repro.launch.batching import Request as JRequest
from repro.launch.serve import serve_streams as j_serve_streams
from repro.obs import EventBus as JBus
from repro_torch.fixedpoint import QFormat as TQ
from repro_torch.launch.batching import BatchingScheduler, Request
from repro_torch.launch.serve import serve_streams
from repro_torch.obs import Event, EventBus, Subscription

SPEC = (32, 20)
SCHED = dict(buckets=(2, 4), chunk_t=8)


def test_event_bus_pubsub_and_drop_oldest():
    bus = EventBus()
    assert not bus.active
    assert bus.publish("done", 0, "r0") is None  # silent path: no-op
    sub = bus.subscribe(maxlen=3)
    assert isinstance(sub, Subscription) and bus.active
    for i in range(5):
        bus.publish("admitted", i, f"r{i}", slot=i)
    evs = sub.poll()
    assert [e.rid for e in evs] == ["r2", "r3", "r4"]  # oldest dropped
    assert sub.dropped == 2
    assert [e.seq for e in evs] == sorted(e.seq for e in evs)
    assert evs[0].data == {"slot": 2}
    assert sub.poll() == []  # drained
    sub.close()
    bus.publish("done", 9, "rX")
    assert sub.poll() == [] and not bus.active


def test_event_bus_attach_callback_and_iter():
    bus = EventBus()
    seen = []
    cb = bus.attach(seen.append)
    with bus.subscribe() as sub:
        bus.publish("a", 1)
        bus.publish("b", 2)
        assert [e.kind for e in sub] == ["a", "b"]
    assert [e.kind for e in seen] == ["a", "b"]
    assert all(isinstance(e, Event) for e in seen)
    bus.detach(cb)
    bus.publish("c", 3)
    assert len(seen) == 2


def test_event_bus_equals_jax_bus():
    """One publish/subscribe/close sequence on both buses: the same
    events reach the same subscribers, with the same drop counts."""
    def drive(bus):
        seen = []
        bus.attach(seen.append)
        small, big = bus.subscribe(maxlen=2), bus.subscribe()
        for i in range(6):
            bus.publish("chunk_retired", i, f"r{i % 3}", n=i,
                        flags=i % 2)
            if i == 3:
                small.close()

        def rows(evs):
            return [(e.kind, e.seq, e.tick, e.rid, e.data) for e in evs]

        return (rows(seen), rows(small.poll()), small.dropped,
                rows(list(big)), big.dropped)

    assert drive(EventBus()) == drive(JBus())


# ----------------------------------------- scheduler/pool integration
def _specs(n, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(n):
        h = rng.normal(size=(int(rng.integers(4, 20)),)).astype(np.float32)
        lv = rng.normal(size=(int(rng.integers(1, 6)),)).astype(np.float32)
        lv[len(lv) // 2] += 12.0  # guarantee some flags
        out[f"r{i}"] = (h, lv)
    return out


def _run_workload(sched, specs, request):
    """Submit, trickle-feed, close and drain a {rid: (hist, live)} mix."""
    for rid, (h, live) in specs.items():
        assert sched.submit(request(rid, h, m=2.5))
    fed = {rid: 0 for rid in specs}
    for _ in range(200):
        for rid, (h, live) in specs.items():
            if fed[rid] < len(live) and rid in sched.stats_by_rid:
                sched.feed(rid, live[fed[rid]:fed[rid] + 1])
                fed[rid] += 1
            if fed[rid] == len(live) and rid in sched.runs \
                    and not sched.runs[rid].req.closed:
                sched.close(rid)
        sched.step()
        if sched.completed == len(specs):
            return
    raise AssertionError("workload did not drain")


def test_event_stream_matches_results_and_jax_bit_exact():
    """The ordering contract on the Q path: concatenating a request's
    `chunk_retired` payloads reproduces `results()` bit for bit, the
    streamed counts sum to its telemetry, its `done` event is its last;
    and the whole stream equals the reference scheduler's."""
    specs = _specs(4, seed=3)
    sched = BatchingScheduler("cuda-q", device="cpu", fmt=TQ(*SPEC),
                              collect=True, **SCHED)
    sub = sched.subscribe()
    _run_workload(sched, specs, Request)
    evs = sub.poll()
    assert [e.seq for e in evs] == sorted(e.seq for e in evs)
    assert {"admitted", "chunk_retired", "done"} <= {e.kind for e in evs}
    for rid in specs:
        chunks = [e for e in evs
                  if e.kind == "chunk_retired" and e.rid == rid]
        res = sched.results(rid)
        np.testing.assert_array_equal(
            np.concatenate([e.data["outlier"] for e in chunks]),
            res["outlier"], err_msg=rid)
        np.testing.assert_array_equal(
            np.concatenate([e.data["ecc"] for e in chunks]), res["ecc"],
            err_msg=rid)
        st = sched.telemetry(rid)
        assert sum(e.data["flags"] for e in chunks) == st.flags > 0
        assert sum(e.data["n"] for e in chunks) == st.samples
        done = next(e for e in evs if e.kind == "done" and e.rid == rid)
        assert (done.data["samples"], done.data["flags"]) == (
            st.samples, st.flags)
        assert done.seq == max(e.seq for e in evs if e.rid == rid)

    ref = JSched("pallas-q", fmt=JQ(*SPEC), collect=True, **SCHED)
    jsub = ref.subscribe()
    _run_workload(ref, specs, JRequest)
    jevs = jsub.poll()
    assert [(e.kind, e.seq, e.tick, e.rid) for e in evs] == [
        (e.kind, e.seq, e.tick, e.rid) for e in jevs]
    for e, j in zip(evs, jevs):
        assert sorted(e.data) == sorted(j.data), e
        for key, val in e.data.items():
            np.testing.assert_array_equal(np.asarray(val),
                                          np.asarray(j.data[key]))


def test_serve_streams_on_event_and_metrics():
    """`serve_streams(on_event=)` pushes every event in publish order,
    the metrics snapshot is JSON, and the done events and completion
    counts equal the reference gateway's."""
    rng = np.random.default_rng(2)
    streams = [(f"t{i}", rng.normal(size=10).astype(np.float32),
                rng.normal(size=3).astype(np.float32), 2.5)
               for i in range(3)]
    kw = dict(queue_limit=4, **SCHED)
    seen, jseen = [], []
    res = serve_streams(streams, backend="scan", device="cpu",
                        on_event=seen.append, **kw)
    j_serve_streams(streams, backend="scan", on_event=jseen.append, **kw)
    assert res["requests"] == 3
    done = [(e.rid, e.tick, e.data) for e in seen if e.kind == "done"]
    assert sorted(r for r, _, _ in done) == ["t0", "t1", "t2"]
    assert done == [(e.rid, e.tick, e.data) for e in jseen
                    if e.kind == "done"]
    assert [e.seq for e in seen] == sorted(e.seq for e in seen)
    assert [e.kind for e in seen] == [e.kind for e in jseen]
    snap = res["metrics"]
    assert snap["sched_completed_total"]["samples"][0]["value"] == 3.0
    assert snap["sched_call_wall_ms"]["samples"][0]["count"] > 0
    json.dumps(snap)
