"""The port's continuous-batching scheduler against the JAX package's.

The same request schedule goes through the port's `BatchingScheduler`
(`device="cpu"`: the kernel backends run their plain versions) and the
reference's: "cuda-q" against "pallas-q" is bit-exact (per-request
verdicts, telemetry, `stats()` with its program shapes), "cuda" against
"pallas" holds rtol 5e-4 / atol 1e-5 with equal flags.  The port's own
behaviours are pinned as the reference's tests pin them: interleaved
equals isolated, the async loop and depth-N pipelines equal the sync
loop bit for bit, one fused call per tick with per-slot valid lengths,
the short decode program, backpressure, weighted admission, lifecycle
errors and the retention caps.
"""
from collections import deque
from contextlib import contextmanager

import numpy as np
import pytest

from conftest import given_or_cases

from repro.fixedpoint import QFormat as JQ
from repro.launch.batching import BatchingScheduler as JSched
from repro.launch.batching import Request as JRequest
from repro_torch.engine import StreamEngine
from repro_torch.fixedpoint import QFormat as TQ
from repro_torch.launch import batching
from repro_torch.launch.batching import (BatchingScheduler, EvictedRequest,
                                         Request, _host_ready)

SPEC = (32, 20)
FMT = TQ(*SPEC)
RTOL, ATOL = 5e-4, 1e-5
PAIRS = [("scan", "scan"), ("cuda", "pallas"), ("cuda-q", "pallas-q")]


def _mk_sched(backend, **kw):
    kw.setdefault("buckets", (2, 4))
    kw.setdefault("chunk_t", 8)
    return BatchingScheduler(backend, device="cpu", fmt=FMT, **kw)


def _workload(n, seed):
    """n requests: ragged history/live lengths, a burst, mixed m."""
    rng = np.random.default_rng(seed)
    specs = {}
    for i in range(n):
        h = rng.normal(size=(int(rng.integers(0, 30)),)).astype(np.float32)
        live = rng.normal(size=(int(rng.integers(0, 10)),)).astype(
            np.float32)
        if live.size and i % 3 == 0:
            live[live.size // 2] += 25.0
        specs[f"r{i}"] = (h, live, [1.5, 3.0, 6.0][i % 3])
    return specs


def _serve(sched, specs, prios=None, request=Request, check_fence=False,
           max_ticks=800):
    """Staggered submits (one per tick), live fed one sample per tick;
    optionally assert the fencing invariant (a slot in at most one
    in-flight call) after every tick."""
    order = list(specs)
    fed = {rid: 0 for rid in specs}
    closed = set()
    for tick in range(max_ticks):
        if tick < len(order):
            rid = order[tick]
            h, live, m = specs[rid]
            prio = (prios or {}).get(rid, "default")
            assert sched.submit(request(rid, h, m=m, priority=prio))
            if not live.size:
                sched.close(rid)
                closed.add(rid)
        for rid, (h, live, m) in specs.items():
            if rid not in sched.stats_by_rid or rid in closed:
                continue
            if fed[rid] < live.size:
                sched.feed(rid, live[fed[rid]:fed[rid] + 1])
                fed[rid] += 1
            if fed[rid] == live.size:
                sched.close(rid)
                closed.add(rid)
        sched.step()
        if check_fence:
            slots = [s for inf in sched._inflight
                     for _, s, _ in inf.members]
            assert len(slots) == len(set(slots)), \
                f"slot fenced twice in flight at tick {tick}: {slots}"
            assert len(sched._inflight) <= sched.pipeline_depth + 1
        if sched.completed == len(specs):
            return sched
    raise AssertionError(f"did not drain: {sched.stats()}")


@contextmanager
def _landing(every):
    """On the CPU a call's outputs have landed when `process` returns, so
    a deep pipeline would retire every call at once.  The pipeline tests
    let only the calls dispatched on every `every`-th tick count as
    landed: the others stay in flight, so the fence, out-of-order
    retirement and the depth cap all act."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(batching, "_host_ready",
                   lambda inf: inf.tick % every == 0)
        yield


def _same_results(a, b, specs, exact=True):
    for rid in specs:
        ra, rb = a.results(rid), b.results(rid)
        np.testing.assert_array_equal(ra["outlier"], rb["outlier"],
                                      err_msg=rid)
        if exact:
            np.testing.assert_array_equal(ra["ecc"], rb["ecc"], err_msg=rid)
        else:
            np.testing.assert_allclose(ra["ecc"], rb["ecc"], rtol=RTOL,
                                       atol=ATOL, err_msg=rid)
        ta, tb = a.telemetry(rid), b.telemetry(rid)
        assert (ta.samples, ta.flags) == (tb.samples, tb.flags), rid


def _telemetry_row(st):
    return (st.rid, st.submitted_tick, st.priority, st.admitted_tick,
            st.done_tick, st.slot, st.shard, st.migrations, st.samples,
            st.flags, st.prefill_chunks, st.decode_steps,
            [n for _, n in st.chunk_latency_s])


# ------------------------------------------- the reference's schedule
@pytest.mark.parametrize("tname,jname", PAIRS)
def test_interleaved_equals_isolated_and_jax(tname, jname):
    """The same staggered schedule through both schedulers: equal
    verdicts (Q exact, float within tolerance, flags equal), equal
    telemetry and equal aggregate stats, program shapes included; and
    every request equals itself run alone on a fresh port engine."""
    q = tname == "cuda-q"
    specs = _workload(5, seed=0)
    prios = {rid: ("latency" if i % 2 else "bulk")
             for i, rid in enumerate(specs)}
    weights = {"latency": 3.0, "bulk": 1.0}
    port = _serve(_mk_sched(tname, measure_latency=True,
                            class_weights=weights), specs, prios)
    ref = _serve(JSched(jname, fmt=JQ(*SPEC), buckets=(2, 4), chunk_t=8,
                        measure_latency=True, class_weights=weights),
                 specs, prios, request=JRequest)
    _same_results(port, ref, specs, exact=q)
    for rid in specs:
        assert _telemetry_row(port.telemetry(rid)) == _telemetry_row(
            ref.telemetry(rid))
    ps, js = port.stats(), ref.stats()
    for key in ("ticks", "completed", "running", "queued",
                "rejected_submits", "inflight_calls", "pipeline_depth",
                "short_ticks", "classes", "programs", "pool"):
        assert ps[key] == js[key], key
    assert ps["programs"] == [(2, 1), (2, 8), (4, 8)]

    for rid, (h, live, m) in specs.items():
        full = np.concatenate([h, live])
        res = port.results(rid)
        assert res["outlier"].shape[0] == full.size
        if not full.size:
            continue
        oracle = StreamEngine(1, tname, device="cpu", fmt=FMT, m=m)
        alone = oracle.process(full[:, None])
        np.testing.assert_array_equal(res["outlier"],
                                      alone["outlier"][:, 0].numpy())
        if q:  # the float chunks round differently from one long call
            np.testing.assert_array_equal(res["ecc"],
                                          alone["ecc"][:, 0].numpy())
        else:
            np.testing.assert_allclose(res["ecc"], alone["ecc"][:, 0].numpy(),
                                       rtol=RTOL, atol=ATOL)


@given_or_cases(
    "n,seed,depth", [(5, 0, 2), (4, 1, 4), (6, 2, 3)],
    lambda st: dict(n=st.integers(2, 7), seed=st.integers(0, 2 ** 16),
                    depth=st.integers(2, 4)),
    max_examples=12)
def test_async_and_deep_pipeline_equal_sync(n, seed, depth):
    """On the Q path the sync loop, the async double buffer and a
    depth-N pipeline give identical per-request verdicts and counts
    (scheduling reads host counters only), every request equals itself
    alone, and the fence holds every tick."""
    specs = _workload(n, seed)
    prios = {rid: ("latency" if i % 2 else "bulk")
             for i, rid in enumerate(specs)}
    kw = dict(class_weights={"latency": 3.0, "bulk": 1.0})
    sync = _serve(_mk_sched("cuda-q", measure_latency=True, **kw), specs,
                  prios)
    asyn = _serve(_mk_sched("cuda-q", **kw), specs, prios)
    with _landing(3):
        deep = _serve(_mk_sched("cuda-q", pipeline_depth=depth, **kw),
                      specs, prios, check_fence=True)
    _same_results(sync, asyn, specs)
    _same_results(sync, deep, specs)
    for rid, (h, live, m) in specs.items():
        full = np.concatenate([h, live])
        if full.size:
            alone = StreamEngine(1, "cuda-q", device="cpu", fmt=FMT,
                                 m=m).process(full[:, None])
            np.testing.assert_array_equal(sync.results(rid)["ecc"],
                                          alone["ecc"][:, 0].numpy())


def test_admission_during_pool_resize_tick_matches_jax():
    """A request admitted in a tick where the pool grows a bucket —
    while the previous tick's call is still in flight — is served
    bit-exactly: in-flight outputs keep their dispatch-time slots and
    the re-padded state is exact (Q path, both packages)."""
    rng = np.random.default_rng(9)
    hs = {f"r{i}": rng.normal(size=(20,)).astype(np.float32)
          for i in range(3)}
    port = _mk_sched("cuda-q")
    ref = JSched("pallas-q", fmt=JQ(*SPEC), buckets=(2, 4), chunk_t=8)
    for sched, req in ((port, Request), (ref, JRequest)):
        sched.submit(req("r0", hs["r0"]))
        sched.submit(req("r1", hs["r1"]))
        sched.step()                       # bucket 2, call in flight
        assert sched.stats()["inflight_calls"] == 1
        sched.submit(req("r2", hs["r2"]))
        sched.step()                       # grows 2 -> 4 mid-tick
        assert sched.pool.stats()["resizes"] == 1
        for rid in hs:
            sched.close(rid)
        sched.drain()
    _same_results(port, ref, hs)
    for rid, h in hs.items():
        alone = StreamEngine(1, "cuda-q", device="cpu",
                             fmt=FMT).process(h[:, None])
        np.testing.assert_array_equal(port.results(rid)["ecc"],
                                      alone["ecc"][:, 0].numpy())


# ----------------------------------------------- one fused call per tick
def test_prefill_tail_retires_in_ceil_ticks():
    """A 30-sample history on chunk_t=8 retires in ceil(30/8) = 4 fused
    calls: the 6-sample tail rides the same (chunk_t, C) call via its
    per-slot valid length."""
    sched = _mk_sched("scan")
    h = np.random.default_rng(0).normal(size=(30,)).astype(np.float32)
    sched.submit(Request("a", h))
    sched.close("a")
    assert sched.drain() == 4
    st = sched.telemetry("a")
    assert (st.samples, st.prefill_chunks, st.decode_steps) == (30, 4, 0)
    assert {c["kind"] for c in sched.call_log} == {"fused"}
    assert all(c["t"] == 8 for c in sched.call_log)
    assert [c["retired"] for c in sched.call_log] == [8, 8, 8, 6]


def test_mixed_prefill_decode_slots_share_one_call():
    sched = _mk_sched("scan")
    h = np.random.default_rng(1).normal(size=(20,)).astype(np.float32)
    sched.submit(Request("big", h))        # prefill-heavy
    sched.submit(Request("drip"))          # decode-phase, fed 1/tick
    sched.close("big")
    for i in range(3):
        sched.feed("drip", [float(i)])
        sched.step()
    log = list(sched.call_log)
    assert [c["slots"] for c in log] == [2, 2, 2]
    assert [c["retired"] for c in log] == [9, 9, 5]  # 8+1, 8+1, 4+1
    big, drip = sched.telemetry("big"), sched.telemetry("drip")
    assert big.samples == 20 and big.prefill_chunks == 3
    assert drip.samples == 3 and drip.decode_steps == 3


def test_adaptive_decode_short_program():
    """Decode-only ticks ride the (decode_t, C) shape and the shape set
    stays flat after warmup, as in the reference."""
    sched = _mk_sched("scan", decode_t=1)
    h = np.random.default_rng(3).normal(size=(10,)).astype(np.float32)
    sched.submit(Request("a", h))
    sched.step()                           # prefill: avail 10 -> chunk
    sched.step()                           # tail 2 > decode_t -> chunk
    for i in range(5):                     # decode trickle: avail 1
        sched.feed("a", [float(i)])
        sched.step()
    sched.close("a")
    sched.drain()
    log = list(sched.call_log)
    assert [c["t"] for c in log] == [8, 8, 1, 1, 1, 1, 1]
    assert [c["retired"] for c in log] == [8, 2, 1, 1, 1, 1, 1]
    assert sched.short_ticks == 5
    assert sched.stats()["programs"] == [(2, 1), (2, 8)]
    assert sched.telemetry("a").samples == 15


def test_cpu_outputs_are_ready_at_dispatch():
    """On the CPU a dispatched call carries no CUDA event and counts as
    landed, on a single pool and on each shard of a sharded one (whose
    calls name their shard)."""
    for shards in (1, 2):
        sched = _mk_sched("cuda-q", shards=shards)
        for rid in ("a", "b", "c"):
            sched.submit(Request(rid, np.ones((5,), np.float32)))
        sched.step()
        assert sched._inflight
        for inf in sched._inflight:
            assert inf.done is None and _host_ready(inf)
            assert inf.out["ecc"].device.type == "cpu"
            assert inf.shard == (None if shards == 1
                                 else inf.members[0][0].shard)
    assert len(sched._inflight) == len({r.shard for r in sched.runs.values()})
    with pytest.raises(ValueError, match="shards"):
        _mk_sched("scan", shards=0)


# ------------------------------------------------------- backpressure
def test_backpressure_queue_and_pool():
    """Full admission queue rejects; full pool queues; both explicit."""
    sched = _mk_sched("scan", buckets=(2,), queue_limit=2)
    h = np.zeros((4,), np.float32)
    for i in range(4):
        assert sched.submit(Request(f"r{i}", h)) == (i < 2)
    assert sched.rejected == 2
    sched.step()                           # admits r0, r1 (bucket 2)
    assert sched.submit(Request("r4", h))
    assert sched.submit(Request("r5", h))
    sched.step()
    assert len(sched.runs) == 2 and len(sched.queue) == 2
    for rid in ("r0", "r1", "r4", "r5"):
        sched.close(rid)
    sched.drain()
    assert sched.completed == 4


def test_priority_weighted_admission_no_starvation():
    sched = _mk_sched("scan", buckets=(2,), queue_limit=16,
                      class_weights={"bulk": 1.0, "latency": 3.0})
    h = np.zeros((4,), np.float32)
    for i in range(6):
        assert sched.submit(Request(f"b{i}", h, priority="bulk"))
        sched.close(f"b{i}")
    for i in range(2):
        assert sched.submit(Request(f"l{i}", h, priority="latency"))
        sched.close(f"l{i}")
    sched.drain()
    adm = {rid: sched.telemetry(rid).admitted_tick
           for rid in list(sched.stats_by_rid)}
    assert max(adm["l0"], adm["l1"]) <= 2
    assert max(adm[f"b{i}"] for i in range(6)) > 2
    classes = sched.stats()["classes"]
    assert classes["latency"]["completed"] == 2
    assert classes["bulk"]["completed"] == 6
    assert (classes["latency"]["queue_wait_ticks_p95"]
            <= classes["bulk"]["queue_wait_ticks_p95"])


def test_per_class_state_is_pruned_when_drained():
    sched = _mk_sched("scan", class_weights={"latency": 2.0})
    for i in range(8):
        sched.submit(Request(f"r{i}", np.zeros((2,), np.float32),
                             priority=f"tenant-{i}"))  # unique classes
        sched.close(f"r{i}")
    sched.drain()
    assert sched.completed == 8
    assert not sched._queues and not sched._deficit
    assert set(sched._weights) == {"latency"}   # ctor config retained


# --------------------------------------------------------- lifecycle
def test_results_and_feed_lifecycle_errors():
    sched = _mk_sched("scan")
    with pytest.raises(KeyError):
        sched.results("ghost")
    with pytest.raises(KeyError):
        sched.feed("ghost", [0.0])
    sched.submit(Request("a", np.zeros((3,), np.float32)))
    with pytest.raises(ValueError):
        sched.submit(Request("a"))         # duplicate rid
    sched.close("a")
    with pytest.raises(ValueError):
        sched.feed("a", [1.0])             # closed


def test_phase_transitions_and_empty_history():
    sched = _mk_sched("scan")
    sched.submit(Request("a", np.zeros((10,), np.float32)))
    sched.submit(Request("d"))
    assert sched.request_phase("a") == "queued"
    sched.step()                           # consumed 8 < 10
    assert sched.request_phase("a") == "prefill"
    assert sched.request_phase("d") == "decode"  # empty history
    sched.step()                           # consumed 10 >= 10
    assert sched.request_phase("a") == "decode"
    sched.feed("a", [1.0])
    sched.step()
    assert sched.request_phase("a") == "decode"
    sched.close("a")
    sched.close("d")
    sched.drain()
    assert sched.request_phase("a") == sched.request_phase("d") == "done"
    with pytest.raises(KeyError):
        sched.request_phase("ghost")


def test_drain_open_request_raises_helpfully():
    sched = _mk_sched("scan")
    sched.submit(Request("open-a", np.zeros((6,), np.float32)))
    with pytest.raises(RuntimeError, match=r"open-a.*close\(\)"):
        sched.drain()
    assert sched.tick_no < 10


def test_feed_after_close_on_queued_request():
    sched = _mk_sched("scan", buckets=(2,), queue_limit=4)
    for i in range(2):                     # occupy the whole pool
        sched.submit(Request(f"hold{i}", np.zeros((2,), np.float32)))
    sched.step()
    sched.submit(Request("q", np.zeros((2,), np.float32)))
    sched.step()                           # pool full: "q" stays queued
    assert sched.request_phase("q") == "queued"
    sched.close("q")
    with pytest.raises(ValueError, match="closed"):
        sched.feed("q", [1.0])
    for i in range(2):
        sched.close(f"hold{i}")
    sched.drain()
    assert sched.completed == 3


# ---------------------------------------------------- retention caps
def test_finished_retention_and_evicted_errors():
    sched = _mk_sched("scan", keep_finished=3)
    for i in range(6):
        sched.submit(Request(f"r{i}", np.zeros((2,), np.float32)))
        sched.close(f"r{i}")
    sched.drain()
    assert sched.completed == 6 and len(sched._finished) == 3
    sched.results("r5")                    # recent results retained
    for fn in (sched.results, sched.telemetry, sched.request_phase):
        with pytest.raises(EvictedRequest, match="keep_finished=3"):
            fn("r0")
        with pytest.raises(KeyError) as ei:
            fn("never-submitted")
        assert not isinstance(ei.value, EvictedRequest)
    sched.submit(Request("r0"))            # ...and its rid is reusable
    assert set(sched.stats_by_rid) == {"r3", "r4", "r5", "r0"}


def test_evicted_ring_survives_resubmit_cycle():
    sched = _mk_sched("scan", keep_finished=1)
    sched._evicted = deque(maxlen=2)            # tiny ring for rotation
    sched._note_evicted("a")
    sched._note_evicted("a")                    # evicted again (reuse)
    sched._note_evicted("b")                    # rotates the stale "a"
    with pytest.raises(EvictedRequest):
        sched.results("a")
    sched._note_evicted("c")                    # rotates the live "a"
    with pytest.raises(KeyError) as ei:
        sched.results("a")
    assert not isinstance(ei.value, EvictedRequest)


def test_call_and_latency_log_caps():
    """The call log is a ring (`call_log_len`) and the per-request
    latency log holds (wall, retired) pairs up to `latency_log_len`."""
    sched = _mk_sched("scan", chunk_t=2, call_log_len=5,
                      latency_log_len=3, measure_latency=True)
    sched.submit(Request("a", np.zeros((40,), np.float32)))
    sched.close("a")
    assert sched.drain() == 20             # 40 samples / chunk_t=2
    assert len(sched.call_log) == 5
    assert all(c["sync"] for c in sched.call_log)
    assert sched.stats()["chunk_latency"]["calls"] == 5
    st = sched.telemetry("a")
    assert st.samples == 40
    assert [n for _, n in st.chunk_latency_s] == [2, 2, 2]


# --------------------------------------------------- deep pipeline
def test_pipeline_fencing_under_slot_churn():
    """Completed requests release slots that new ones recycle while
    older calls may still be in flight: the fence holds every tick and
    results equal the depth-1 loop."""
    rng = np.random.default_rng(31)
    specs = {}
    for i in range(10):  # > 2x pool capacity: constant recycling
        h = rng.normal(size=(int(rng.integers(1, 12)),)).astype(
            np.float32)
        live = rng.normal(size=(int(rng.integers(0, 4)),)).astype(
            np.float32)
        specs[f"c{i}"] = (h, live, 3.0)
    base = _serve(_mk_sched("cuda-q"), specs)
    with _landing(5):
        deep = _serve(_mk_sched("cuda-q", pipeline_depth=4), specs,
                      check_fence=True)
    _same_results(base, deep, specs)


def test_pipeline_programs_flat_and_inflight_bounded():
    sched = _mk_sched("scan", chunk_t=4, pipeline_depth=3)
    rng = np.random.default_rng(5)
    for i in range(3):
        sched.submit(Request(
            f"w{i}", rng.normal(size=(9,)).astype(np.float32)))
    with _landing(1000):                   # nothing lands by itself
        for _ in range(6):  # warmup: chunk + decode shapes exercised
            sched.step()
            assert len(sched._inflight) <= 3
        assert sched._inflight
        warm = set(sched.stats()["programs"])
        for i in range(3):
            sched.feed(f"w{i}", rng.normal(size=(3,)).astype(np.float32))
            sched.close(f"w{i}")
        sched.drain()
    assert set(sched.stats()["programs"]) == warm
    assert sched.stats()["pipeline_depth"] == 3
    assert not sched._inflight


def test_pipeline_depth_validation_and_latency_override():
    with pytest.raises(ValueError):
        _mk_sched("scan", pipeline_depth=0)
    sched = _mk_sched("scan", pipeline_depth=4, measure_latency=True)
    sched.submit(Request("a", np.ones((20,), np.float32)))
    for _ in range(3):
        sched.step()
        assert sched.stats()["inflight_calls"] == 0
    assert all(c["sync"] for c in sched.call_log)
