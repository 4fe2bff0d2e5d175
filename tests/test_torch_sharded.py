"""The port's sharded fleet against the JAX package's, on the CPU.

Covered: the consistent-hash ring (the same rid -> shard assignment as
the JAX package's ring, bounded remapping on growth, removal moving only
the removed shard's keys); `ShardedPool` routing, validation, per-shard
`PoolFull`, live migration as raw words (k / mean / var, the ensemble's
aux column with planted NaN payloads compared as int32 words, m, the
detector rows), the rebalancer, metrics and events; THE contract — K
shards equal one pool bit for bit on "cuda-q" (the kernel's plain
version here) under a random migrate / detach / re-attach schedule; the
sharded `BatchingScheduler` against the port's single pool and against
the JAX package's sharded scheduler ("pallas-q" in interpret mode), its
fencing on (shard, slot) under a deep pipeline, and the gateway; and the
channel split over devices (`devices=["cpu", "cpu"]`, the CPU stand-in
for a list of cards) against the unsplit engine, pool and scheduler.
"""
from contextlib import contextmanager

import numpy as np
import pytest
import torch

from conftest import given_or_cases

from repro.engine import HashRing as JRing
from repro.engine import stable_hash as j_stable_hash
from repro.fixedpoint import QFormat as JQ
from repro.launch.batching import BatchingScheduler as JSched
from repro.launch.batching import Request as JRequest
from repro_torch.engine import (HashRing, PoolFull, ShardedPool, SlotPool,
                                StreamEngine, stable_hash)
from repro_torch.fixedpoint import QFormat as TQ
from repro_torch.launch import batching
from repro_torch.launch.batching import BatchingScheduler, Request
from repro_torch.launch.serve import serve_streams
from repro_torch.obs import EventBus, MetricsRegistry, TickTracer

SPEC = (32, 20)
FMT = TQ(*SPEC)
ALL5 = ("teda", "rde", "zscore", "hst", "teda-q")
CPU = dict(device="cpu", fmt=FMT)


def _pool(backend="scan", **kw):
    return ShardedPool(backend, **CPU, **kw)


# ------------------------------------------------------------ hash ring
def test_stable_hash_equals_reference():
    keys = ["tenant-a", "tenant-b", "", "x" * 300, "ünïcode"]
    assert [stable_hash(k) for k in keys] == [j_stable_hash(k) for k in keys]
    assert 0 <= stable_hash("x") < 2 ** 64


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_ring_assign_equals_reference(n):
    keys = [f"tenant-{i}" for i in range(2000)]
    mine, ref = HashRing(range(n)), JRing(range(n))
    assert [mine.assign(k) for k in keys] == [ref.assign(k) for k in keys]
    assert {mine.assign(k) for k in keys} == set(range(n))


@given_or_cases(
    "n,seed", [(2, 0), (4, 1), (8, 2)],
    lambda st: {"n": st.integers(2, 12), "seed": st.integers(0, 99)},
    max_examples=8)
def test_ring_grow_remaps_at_most_2_over_n(n, seed):
    keys = [f"stream-{seed}-{i}" for i in range(3000)]
    ring = HashRing(range(n))
    before = {k: ring.assign(k) for k in keys}
    ring.add(n)
    moved = [k for k in keys if ring.assign(k) != before[k]]
    assert len(moved) / len(keys) <= 2.0 / n
    assert all(ring.assign(k) == n for k in moved)


def test_ring_remove_only_moves_the_removed_shards_keys():
    ring = HashRing(range(4))
    keys = [f"r{i}" for i in range(1000)]
    before = {k: ring.assign(k) for k in keys}
    ring.remove(2)
    for k in keys:
        assert (ring.assign(k) == before[k]) if before[k] != 2 \
            else (ring.assign(k) != 2)
    assert ring.shards == (0, 1, 3)


def test_ring_validation():
    ring = HashRing(range(2))
    with pytest.raises(ValueError, match="already on the ring"):
        ring.add(1)
    with pytest.raises(ValueError, match="not on the ring"):
        ring.remove(7)
    with pytest.raises(ValueError, match="vnodes"):
        HashRing(range(2), vnodes=0)
    with pytest.raises(ValueError, match="empty ring"):
        HashRing().assign("x")


# --------------------------------------------------- pool fundamentals
def test_sharded_pool_routes_and_places():
    pool = _pool(shards=3, buckets=(4, 8))
    for i in range(6):
        rid = f"r{i}"
        shard, slot = pool.acquire(rid)
        assert shard == pool.route(rid) == JRing(range(3)).assign(rid)
        assert pool.lookup(rid) == (shard, slot)
    assert pool.occupancy == 6 and sum(pool.occupancies()) == 6
    assert pool.imbalance == max(pool.occupancies()) - min(
        pool.occupancies())
    st = pool.stats()
    assert st["shards"] == 3 and st["occupancy"] == 6
    assert len(st["per_shard"]) == 3 and st["migrations"] == 0
    assert pool.capacity == sum(pool.shard_capacity(s) for s in range(3))
    assert pool.max_capacity == 24
    pool.release("r0")
    assert pool.occupancy == 5


def test_sharded_pool_validation():
    with pytest.raises(ValueError, match="shards"):
        _pool(shards=0)
    with pytest.raises(ValueError, match="rebalance_threshold"):
        _pool(shards=2, rebalance_threshold=1)
    pool = _pool(shards=2, buckets=(2,))
    pool.acquire("a")
    with pytest.raises(ValueError, match="already attached"):
        pool.acquire("a")
    with pytest.raises(ValueError, match="out of range"):
        pool.acquire("b", shard=5)
    with pytest.raises(KeyError, match="unknown stream"):
        pool.lookup("ghost")
    with pytest.raises(KeyError, match="unknown stream"):
        pool.release("ghost")
    with pytest.raises(ValueError, match="out of range"):
        pool.migrate("a", 9)


def test_pool_full_on_one_shard_spares_the_others():
    """Filling one shard's ladder backpressures streams routed there
    (PoolFull names the shard) and leaves another shard's verdicts equal
    to a lone single pool's."""
    pool = _pool("cuda-q", shards=2, buckets=(2,))
    by_shard = {0: [], 1: []}
    i = 0
    while len(by_shard[0]) < 3 or len(by_shard[1]) < 1:
        by_shard[pool.route(f"t{i}")].append(f"t{i}")
        i += 1
    for rid in by_shard[0][:2]:
        pool.acquire(rid)
    lone = by_shard[1][0]
    pool.acquire(lone)
    with pytest.raises(PoolFull, match="shard 0"):
        pool.acquire(by_shard[0][2])
    x = np.random.default_rng(3).normal(size=(16,)).astype(np.float32)
    x[11] += 30.0
    solo = SlotPool("cuda-q", buckets=(2,), **CPU)
    solo_slot = int(solo.acquire(1)[0])
    s, slot = pool.lookup(lone)
    got = _feed(pool, s, {slot: x})
    want = _feed_pool(solo, {solo_slot: x})
    for key in ("outlier", "ecc"):
        np.testing.assert_array_equal(got[key][:, slot],
                                      want[key][:, solo_slot])
    assert got["outlier"][:, slot].any()


def _feed_pool(pool, cols):
    """One chunk into a SlotPool: {slot: samples}; numpy outputs."""
    t = len(next(iter(cols.values())))
    x = np.zeros((t, pool.capacity), np.float32)
    vl = np.zeros((pool.capacity,), np.int32)
    for slot, v in cols.items():
        x[:, slot] = v
        vl[slot] = t
    out = pool.process(x, valid_lens=vl)
    return {k: v.numpy() for k, v in out.items()}


def _feed(pool, shard, cols):
    return _feed_pool(pool.pools[shard], cols)


# ------------------------------------------------------- live migration
def test_migrate_is_noop_to_same_shard():
    pool = _pool(shards=2, buckets=(4,))
    s, slot = pool.acquire("a")
    assert pool.migrate("a", s) == slot
    assert pool.migrations == 0


def test_migrate_to_full_shard_leaves_stream_in_place():
    pool = _pool(shards=2, buckets=(2,))
    pool.acquire("a", shard=0)
    pool.acquire("b", shard=1)
    pool.acquire("c", shard=1)
    with pytest.raises(PoolFull, match="migration target shard 1"):
        pool.migrate("a", 1)
    assert pool.lookup("a") == (0, 0)
    assert pool.occupancies() == [1, 2] and pool.migrations == 0


@pytest.mark.parametrize("backend", ["cuda", "cuda-q"])
def test_migration_moves_state_words_and_m(backend):
    """k / mean / var arrive as the same 32-bit words, m with them, and
    the stream's next verdicts equal its unmigrated twin's."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(20,)).astype(np.float32)
    x[15] += 25.0
    moved, still = (_pool(backend, shards=2, buckets=(2, 4))
                    for _ in range(2))
    for pool in (moved, still):
        pool.acquire("pad", shard=0)
        pool.acquire("a", shard=0, m=2.5)
        _feed(pool, 0, {1: x[:9]})
    src = moved.pools[0].engine
    before = src._slot_words(1)
    new_slot = moved.migrate("a", 1)
    dst = moved.pools[1].engine
    np.testing.assert_array_equal(dst._slot_words(new_slot), before)
    for f in ("k", "mean", "var"):
        assert getattr(src.state, f).dtype == getattr(dst.state, f).dtype
    assert dst.slot_m[new_slot] == np.float32(2.5)
    a = _feed(moved, 1, {new_slot: x[9:]})
    b = _feed(still, 0, {1: x[9:]})
    for key in ("outlier", "ecc"):
        np.testing.assert_array_equal(a[key][:, new_slot], b[key][:, 1])
    assert a["outlier"][:, new_slot].any()


@pytest.mark.parametrize("rows_after_acquire", ["dropped", "current"])
def test_migration_carries_ensemble_aux_words_exactly(rows_after_acquire):
    """A mid-window ensemble slot keeps its aux column as raw words —
    planted signalling-NaN patterns in the teda-q payload rows included —
    with its per-slot m, member weights and vote threshold; the
    destination's device copy of the detector rows is dropped; and its
    next verdicts and scores equal the twin that never moved.  With
    "current", the destination engine re-uploads its device rows right
    after every attach (as an engine that kept them current would), so
    only `migrate`'s own drop keeps the moved column from voting with
    the default rows."""
    opts = dict(shards=2, buckets=(2, 4), detectors=ALL5, window=4)
    moved, still = (_pool("ensemble", **opts) for _ in range(2))
    if rows_after_acquire == "current":
        dst_pool = moved.pools[1]
        attach = dst_pool.acquire

        def acquire_current(*a, **k):
            slots = attach(*a, **k)
            dst_pool.engine._detector_rows()
            return slots

        dst_pool.acquire = acquire_current
    rng = np.random.default_rng(5)
    x = rng.normal(size=(24,)).astype(np.float32)
    x[17] += 25.0
    spec = moved.engine.backend.state_spec
    q_rows = slice(spec.offset("teda-q:mean"), spec.offset("teda-q:var") + 1)
    planted = np.array([0x7F800001, 0x7FC12345], np.int32)  # NaN patterns
    for pool in (moved, still):
        pool.acquire("a", shard=0, m=2.5, detectors=("teda", "teda-q"),
                     vote="any")
        _feed(pool, 0, {0: x[:12]})
        eng = pool.pools[0].engine
        st = eng.state
        words = st.aux.view(torch.int32).clone()
        words[q_rows, 0] = torch.from_numpy(planted)
        eng.state = st._replace(aux=words.view(torch.float32))
        pool.pools[1].engine._detector_rows()  # a warm device copy
    src = moved.pools[0].engine
    pre = {"words": src._slot_words(0), "m": src._m[0],
           "det_w": src._det_w[:, 0].copy(), "det_thr": src._det_thr[0],
           "aux": src.state.aux.view(torch.int32)[:, 0].numpy().copy()}
    assert pre["aux"][spec.slc("moment:s")].any()  # warm, not zero
    new_slot = moved.migrate("a", 1)
    dst = moved.pools[1].engine
    assert dst._det_dev is None
    np.testing.assert_array_equal(dst._slot_words(new_slot), pre["words"])
    np.testing.assert_array_equal(
        dst.state.aux.view(torch.int32)[:, new_slot].numpy(), pre["aux"])
    np.testing.assert_array_equal(
        dst.state.aux.view(torch.int32)[q_rows, new_slot].numpy(), planted)
    assert dst._m[new_slot] == pre["m"]
    np.testing.assert_array_equal(dst._det_w[:, new_slot], pre["det_w"])
    assert dst._det_thr[new_slot] == pre["det_thr"]
    a = _feed(moved, 1, {new_slot: x[12:]})
    b = _feed(still, 0, {0: x[12:]})
    for key in ("outlier", "ecc"):
        np.testing.assert_array_equal(a[key][:, new_slot], b[key][:, 0])
    np.testing.assert_array_equal(a["scores"][:, :, new_slot].view(np.int32),
                                  b["scores"][:, :, 0].view(np.int32))
    assert a["outlier"][:, new_slot].any()


def test_rebalancer_flattens_occupancy_deterministically():
    def filled():
        pool = _pool(shards=2, buckets=(8,))
        for i in (5, 0, 3, 1, 4, 2):
            pool.acquire(f"r{i}", shard=0)
        return pool

    pool = filled()
    moves = pool.rebalance(tick=3)
    assert pool.occupancies() == [3, 3]
    assert [(r, s, d) for r, s, d, _ in moves] == [
        ("r0", 0, 1), ("r1", 0, 1), ("r2", 0, 1)]
    assert filled().rebalance(tick=3) == moves
    assert pool.imbalance < pool.rebalance_threshold


def test_rebalancer_respects_avoid_and_max_moves():
    pool = _pool(shards=2, buckets=(8,))
    for i in range(4):
        pool.acquire(f"r{i}", shard=0)
    assert pool.rebalance(avoid={f"r{i}" for i in range(4)}) == []
    assert pool.occupancies() == [4, 0]
    moves = pool.rebalance(avoid={"r0"}, max_moves=1)
    assert [m[0] for m in moves] == ["r1"]


def test_migration_metrics_tracer_and_events():
    reg, bus, tracer = MetricsRegistry(), EventBus(), TickTracer()
    seen = []
    bus.attach(seen.append)
    pool = _pool(shards=2, buckets=(4,), registry=reg, events=bus,
                 tracer=tracer, name="fleet")
    pool.acquire("a", shard=0)
    pool.acquire("b", shard=0)
    pool.migrate("a", 1, tick=42)
    assert pool.migrations == 1
    ev = [e for e in seen if e.kind == "shard_migrated"]
    assert len(ev) == 1 and ev[0].rid == "a" and ev[0].tick == 42
    assert (ev[0].data["src"], ev[0].data["dst"]) == (0, 1)
    snap = reg.snapshot()
    assert any("sharded_migrations_total" in k for k in snap)
    assert reg.gauge("sharded_imbalance", "", ("pool",)).labels(
        pool="fleet").value == 0
    occ = reg.gauge("sharded_shard_occupancy", "", ("pool", "shard"))
    assert [occ.labels(pool="fleet", shard=s).value
            for s in ("0", "1")] == [1, 1]
    inst = [e for e in tracer.events() if e["name"] == "shard.migrate"]
    assert len(inst) == 1 and inst[0]["args"]["rid"] == "a"
    assert pool.programs() == []


# ------------------------------------------- bit-exactness under churn
def _lockstep_compare(backend, seed, shards, chunks=4, t=8, n_streams=6,
                      **opts):
    """Identical streams through one SlotPool and a K-shard ShardedPool
    in lockstep, the sharded streams randomly migrated / detached /
    re-attached between chunks; every stream's columns must match bit
    for bit."""
    rng = np.random.default_rng(seed)
    rids = [f"s{i}" for i in range(n_streams)]
    data = {}
    for i, rid in enumerate(rids):
        d = rng.normal(size=(chunks * t,)).astype(np.float32)
        if i % 2 == 0:
            d[chunks * t // 2] += 20.0
        data[rid] = d
    single = SlotPool(backend, buckets=(4, 8), **CPU, **opts)
    sharded = ShardedPool(backend, shards=shards, buckets=(4, 8), **CPU,
                          **opts)
    s_slots = {rid: int(single.acquire(1)[0]) for rid in rids}
    for rid in rids:
        sharded.acquire(rid)
    flags = 0
    for c in range(chunks):
        counts = [0] * shards
        for s, _ in (sharded.lookup(rid) for rid in rids):
            counts[s] += 1
        assert sharded.occupancies() == counts
        if c:
            for _ in range(3):
                rid = rids[int(rng.integers(n_streams))]
                try:
                    sharded.migrate(rid, int(rng.integers(shards)))
                except PoolFull:
                    pass
            if rng.random() < 0.5:
                rid = rids[int(rng.integers(n_streams))]
                single.release([s_slots[rid]])
                sharded.release(rid)
                s_slots[rid] = int(single.acquire(1)[0])
                sharded.acquire(rid)
        piece = {rid: data[rid][c * t:(c + 1) * t] for rid in rids}
        ref = _feed_pool(single, {s_slots[r]: v for r, v in piece.items()})
        by_shard = {}
        for rid in rids:
            s, slot = sharded.lookup(rid)
            by_shard.setdefault(s, {})[slot] = rid
        for s, members in sorted(by_shard.items()):
            got = _feed(sharded, s, {slot: piece[rid]
                                     for slot, rid in members.items()})
            for slot, rid in members.items():
                for key in ("outlier", "ecc"):
                    np.testing.assert_array_equal(
                        got[key][:, slot], ref[key][:, s_slots[rid]],
                        err_msg=f"{key} diverged for {rid} chunk {c}")
                flags += int(got["outlier"][:, slot].sum())
    assert sharded.migrations > 0 and flags > 0


@given_or_cases(
    "seed,shards", [(0, 2), (1, 3), (2, 4)],
    lambda st: {"seed": st.integers(0, 999), "shards": st.integers(2, 4)},
    max_examples=6)
def test_sharded_bitexact_cuda_q_under_migration_churn(seed, shards):
    """THE contract: K shards == one pool, exact Q bits, for a random
    routing + migration + attach/detach schedule."""
    _lockstep_compare("cuda-q", seed, shards)


def test_sharded_bitexact_scan_backend():
    _lockstep_compare("scan", seed=7, shards=2)


# ------------------------------------------------- sharded scheduler
def _interleave(sched, specs, request=Request, check_fence=False,
                max_ticks=500):
    """Staggered submits (one per tick), live fed one sample per tick,
    then drain; optionally assert after every tick that no (shard, slot)
    sits in two in-flight calls."""
    order = list(specs)
    fed = {rid: 0 for rid in specs}
    closed = set()
    for tick in range(max_ticks):
        if tick < len(order):
            rid = order[tick]
            h, live, m = specs[rid]
            assert sched.submit(request(rid, h, m=m))
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
        if len(closed) == len(specs):
            break
        sched.step()
        if check_fence:
            places = [r.place for inf in sched._inflight
                      for r, _, _ in inf.members]
            assert len(places) == len(set(places)), places
            assert len(sched._inflight) <= (
                sched.pipeline_depth * sched.n_shards + sched.n_shards)
    sched.drain()
    return sched


def _churn_specs(n, seed):
    rng = np.random.default_rng(seed)
    specs = {}
    for i in range(n):
        h = rng.normal(size=(int(rng.integers(4, 24)),)).astype(np.float32)
        live = rng.normal(size=(int(rng.integers(0, 8)),)).astype(
            np.float32)
        if live.size and i % 3 == 0:
            live[live.size // 2] += 25.0
        specs[f"r{i}"] = (h, live, [1.5, 3.0, 6.0][i % 3])
    return specs


def _sched(backend="cuda-q", **kw):
    kw.setdefault("buckets", (2, 4))
    kw.setdefault("chunk_t", 8)
    kw.setdefault("measure_latency", False)
    return BatchingScheduler(backend, collect=True, **CPU, **kw)


def _same_verdicts(a, b, specs):
    for rid in specs:
        ra, rb = a.results(rid), b.results(rid)
        np.testing.assert_array_equal(ra["outlier"], rb["outlier"],
                                      err_msg=rid)
        np.testing.assert_array_equal(ra["ecc"], rb["ecc"], err_msg=rid)
        ta, tb = a.telemetry(rid), b.telemetry(rid)
        assert (ta.samples, ta.flags) == (tb.samples, tb.flags), rid


def _skewed(specs, n_hot):
    """`specs` renamed so that `n_hot` of them route to ring shard 0 of
    two and the rest to shard 1: the rebalancer has work to do."""
    ring = HashRing(range(2))
    names = {0: [], 1: []}
    i = 0
    while len(names[0]) < n_hot or len(names[1]) < len(specs) - n_hot:
        names[ring.assign(f"k{i}")].append(f"k{i}")
        i += 1
    order = names[0][:n_hot] + names[1][:len(specs) - n_hot]
    return dict(zip(order, specs.values()))


def test_sharded_scheduler_equals_single_pool_and_jax():
    """shards=2 with rebalancer migrations: the same verdict bits as the
    port's single-pool scheduler, and the same verdicts, shard and
    migration count per request as the JAX package's sharded scheduler."""
    specs = _skewed(_churn_specs(6, seed=11), n_hot=5)
    # the synchronous loop retires each call in its tick, so no stream is
    # pinned by a call in flight when the rebalancer runs
    single = _interleave(_sched(), specs)
    sharded = _interleave(_sched(shards=2, rebalance_every=2,
                                 measure_latency=True), specs)
    ref = _interleave(JSched("pallas-q", fmt=JQ(*SPEC), buckets=(2, 4),
                             chunk_t=8, shards=2, rebalance_every=2,
                             interpret=True, collect=True,
                             measure_latency=True), specs,
                      request=JRequest)
    _same_verdicts(single, sharded, specs)
    for rid in specs:
        mine, theirs = sharded.results(rid), ref.results(rid)
        np.testing.assert_array_equal(mine["outlier"], theirs["outlier"])
        np.testing.assert_array_equal(mine["ecc"], theirs["ecc"])
        tm, tr = sharded.telemetry(rid), ref.telemetry(rid)
        assert (tm.shard, tm.migrations, tm.slot, tm.samples, tm.flags) \
            == (tr.shard, tr.migrations, tr.slot, tr.samples, tr.flags), rid
    st, jt = sharded.stats(), ref.stats()
    for key in ("shards", "migrations", "imbalance", "ticks", "completed"):
        assert st[key] == jt[key], key
    assert st["pool"]["shards"] == 2 and st["migrations"] > 0


def test_sharded_scheduler_rebalances_under_skew():
    """Rids hand-picked onto one ring shard: the rebalancer moves some
    mid-run, verdicts still match the single pool, and per-request
    telemetry records the moves."""
    probe = HashRing(range(2))
    rng = np.random.default_rng(4)
    rids, i = [], 0
    while len(rids) < 5:
        if probe.assign(f"skew{i}") == 0:
            rids.append(f"skew{i}")
        i += 1
    specs = {rid: (rng.normal(size=(12,)).astype(np.float32),
                   rng.normal(size=(4,)).astype(np.float32), 3.0)
             for rid in rids}
    single = _interleave(_sched(buckets=(8,)), specs)
    sharded = _interleave(_sched(buckets=(8,), shards=2, rebalance_every=2),
                          specs)
    assert sharded.stats()["migrations"] == sharded.pool.migrations > 0
    _same_verdicts(single, sharded, specs)
    assert any(sharded.telemetry(rid).migrations for rid in rids)


def test_sharded_scheduler_full_shard_blocks_only_that_class():
    """A full shard's ladder does not wedge admission for streams routed
    to shards with room; everyone completes."""
    probe = HashRing(range(2))
    on0 = [f"c{i}" for i in range(40) if probe.assign(f"c{i}") == 0]
    on1 = [f"c{i}" for i in range(40) if probe.assign(f"c{i}") == 1]
    sched = _sched("scan", shards=2, buckets=(2,), queue_limit=16,
                   class_weights={"bulk": 3.0, "late": 1.0})
    rng = np.random.default_rng(9)
    rids = on0[:3] + on1[:1]
    for j, rid in enumerate(rids):
        assert sched.submit(Request(
            rid, rng.normal(size=(12,)).astype(np.float32),
            priority="late" if j == 3 else "bulk"))
        sched.close(rid)
    sched.step()  # bulk's third head finds shard 0 full; late still admits
    assert sched.telemetry(on1[0]).admitted_tick == 1
    assert sched.telemetry(on0[2]).admitted_tick is None
    sched.drain()
    assert sched.completed == len(rids)
    assert all(sched.telemetry(rid).samples == 12 for rid in rids)


def test_scheduler_shard_validation():
    with pytest.raises(ValueError, match="shards"):
        _sched(shards=0)
    with pytest.raises(ValueError, match="rebalance_every"):
        _sched(shards=2, rebalance_every=-1)


@contextmanager
def _landing(every):
    """On the CPU outputs land at dispatch; let only the calls of every
    `every`-th tick count as landed so calls stay in flight and the
    (shard, slot) fence, out-of-order retirement and the depth cap act."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(batching, "_host_ready",
                   lambda inf: inf.tick % every == 0)
        yield


@pytest.mark.parametrize("depth", [2, 3])
def test_deep_pipeline_fences_on_shard_and_slot(depth):
    specs = _churn_specs(7, seed=23)
    sync = _interleave(_sched(measure_latency=True), specs)
    with _landing(3):
        deep = _interleave(_sched(shards=3, rebalance_every=2,
                                  pipeline_depth=depth), specs,
                           check_fence=True)
    _same_verdicts(sync, deep, specs)
    # local slot numbers collide across shards: the pair is the key
    assert len({deep.telemetry(r).shard for r in specs}) > 1


def test_gateway_shards_keys_and_determinism():
    """serve_streams(shards=2, rebalance_every=2): the extra keys, real
    per-request shard/migration fields, and the same verdicts as the
    single-pool gateway at depth 1 and depth 4."""
    rng = np.random.default_rng(21)
    streams = []
    for i in range(6):
        h = rng.normal(size=(10,)).astype(np.float32)
        lv = rng.normal(size=(6,)).astype(np.float32)
        if i % 2 == 0:
            lv[3] += 25.0
        streams.append((f"t{i}", h, lv, None))
    kw = dict(backend="cuda-q", buckets=(2, 4), chunk_t=8, collect=True,
              measure_latency=False, **CPU)
    base = serve_streams(streams, **kw)
    runs = [serve_streams(streams, shards=2, rebalance_every=2,
                          pipeline_depth=d, **kw) for d in (1, 4)]
    assert "shards" not in base
    for res in runs:
        assert res["shards"] == 2 and res["migrations"] >= 0
        assert res["imbalance"] == res["_scheduler"].pool.imbalance
        assert res["flagged"] == base["flagged"]
        for rid, pr in base["per_request"].items():
            opr = res["per_request"][rid]
            assert opr["shard"] in (0, 1) and opr["migrations"] >= 0
            assert (opr["flags"], opr["samples"]) == (pr["flags"],
                                                      pr["samples"])
            np.testing.assert_array_equal(
                res["_scheduler"].results(rid)["ecc"],
                base["_scheduler"].results(rid)["ecc"])
    assert sum(p["migrations"] for p in runs[0]["per_request"].values()) \
        == runs[0]["migrations"]


# ---------------------------------------------- the channel split
@pytest.mark.parametrize("backend", ["scan", "cuda", "cuda-q"])
def test_split_engine_equals_single(backend):
    """devices=["cpu", "cpu"]: the same outputs and state bits as the
    unsplit engine through ragged calls, per-slot m, an active subset,
    churn and a state hand-over; one backend call per group."""
    rng = np.random.default_rng(2)
    one = StreamEngine(8, backend, **CPU)
    two = StreamEngine(8, backend, devices=["cpu", "cpu"], fmt=FMT)
    assert two.device == torch.device("cpu") and len(two._parts) == 2
    for eng in (one, two):
        eng.detach([1, 6])
        eng.set_m([2, 5], [2.0, 4.5])
    for i, t in enumerate((5, 1, 9)):
        x = rng.normal(size=(t, 8)).astype(np.float32)
        x[t // 2, 3] += 20.0
        vl = rng.integers(0, t + 1, size=8)
        for active in (None, [0, 2, 3, 4, 5, 7]):
            a = one.process(x, active=active, valid_lens=vl)
            b = two.process(torch.from_numpy(x), active=active,
                            valid_lens=torch.from_numpy(vl))
            for key in a:
                assert torch.equal(a[key], b[key]), key
        for eng in (one, two):
            if i == 0:
                eng.attach([1, 6], m=2.0)
                eng.reset([4])
            elif i == 1:
                eng.detach([2])
    for f in ("k", "mean", "var", "active"):
        assert torch.equal(getattr(one.state, f), getattr(two.state, f)), f
    for slot in range(8):
        np.testing.assert_array_equal(one._slot_words(slot),
                                      two._slot_words(slot))
    snap = [getattr(one.state, f).numpy() for f in ("k", "mean", "var",
                                                      "active")]
    two.load_state(snap)
    assert all(torch.equal(getattr(one.state, f), getattr(two.state, f))
               for f in ("k", "mean", "var", "active"))


def test_split_pool_and_scheduler_equal_single():
    """A pool and a sharded scheduler whose engines split over two
    devices each give the single pool's verdicts bit for bit, through
    resizes and migrations."""
    rng = np.random.default_rng(8)
    single = SlotPool("cuda-q", buckets=(2, 4), **CPU)
    split = SlotPool("cuda-q", buckets=(2, 4), devices=["cpu", "cpu"],
                     fmt=FMT)
    assert split.device == torch.device("cpu")
    for step in range(3):
        for pool in (single, split):
            pool.acquire(1)
        x = rng.normal(size=(6, single.capacity)).astype(np.float32)
        a, b = single.process(x), split.process(x)
        for key in a:
            assert torch.equal(a[key], b[key]), (key, step)
    specs = _churn_specs(6, seed=31)
    base = _interleave(_sched(buckets=(4, 8)), specs)
    fan = _interleave(_sched(buckets=(4, 8), shards=2, rebalance_every=2,
                             shard_devices=["cpu"] * 4), specs)
    _same_verdicts(base, fan, specs)
    assert all(len(p.engine._parts) == 2 for p in fan.pool.pools)


def test_split_refuses_ensemble_and_uneven_groups():
    with pytest.raises(ValueError, match="ensemble"):
        StreamEngine(8, "ensemble", devices=["cpu", "cpu"], fmt=FMT,
                     detectors=ALL5, window=4)
    with pytest.raises(ValueError, match="not divisible"):
        StreamEngine(6, "scan", devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="conflicts"):
        StreamEngine(8, "scan", device="cpu", devices=["meta", "cpu"])
    with pytest.raises(ValueError, match="split evenly"):
        _pool(shards=3, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="not divisible"):
        _pool(shards=2, buckets=(3, 6), devices=["cpu"] * 4)
