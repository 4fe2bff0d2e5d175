"""The port's SlotPool against the JAX package's, on the CPU.

Both pools get the same slot operations and the same numpy chunks;
"scan" is compared with "scan", "cuda-q" with "pallas-q" (bit-exact:
verdicts, state, per-slot m) and "ensemble" with "ensemble" (bitmask
and vote exact, moment scores within 5e-3, the reference's own
tolerance).  Covered: grow/shrink through the bucket ladder without
perturbing live tenants, bucket caching and `stats()`, `PoolFull`,
per-tenant m and detector rows across resizes, and the aux block moved
as raw 32-bit words.
"""
import numpy as np
import pytest
import torch

from repro.engine import PoolFull as JPoolFull
from repro.engine import SlotPool as JPool
from repro.fixedpoint import QFormat as JQ
from repro_torch.engine import PoolFull, SlotPool, StreamEngine
from repro_torch.fixedpoint import QFormat as TQ

SPEC = (32, 20)
ALL5 = ("teda", "rde", "zscore", "hst", "teda-q")
ENS = dict(detectors=ALL5, window=4)


def _pools(tname, jname, buckets=(2, 4), **kw):
    t = SlotPool(tname, buckets=buckets, device="cpu", fmt=TQ(*SPEC), **kw)
    j = JPool(jname, buckets=buckets, fmt=JQ(*SPEC), block_t=8, **kw)
    return t, j


def _x(t, c, seed, spike=True):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(t, c)).astype(np.float32)
    if spike:
        x[t // 2, ::2] += 12.0
    return x


@pytest.mark.parametrize("tname,jname", [("scan", "scan"),
                                         ("cuda-q", "pallas-q")])
def test_pool_grow_preserves_tenants_and_matches_jax(tname, jname):
    """Growing to the next bucket re-pads state without perturbing it:
    equal to an engine that never resized, and to the JAX pool."""
    q = tname == "cuda-q"
    xa = _x(20, 2, seed=1)
    xb = _x(20, 4, seed=2)
    xb[:, :2] = xa
    tpool, jpool = _pools(tname, jname)
    for p in (tpool, jpool):
        p.acquire(2)
        assert p.capacity == 2
        p.process(xa)
        p.acquire(1)                        # 3 tenants: bucket 2 -> 4
        assert p.capacity == 4 and p.resizes == 1
    tout = tpool.process(xb, active=[0, 1])
    jout = jpool.process(xb, active=[0, 1])

    flat = StreamEngine(2, tname, device="cpu", fmt=TQ(*SPEC))
    flat.process(xa)
    ref = flat.process(xb[:, :2])
    np.testing.assert_array_equal(tout["outlier"][:, :2].numpy(),
                                  ref["outlier"].numpy())
    np.testing.assert_array_equal(tout["outlier"].numpy(),
                                  np.asarray(jout["outlier"]))
    if q:
        np.testing.assert_array_equal(tout["ecc"][:, :2].numpy(),
                                      ref["ecc"].numpy())
        np.testing.assert_array_equal(tout["ecc"].numpy(),
                                      np.asarray(jout["ecc"]))
    else:
        np.testing.assert_allclose(tout["ecc"].numpy(),
                                   np.asarray(jout["ecc"]), rtol=5e-4,
                                   atol=1e-5)
    for f in ("k", "mean", "var", "active"):
        a = getattr(tpool.engine.state, f).numpy()
        b = np.asarray(getattr(jpool.engine.state, f))
        if q or f in ("k", "active"):
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_allclose(a, b, rtol=5e-4, atol=1e-5)
    assert tpool.engine.samples_seen[:3].tolist() == [40, 40, 0]
    # the old bucket's engine keeps no tenant state
    old = tpool._engines[2].state
    assert not old.active.any() and not old.k.any()


def test_pool_shrinks_and_caches_buckets_like_jax():
    tpool, jpool = _pools("scan", "scan", buckets=(2, 4, 8))
    for p in (tpool, jpool):
        slots = p.acquire(7)
        assert p.capacity == 8
        p.release(slots[2:])               # max live index 1 -> bucket 2
        assert p.capacity == 2
        assert p.stats()["compiled_buckets"] == [2, 8]
        p.acquire(2)                       # back up a bucket
        assert p.capacity == 4 and p.occupancy == 4
        p.process(np.zeros((3, 4), np.float32))
        p.release([3])
        p.process(np.zeros((1, 4), np.float32))
    assert tpool.stats() == jpool.stats()
    assert tpool.stats()["programs"] == [(4, 1), (4, 3)]
    np.testing.assert_array_equal(tpool.free_slots, jpool.free_slots)


def test_pool_full_is_explicit():
    tpool, jpool = _pools("scan", "scan")
    for p, exc in ((tpool, PoolFull), (jpool, JPoolFull)):
        p.acquire(4)
        with pytest.raises(exc) as ei:
            p.acquire(1)
        assert ei.value.occupancy == 4 and ei.value.capacity == 4
        assert "4/4" in str(ei.value)
    snap = tpool.registry.snapshot()
    assert snap["pool_full_total"]["samples"][0]["value"] == 1.0


def test_pool_per_tenant_m_survives_resize():
    tpool, jpool = _pools("cuda-q", "pallas-q", m=3.0)
    for p in (tpool, jpool):
        p.acquire(2, m=1.25)
        p.acquire(1, m=9.0)                # grows to bucket 4
    assert tpool.engine.slot_m.tolist() == [1.25, 1.25, 9.0, 3.0]
    np.testing.assert_array_equal(tpool.engine.slot_m, jpool.engine.slot_m)


def test_pool_ensemble_detector_rows_across_resizes():
    """Per-slot member selections and vote thresholds ride every
    resize (grow, shrink, grow again into the bucket engine seen
    before), and each call runs with the live rows: the pool equals
    the JAX pool and a never-resized port engine."""
    tpool = SlotPool("ensemble", buckets=(2, 4), device="cpu",
                     fmt=TQ(*SPEC), **ENS)
    jpool = JPool("ensemble", buckets=(2, 4), fmt=JQ(*SPEC), block_t=8,
                  interpret=True, **ENS)
    flat = StreamEngine(4, "ensemble", device="cpu", fmt=TQ(*SPEC),
                        auto_attach=False, **ENS)
    outs = []

    def admit(detectors, vote):
        for p in (tpool, jpool):
            p.acquire(1, detectors=detectors, vote=vote)
        flat.attach(n=1, detectors=detectors, vote=vote)

    def run(seed):
        x = _x(8, 4, seed, spike=seed > 11)  # spikes once warm
        cap = tpool.capacity
        act = [0, 1, 2][:cap]
        outs.append((cap, tpool.process(x[:, :cap], active=act),
                     jpool.process(x[:, :cap], active=act),
                     flat.process(x, active=act)))

    admit(("rde",), "any")
    admit(("hst", "teda-q"), "all")
    run(10)                                 # bucket 2
    admit(("zscore", "teda"), 0.5)          # grow 2 -> 4
    run(11)
    tpool.release([2])                      # shrink 4 -> 2
    jpool.release([2])
    flat.detach([2])
    assert tpool.capacity == 2
    run(12)
    admit(("teda-q",), "any")               # grow 2 -> 4 again
    run(13)
    assert tpool.resizes == 3
    for slot in range(4):
        a = tpool.engine.detector_config(slot)
        for b in (jpool.engine.detector_config(slot),
                  flat.detector_config(slot)):
            assert a["detectors"] == b["detectors"]
            np.testing.assert_array_equal(a["weights"], b["weights"])
            assert a["threshold"] == b["threshold"]
    for i, (cap, t, j, f) in enumerate(outs):
        for key in ("det_flags", "outlier"):
            np.testing.assert_array_equal(t[key].numpy(),
                                          np.asarray(j[key]), f"{i}{key}")
            np.testing.assert_array_equal(t[key].numpy(),
                                          f[key][:, :cap].numpy())
        ts = t["scores"].numpy()
        fs = f["scores"][:, :, :cap].numpy()
        np.testing.assert_array_equal(ts.view(np.int32), fs.view(np.int32))
        np.testing.assert_allclose(ts, np.asarray(j["scores"]), rtol=5e-3,
                                   atol=5e-3)
    assert any(int(t["det_flags"].ne(0).sum()) for _, t, _, _ in outs)


def test_pool_moves_aux_as_raw_words():
    """The aux block crosses a resize as 32-bit words: NaN payloads
    (teda-q Q registers alias them) arrive unchanged, in both
    directions, and the new tail is zero."""
    pool = SlotPool("ensemble", buckets=(2, 4), device="cpu",
                    fmt=TQ(*SPEC), **ENS)
    pool.acquire(2)
    pool.process(_x(6, 2, seed=4))
    st = pool.engine.state
    words = st.aux.view(torch.int32).clone()
    words[:3, 0] = torch.tensor([0x7F800001, -0x003FFEDD, 0x7FC12345],
                                dtype=torch.int32)
    pool.engine.state = st._replace(aux=words.view(torch.float32))
    before = words.numpy().copy()
    pool.acquire(1)                        # grow 2 -> 4
    after = pool.engine.state.aux.view(torch.int32).numpy()
    np.testing.assert_array_equal(after[:, :2], before)
    assert not after[:, 2:].any()
    pool.release([2])                      # shrink 4 -> 2
    np.testing.assert_array_equal(
        pool.engine.state.aux.view(torch.int32).numpy(), before)
