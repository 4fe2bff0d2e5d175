"""The port's StreamEngine against the JAX package's, on the CPU.

Both engines get the same numpy streams and the same slot operations;
"scan" is compared with "scan", "cuda" with "pallas" and "cuda-q" with
"pallas-q" (the port runs the kernels' plain versions on CPU tensors,
the reference its Pallas kernels in interpret mode).  Covered: chunked
equals full, ragged equals isolated, attach/detach/reset churn, set_m,
a mid-stream hand-off through `load_state`, and the device contract.
Q state and verdicts are bit-exact; float ones hold rtol 5e-4 / atol
1e-5 with equal flags.
"""
import numpy as np
import pytest
import torch

from repro.engine import StreamEngine as JEngine
from repro.fixedpoint import QFormat as JQ
from repro_torch.engine import StreamEngine as TEngine
from repro_torch.engine import get_backend, list_backends
from repro_torch.fixedpoint import QFormat as TQ
from repro_torch.kernels import ensemble_scan as ens_kernel
from repro_torch.kernels import teda_q_scan as tq_kernel
from repro_torch.kernels import teda_scan as tf_kernel

torch.set_num_threads(2)

RTOL, ATOL = 5e-4, 1e-5
SPEC = (32, 20, "trunc")
PAIRS = [("scan", "scan"), ("cuda", "pallas"), ("cuda-q", "pallas-q")]
C = 12
ALL5 = ("teda", "rde", "zscore", "hst", "teda-q")


def _engines(tname, jname, c=C, **kw):
    t = TEngine(c, tname, device="cpu", fmt=TQ(*SPEC), block_t=16, **kw)
    j = JEngine(c, jname, fmt=JQ(*SPEC), block_t=16, **kw)
    return t, j


def _x(t, c, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(loc=0.5, size=(t, c)).astype(np.float32)
    x[t // 2, : max(1, c // 2)] += 12.0
    return x


def _same(tout, jout, q, vl=None):
    """Compare one process() result: ecc at valid rows, all flags."""
    te, je = tout["ecc"].numpy(), np.asarray(jout["ecc"])
    valid = (np.ones(te.shape, bool) if vl is None
             else np.arange(te.shape[0])[:, None] < np.asarray(vl)[None, :])
    if q:
        np.testing.assert_array_equal(te[valid], je[valid])
    else:
        np.testing.assert_allclose(te[valid], je[valid], rtol=RTOL,
                                   atol=ATOL)
    np.testing.assert_array_equal(tout["outlier"].numpy(),
                                  np.asarray(jout["outlier"]))


def _same_state(teng, jeng, q):
    for f in ("k", "active"):
        np.testing.assert_array_equal(getattr(teng.state, f).numpy(),
                                      np.asarray(getattr(jeng.state, f)))
    for f in ("mean", "var"):
        a = getattr(teng.state, f).numpy()
        b = np.asarray(getattr(jeng.state, f))
        if q:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(teng.slot_m, jeng.slot_m)


@pytest.mark.parametrize("tname,jname", PAIRS)
def test_chunked_stream_matches_jax(tname, jname):
    q = tname == "cuda-q"
    x = _x(64, C, seed=1)
    teng, jeng = _engines(tname, jname)
    for lo, hi in [(0, 16), (16, 32), (32, 48), (48, 64)]:
        _same(teng.process(x[lo:hi]), jeng.process(x[lo:hi]), q)
        _same_state(teng, jeng, q)
    # chunked equals single-shot inside the port
    full = TEngine(C, tname, device="cpu", fmt=TQ(*SPEC))
    out = full.process(x)
    for f in ("k", "mean", "var"):
        a, b = getattr(full.state, f), getattr(teng.state, f)
        if q:
            assert torch.equal(a, b)
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL,
                                       atol=ATOL)
    assert out["outlier"].any()


@pytest.mark.parametrize("tname,jname", PAIRS)
def test_churn_ragged_and_set_m_match_jax(tname, jname):
    """attach/detach/reset churn, per-slot m, ragged and subset calls."""
    q = tname == "cuda-q"
    teng, jeng = _engines(tname, jname)
    rng = np.random.default_rng(2)
    for i in range(4):
        x = _x(16, C, seed=10 + i)
        vl, active = None, None
        if i == 0:
            for e in (teng, jeng):
                e.set_m([1, 3, 5], [1.5, 2.0, 4.0])
        if i == 1:
            vl = rng.integers(0, 17, size=C).astype(np.int32)
            vl[0], vl[1] = 0, 16
            for e in (teng, jeng):
                e.detach([2, 7])
                e.reset([4])
        if i == 2:
            for e in (teng, jeng):
                e.attach([7], m=2.5)
            active = [0, 3, 4, 7, 9]
        if i == 3:
            vl = 5
        tout = teng.process(x, active=active, valid_lens=vl)
        jout = jeng.process(x, active=active, valid_lens=vl)
        eff = np.broadcast_to(16 if vl is None else vl, (C,))
        _same(tout, jout, q, eff)
        _same_state(teng, jeng, q)
    assert list(teng.active_slots) == list(jeng.active_slots)
    assert teng.program_shapes == jeng.program_shapes == [16]


@pytest.mark.parametrize("tname", ["scan", "cuda", "cuda-q"])
def test_ragged_equals_isolated(tname):
    """One ragged call equals each slot run alone on its own prefix."""
    q = tname == "cuda-q"
    x = _x(30, 6, seed=3)
    eff = np.array([0, 1, 25, 7, 15, 24], np.int32)  # of 25 rows
    eng = TEngine(6, tname, device="cpu", fmt=TQ(*SPEC))
    eng.process(x[:5])
    k5 = eng.state.k.clone()
    out = eng.process(x[5:], valid_lens=eff)
    for c in range(6):
        solo = TEngine(1, tname, device="cpu", fmt=TQ(*SPEC))
        solo.process(x[:5, c:c + 1])
        assert torch.equal(solo.state.k, k5[c:c + 1])
        if eff[c]:
            so = solo.process(x[5:5 + eff[c], c:c + 1])
            assert torch.equal(so["outlier"][:, 0],
                               out["outlier"][:eff[c], c])
        assert not out["outlier"][eff[c]:, c].any()
        for f in ("k", "mean", "var"):
            a = getattr(solo.state, f)[0]
            b = getattr(eng.state, f)[c]
            if q or f == "k":
                assert torch.equal(a, b), (c, f)
            else:
                np.testing.assert_allclose(float(a), float(b), rtol=RTOL,
                                           atol=ATOL)


@pytest.mark.parametrize("tname,jname", PAIRS)
def test_load_state_hands_off_mid_stream(tname, jname):
    """A live JAX engine's state, moved as numpy arrays, continues in
    the port exactly where the reference continues."""
    q = tname == "cuda-q"
    x = _x(48, C, seed=4)
    teng, jeng = _engines(tname, jname)
    jeng.set_m([0, 2], [2.0, 5.0])
    jeng.detach([3])
    jeng.process(x[:16], valid_lens=np.arange(C, dtype=np.int32))
    jeng.process(x[16:32])
    st = jeng.state
    teng.load_state(tuple(np.asarray(v) for v in
                          (st.k, st.mean, st.var, st.active)),
                    m=jeng.slot_m)
    assert teng.state.k.dtype == (torch.int32 if q else torch.float32)
    _same_state(teng, jeng, q)
    _same(teng.process(x[32:]), jeng.process(x[32:]), q)
    _same_state(teng, jeng, q)


def test_device_contract(monkeypatch):
    eng = TEngine(4, "cuda", device="cpu")
    assert eng.device.type == "cpu"
    assert eng.process(np.zeros((3, 4), np.float32))["ecc"].device.type \
        == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TEngine(4, "cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TEngine(4, "scan", device="cuda")


def test_registry_and_errors():
    assert list_backends() == ["cuda", "cuda-q", "scan"]
    assert "ensemble" in list_backends(all=True)
    be = get_backend("ensemble")
    assert be.detectors == ("teda", "rde", "zscore")
    assert be.aux_rows == 17 and be.default_threshold == 1.5
    with pytest.raises(ValueError, match="needs fmt"):
        TEngine(4, "ensemble", device="cpu", detectors=ALL5)
    with pytest.raises(KeyError, match="unknown backend"):
        get_backend("pallas")
    with pytest.raises(ValueError, match="needs fmt"):
        get_backend("cuda-q")
    eng = TEngine(4, "cuda-q", device="cpu", fmt=TQ(*SPEC))
    with pytest.raises(ValueError, match="already attached"):
        eng.attach([1])
    eng.detach([1, 2])
    assert list(eng.attach(n=2)) == [1, 2]
    with pytest.raises(ValueError, match="engine full"):
        eng.attach()
    with pytest.raises(ValueError, match=r"valid_lens must lie in \[0"):
        eng.process(np.zeros((3, 4), np.float32), valid_lens=4)
    with pytest.raises(IndexError):
        eng.set_m([9], 2.0)
    with pytest.raises(ValueError, match="chunk must be"):
        eng.process(np.zeros((3, 5), np.float32))


def test_kernel_backends_launch_nothing_on_cpu():
    n = (tf_kernel.launches, tq_kernel.launches, ens_kernel.launches)
    for b in ("cuda", "cuda-q", "ensemble"):
        TEngine(4, b, device="cpu", fmt=TQ(*SPEC), detectors=ALL5).process(
            np.ones((2, 4), np.float32))
    assert (tf_kernel.launches, tq_kernel.launches,
            ens_kernel.launches) == n


def test_engine_step_matches_jax():
    from repro.engine import engine_init as j_init
    from repro.engine import engine_step as j_step
    from repro_torch.engine import engine_init as t_init
    from repro_torch.engine import engine_step as t_step

    x = _x(6, 5, seed=5)
    js, ts = j_init(5), t_init(5)
    ts = ts._replace(active=torch.tensor([True, True, False, True, True]))
    js = js._replace(active=np.array([True, True, False, True, True]))
    for t in range(6):
        js, jo = j_step(js, x[t], 2.0)
        ts, to = t_step(ts, torch.from_numpy(x[t]), 2.0)
        np.testing.assert_allclose(to.ecc.numpy(), np.asarray(jo.ecc),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(to.outlier.numpy(),
                                      np.asarray(jo.outlier))
    for f in ("k", "mean", "var"):
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)), rtol=RTOL)
    q = t_init(5, torch.int32)
    with pytest.raises(TypeError, match="float-state only"):
        t_step(q, torch.zeros(5))


# ------------------------------------------------- the ensemble backend
ENS = dict(detectors=ALL5, window=4, vote="majority")
MOMENT = ("teda", "rde", "zscore")


def _ens_engines(c=C, **kw):
    t = TEngine(c, "ensemble", device="cpu", fmt=TQ(*SPEC), **ENS, **kw)
    j = JEngine(c, "ensemble", fmt=JQ(*SPEC), block_t=8, interpret=True,
                **ENS, **kw)
    return t, j


def _spiky(t, c, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(t, c)) + rng.normal(0, 2, size=c)) \
        .astype(np.float32)
    spikes = rng.random((t, c)) < 0.05
    x[spikes] += 12.0
    return x


def _ens_same(tout, jout, teng, jeng):
    """Bitmask, vote and k exact; hst / teda-q scores and aux words
    exact; moment scores within rtol / atol 5e-3 and moment aux rows
    within 1e-4 (the reference sums by blocks, the port row by row)."""
    assert tout["ecc"] is tout["det_flags"]
    for key in ("det_flags", "outlier"):
        np.testing.assert_array_equal(tout[key].numpy(),
                                      np.asarray(jout[key]), err_msg=key)
    ts, js = tout["scores"].numpy(), np.asarray(jout["scores"])
    for d, name in enumerate(ALL5):
        if name in MOMENT:
            np.testing.assert_allclose(ts[d], js[d], rtol=5e-3, atol=5e-3,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(ts[d].view(np.int32),
                                          js[d].view(np.int32), name)
    for f in ("k", "active"):
        np.testing.assert_array_equal(getattr(teng.state, f).numpy(),
                                      np.asarray(getattr(jeng.state, f)))
    spec = teng.backend.state_spec
    ta = teng.state.aux.numpy()
    ja = np.asarray(jeng.state.aux)
    for region in spec.regions:
        sl = spec.slc(region.name)
        if region.name.startswith("moment:"):
            np.testing.assert_allclose(ta[sl], ja[sl], rtol=1e-4, atol=1e-4)
        else:
            np.testing.assert_array_equal(ta[sl].view(np.int32),
                                          ja[sl].view(np.int32),
                                          region.name)
    for f in ("mean", "var"):
        np.testing.assert_allclose(getattr(teng.state, f).numpy(),
                                   np.asarray(getattr(jeng.state, f)),
                                   rtol=1e-4, atol=1e-4)
    for slot in range(teng.capacity):
        a, b = teng.detector_config(slot), jeng.detector_config(slot)
        assert a["detectors"] == b["detectors"]
        np.testing.assert_array_equal(a["weights"], b["weights"])
        assert a["threshold"] == b["threshold"]


def test_ensemble_engine_matches_jax_through_churn():
    """attach(detectors=) / set_detectors / detach churn, per-slot m,
    ragged and subset calls: the port's ensemble engine equals the
    JAX engine call by call."""
    teng, jeng = _ens_engines()
    rng = np.random.default_rng(20)
    flagged = 0
    for i in range(6):
        x = _spiky(16, C, seed=30 + i)
        vl, active = None, None
        for e in (teng, jeng):
            if i == 0:
                e.set_m([1, 3, 5], [2.0, 2.0, 4.0])
                e.set_detectors([2, 6], detectors=("rde",), vote="any")
            if i == 1:
                e.detach([4, 7])
                e.set_detectors([8, 9], detectors=("hst", "teda-q"),
                                vote="all")
                e.reset([10])
            if i == 2:
                e.attach([7], m=2.0, detectors=("zscore", "teda"),
                         vote=0.5)
            if i == 4:
                e.set_detectors(None, vote="any")
                e.detach([2])
                e.attach([4])
        if i == 1:
            vl = rng.integers(0, 17, size=C).astype(np.int32)
            vl[:2] = [0, 16]
        if i == 3:
            active = [0, 2, 3, 7, 9, 11]
        if i == 5:
            vl = 5
        tout = teng.process(x, active=active, valid_lens=vl)
        jout = jeng.process(x, active=active, valid_lens=vl)
        _ens_same(tout, jout, teng, jeng)
        flagged += int(tout["det_flags"].ne(0).sum())
        if i == 2:
            assert teng.detector_config(7)["detectors"] == ("teda",
                                                            "zscore")
    assert flagged > 0
    assert teng.detector_config(8)["detectors"] == ALL5


def test_ensemble_load_state_hands_off_mid_stream():
    """A live JAX ensemble engine's state — the aux block as its int32
    view, the per-slot weights and thresholds and m — continues in the
    port exactly where the reference continues."""
    teng, jeng = _ens_engines()
    jeng.set_m([0, 5], [2.0, 2.0])
    jeng.set_detectors([3], detectors=("hst", "zscore"), vote="any")
    jeng.detach([6])
    for lo in (0, 16):
        x = _spiky(16, C, seed=40 + lo)
        jeng.process(x, valid_lens=(np.arange(C) + lo) % 17)
    st = jeng.state
    teng.load_state(tuple(np.asarray(v) for v in
                          (st.k, st.mean, st.var, st.active))
                    + (np.asarray(st.aux).view(np.int32),),
                    m=jeng.slot_m, weights=jeng._det_w,
                    thresholds=jeng._det_thr)
    for lo in (32, 48):
        x = _spiky(16, C, seed=40 + lo)
        _ens_same(teng.process(x), jeng.process(x), teng, jeng)


def test_ensemble_teda_lane_equals_cuda_backend():
    """A teda-only ensemble engine flags like the "cuda" backend on the
    same stream, with the first chunk's eccentricity bit-identical
    (later chunks carry mean rather than sum on the "cuda" side)."""
    x = _spiky(48, C, seed=50)
    ens = TEngine(C, "ensemble", device="cpu", detectors=("teda",))
    cud = TEngine(C, "cuda", device="cpu")
    flagged = 0
    for i, lo in enumerate(range(0, 48, 16)):
        oe, oc = ens.process(x[lo:lo + 16]), cud.process(x[lo:lo + 16])
        assert torch.equal(oe["outlier"], oc["outlier"])
        flagged += int(oe["outlier"].sum())
        assert torch.equal(oe["det_flags"] == 1, oc["outlier"])
        if i == 0:
            assert torch.equal(oe["scores"][0], oc["ecc"])
        else:
            np.testing.assert_allclose(oe["scores"][0], oc["ecc"],
                                       rtol=RTOL, atol=ATOL)
    assert flagged > 0


def test_ensemble_engine_device_rows_and_guards(monkeypatch):
    eng = TEngine(4, "ensemble", device="cpu", detectors=ALL5,
                  fmt=TQ(*SPEC))
    sel, thr = eng._detector_rows()
    assert eng._detector_rows()[0] is sel  # cached until a slot call
    eng.set_detectors([1], detectors=("rde",))
    sel2, thr2 = eng._detector_rows()
    assert sel2 is not sel
    assert sel2[:, 1].tolist() == [0.0, 1.0, 0.0, 0.0, 0.0]
    assert float(thr2[1]) == 0.5
    with pytest.raises(ValueError, match="subset"):
        eng.set_detectors([1], detectors=("iforest",))
    with pytest.raises(ValueError, match="vote"):
        eng.set_detectors([1], vote="plurality")
    with pytest.raises(ValueError, match=r"arrays must be \(k, mean"):
        eng.load_state((np.zeros(4),) * 4)
    with pytest.raises(ValueError, match="state.aux"):
        eng.load_state((np.zeros(4),) * 4 + (np.zeros((3, 4), np.int32),))
    scan = TEngine(2, "scan", device="cpu")
    for call in (lambda: scan.set_detectors([0], detectors=("rde",)),
                 lambda: scan.detector_config(0),
                 lambda: scan.load_state((np.zeros(2),) * 4,
                                         weights=np.ones((3, 2)))):
        with pytest.raises(ValueError, match="detector"):
            call()
    with pytest.raises(ValueError, match="detector"):
        scan.detach([1])
        scan.attach([1], detectors=("rde",))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TEngine(4, "ensemble", detectors=ALL5, fmt=TQ(*SPEC))


def test_ensemble_uniform_leg_gates_inactive_slots():
    """engine_process without valid_lens: inactive slots keep their
    state words and report no bits, votes or scores — the same result
    as the ragged leg with vlen = 0 on them."""
    from repro_torch.engine import engine_init, engine_process
    be = get_backend("ensemble", detectors=ALL5, fmt=TQ(*SPEC), window=4,
                     m=2.0)
    st = engine_init(6, aux_rows=be.aux_rows)
    act = torch.tensor([True, False, True, True, False, True])
    st = st._replace(active=act)
    x = torch.from_numpy(_spiky(32, 6, seed=60))
    new, out = engine_process(st, x, be)
    assert not out["ecc"][:, ~act].any()
    assert not out["outlier"][:, ~act].any()
    assert not out["scores"][:, :, ~act].any()
    assert out["ecc"][:, act].any()
    assert torch.equal(new.k, torch.where(act, 32.0, 0.0))
    assert torch.equal(new.aux[:, ~act].view(torch.int32),
                       st.aux[:, ~act].view(torch.int32))
    new2, out2 = engine_process(st, x, be,
                                valid_lens=torch.where(act, 32, 0))
    for key in ("ecc", "outlier", "scores"):
        assert torch.equal(out[key], out2[key]), key
    assert torch.equal(new.aux.view(torch.int32),
                       new2.aux.view(torch.int32))
