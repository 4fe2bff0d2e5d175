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
from repro_torch.kernels import teda_q_scan as tq_kernel
from repro_torch.kernels import teda_scan as tf_kernel

torch.set_num_threads(2)

RTOL, ATOL = 5e-4, 1e-5
SPEC = (32, 20, "trunc")
PAIRS = [("scan", "scan"), ("cuda", "pallas"), ("cuda-q", "pallas-q")]
C = 12


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
    with pytest.raises(NotImplementedError, match="not yet ported"):
        TEngine(4, "ensemble", device="cpu")
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
    n = (tf_kernel.launches, tq_kernel.launches)
    for b in ("cuda", "cuda-q"):
        TEngine(4, b, device="cpu", fmt=TQ(*SPEC)).process(
            np.ones((2, 4), np.float32))
    assert (tf_kernel.launches, tq_kernel.launches) == n


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
