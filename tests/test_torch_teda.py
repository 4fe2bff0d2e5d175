"""PyTorch port of the float TEDA forms against the JAX package.

`teda_step`/`teda_stream` (the sequential form) and `core/scan.teda_scan`
(the parallel "scan" backend, with carried state and ragged
`valid_lens`) are held to the reference at float32 tolerance; the numpy
oracles (`teda_numpy_loop`, `teda_ref`) are copies and must be
identical.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import scan as jscan
from repro.core import teda as jteda
from repro.kernels.ref import teda_ref as j_ref
from repro_torch.core import scan as tscan
from repro_torch.core import teda as tteda
from repro_torch.kernels.ref import teda_ref as t_ref

torch.set_num_threads(2)

RTOL, ATOL = 5e-4, 1e-5


def _x(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    x[shape[0] // 2] += 8.0  # someone flags
    return x


def _close(j, t, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("shape", [(40, 3), (25, 2, 4), (60, 5, 1)])
def test_teda_stream_matches_jax(shape):
    x = _x(shape, seed=sum(shape))
    jst, jout = jteda.teda_stream(jnp.asarray(x), 2.5)
    tst, tout = tteda.teda_stream(torch.from_numpy(x), 2.5)
    for f in ("ecc", "typ", "zeta", "threshold", "k"):
        _close(getattr(jout, f), getattr(tout, f))
    np.testing.assert_array_equal(np.asarray(jout.outlier),
                                  tout.outlier.numpy())
    for f in ("k", "mean", "var"):
        _close(getattr(jst, f), getattr(tst, f))


def test_teda_step_carries_state():
    x = _x((2, 6, 3), seed=1)
    js = jteda.teda_init((6,), 3)
    ts = tteda.teda_init((6,), 3)
    for t in range(2):
        js, jo = jteda.teda_step(js, jnp.asarray(x[t]), 3.0)
        ts, to = tteda.teda_step(ts, torch.from_numpy(x[t]), 3.0)
        _close(jo.ecc, to.ecc)
        _close(js.var, ts.var)


def test_numpy_oracles_identical():
    x = _x((50, 2), seed=4)
    a = jteda.teda_numpy_loop(x, 3.0)
    b = tteda.teda_numpy_loop(x, 3.0)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])
    xc = _x((70, 9), seed=5)
    ra = j_ref(xc, 2.0, k0=4, sum0=np.ones(9), var0=np.full(9, 0.5))
    rb = t_ref(xc, 2.0, k0=4, sum0=np.ones(9), var0=np.full(9, 0.5))
    for key in ra:
        np.testing.assert_array_equal(ra[key], rb[key])


def test_linear_recurrence_scan_matches_jax():
    rng = np.random.default_rng(6)
    a = rng.uniform(0.5, 1.0, size=(37, 4)).astype(np.float32)
    b = rng.normal(size=(37, 4)).astype(np.float32)
    _close(jscan.linear_recurrence_scan(jnp.asarray(a), jnp.asarray(b)),
           tscan.linear_recurrence_scan(torch.from_numpy(a),
                                        torch.from_numpy(b)))


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("m", [3.0, "per-slot"])
def test_teda_scan_matches_jax(ragged, m):
    c, t = 11, 90
    x = _x((t, c), seed=7)
    rng = np.random.default_rng(8)
    k0 = rng.integers(0, 40, size=c).astype(np.float32)
    k0[:2] = 0.0  # fresh streams
    mean0 = np.where(k0 > 0, rng.normal(size=c), 0.0).astype(np.float32)
    var0 = np.where(k0 > 1, rng.uniform(0.5, 2.0, size=c),
                    0.0).astype(np.float32)
    mv = (np.linspace(1.5, 4.0, c).astype(np.float32) if m == "per-slot"
          else m)
    vl = None
    if ragged:
        vl = rng.integers(0, t + 1, size=c).astype(np.int32)
        vl[0], vl[1], vl[2] = 0, t, 1
    jst = jteda.TedaState(k=jnp.asarray(k0), mean=jnp.asarray(mean0)[:, None],
                          var=jnp.asarray(var0))
    tst = tteda.TedaState(k=torch.from_numpy(k0),
                          mean=torch.from_numpy(mean0)[:, None],
                          var=torch.from_numpy(var0))
    jm = jnp.asarray(mv) if m == "per-slot" else mv
    tm = torch.from_numpy(mv) if m == "per-slot" else mv
    jf, jo = jscan.teda_scan(jnp.asarray(x)[..., None], jm, jst,
                             valid_lens=None if vl is None
                             else jnp.asarray(vl))
    tf, to = tscan.teda_scan(torch.from_numpy(x)[..., None], tm, tst,
                             valid_lens=None if vl is None
                             else torch.from_numpy(vl))
    for f in ("k", "mean", "var"):
        _close(getattr(jf, f), getattr(tf, f))
    for f in ("ecc", "zeta", "threshold", "k"):
        _close(getattr(jo, f), getattr(to, f))
    np.testing.assert_array_equal(np.asarray(jo.outlier),
                                  to.outlier.numpy())
