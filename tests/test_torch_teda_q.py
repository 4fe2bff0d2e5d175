"""The port's Q-format TEDA stream functions, bit-exact with the JAX
package.

`teda_q_scan_chan` (scalar and per-channel `k0`, carried mean/var) and
`teda_q_stream` (multivariate) must reproduce every output and the final
state bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fixedpoint import QFormat as JQ
from repro.fixedpoint.teda_q import teda_q_scan_chan as j_chan
from repro.fixedpoint.teda_q import teda_q_stream as j_stream
from repro_torch.fixedpoint import QFormat as TQ
from repro_torch.fixedpoint.teda_q import teda_q_scan_chan as t_chan
from repro_torch.fixedpoint.teda_q import teda_q_stream as t_stream

torch.set_num_threads(2)

SPECS = [(32, 20, "trunc"), (24, 12, "round"), (16, 8, "trunc")]


def _x(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(loc=0.5, size=shape).astype(np.float32)
    x[shape[0] // 2] += 6.0
    return x


def _eq(j, t):
    np.testing.assert_array_equal(np.asarray(j), t.numpy())


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: f"Q{s[0]}.{s[1]}")
@pytest.mark.parametrize("k0", ["scalar", "vector"])
def test_scan_chan_bit_exact(spec, k0):
    c, t = 9, 40
    x = _x((t, c), seed=spec[0] + spec[1])
    rng = np.random.default_rng(spec[1])
    fmt_j, fmt_t = JQ(*spec), TQ(*spec)
    if k0 == "scalar":
        jk, tk = 0, 0
        jm = tm = jv = tv = None
    else:
        k = rng.integers(0, 500, size=c).astype(np.int32)
        k[0] = 0
        mean0 = np.array(fmt_j.quantize(rng.normal(size=c)))
        var0 = np.array(fmt_j.quantize(rng.uniform(0.2, 2.0, size=c)))
        mean0[0] = var0[0] = 0
        jk, tk = jnp.asarray(k), torch.from_numpy(k)
        jm, tm = jnp.asarray(mean0), torch.from_numpy(mean0)
        jv, tv = jnp.asarray(var0), torch.from_numpy(var0)
    jfin, jout = j_chan(jnp.asarray(x), fmt_j, 2.5, k0=jk, mean0=jm,
                        var0=jv)
    tfin, tout = t_chan(torch.from_numpy(x), fmt_t, 2.5, k0=tk, mean0=tm,
                        var0=tv)
    for a, b in zip(jfin, tfin):
        _eq(a, b)
    for key in jout:
        _eq(jout[key], tout[key])
    assert tout["ecc"].dtype == torch.int32
    assert tout["outlier"].dtype == torch.bool


@pytest.mark.parametrize("shape", [(30, 3), (20, 2, 2)])
def test_stream_bit_exact(shape):
    x = _x(shape, seed=11)
    fmt_j, fmt_t = JQ(32, 16), TQ(32, 16)
    jst, jout = j_stream(jnp.asarray(x), fmt_j, 3.0)
    tst, tout = t_stream(torch.from_numpy(x), fmt_t, 3.0)
    for a, b in zip(jst, tst):
        _eq(a, b)
    for a, b in zip(jout, tout):
        _eq(a, b)


def test_int_input_is_taken_as_q():
    fmt_j, fmt_t = JQ(32, 20), TQ(32, 20)
    xq = np.array(fmt_j.quantize(_x((25, 4), seed=2)))
    jfin, jout = j_chan(jnp.asarray(xq), fmt_j, 3.0)
    tfin, tout = t_chan(torch.from_numpy(xq), fmt_t, 3.0)
    _eq(jout["ecc"], tout["ecc"])
    _eq(jfin[2], tfin[2])
