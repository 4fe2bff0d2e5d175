"""PyTorch port of the Q-format datapath: bit-equality with the JAX package.

`repro_torch.fixedpoint.qformat` and `repro_torch.kernels.qdiv` run the
reference's uint32 magnitude arithmetic on int64; every operator must
give the reference's bits over adversarial operand crosses and seeded
random pairs, for several formats (including FL = 0 and rounding).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import given_or_cases

from repro.fixedpoint import qformat as jq
from repro.fixedpoint.teda_q import msq1_const as j_msq1
from repro.kernels import qdiv as jd
from repro_torch.fixedpoint import qformat as tq
from repro_torch.fixedpoint.teda_q import msq1_const as t_msq1
from repro_torch.kernels import qdiv as td

torch.set_num_threads(2)

SPECS = [(16, 8, "trunc"), (24, 12, "round"), (32, 16, "trunc"),
         (32, 20, "round"), (32, 0, "trunc")]
IDS = [f"Q{w}.{f}{r[0]}" for w, f, r in SPECS]

_EDGES = np.array([0, 1, -1, 2, -2, 3, -3, 7, 255, 2**20, -(2**20),
                   2**30, -(2**30), 2**31 - 1, -(2**31 - 1)], np.int64)


def _fmts(spec):
    return jq.QFormat(*spec), tq.QFormat(*spec)


def _edge_grid(fmt):
    v = np.unique(np.concatenate([
        _EDGES, [fmt.qmax, -fmt.qmax, fmt.qmin, fmt.one, -fmt.one,
                 fmt.one // 2, fmt.one + 1, fmt.one // 2 + 1]]))
    n, d = np.meshgrid(v.astype(np.int32), v.astype(np.int32))
    return n.ravel(), d.ravel()


def _random_pairs(spec, n):
    rng = np.random.default_rng(sum(spec[:2]) * 7 + len(spec[2]))
    a = rng.integers(-2**31 + 1, 2**31, size=n).astype(np.int32)
    b = rng.integers(-2**31 + 1, 2**31, size=n).astype(np.int32)
    # in-format operands too, where the saturating ops are meant to live
    qm = (1 << (spec[0] - 1)) - 1
    c = rng.integers(-qm, qm + 1, size=n).astype(np.int32)
    d = rng.integers(-qm, qm + 1, size=n).astype(np.int32)
    return np.concatenate([a, c]), np.concatenate([b, d])


def _eq(jax_out, torch_out):
    t = torch_out.numpy()
    assert t.dtype == np.int32
    np.testing.assert_array_equal(np.asarray(jax_out), t)


def _check_all(spec, n, d, ops):
    jf, tf = _fmts(spec)
    jn, jdd = jnp.asarray(n), jnp.asarray(d)
    tn, tdd = torch.from_numpy(n), torch.from_numpy(d)
    for jfn, tfn in ops:
        _eq(jfn(jf, jn, jdd), tfn(tf, tn, tdd))


_SAT = [(jq.sat_add, tq.sat_add), (jq.sat_sub, tq.sat_sub),
        (jq.sat_mul, tq.sat_mul)]
_MODEL = [(jq.div_qq, tq.div_qq), (jq.div_qi, tq.div_qi)]
_FAST = [(jd.fast_div_qq, td.fast_div_qq), (jd.fast_div_qi, td.fast_div_qi)]


@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_edge_grid_bit_equal(spec):
    n, d = _edge_grid(jq.QFormat(*spec))
    _check_all(spec, n, d, _SAT + _MODEL + _FAST)


@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_random_pairs_bit_equal(spec):
    n, d = _random_pairs(spec, 4000)
    _check_all(spec, n, d, _SAT + _FAST)
    # the bit-serial model is 31+FL dependent steps: a smaller sweep
    _check_all(spec, n[::8], d[::8], _MODEL)


@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_sat_clamps_int64_sums(spec):
    jf, tf = _fmts(spec)
    v = np.array([0, 5, -5, jf.qmax, -jf.qmax, jf.qmax + 1, -jf.qmax - 1,
                  2**31 - 1, -(2**31 - 1)], np.int64)
    v = np.clip(v, -(2**31 - 1), 2**31 - 1).astype(np.int32)
    _eq(jq.sat(jf, jnp.asarray(v)), tq.sat(tf, torch.from_numpy(v)))


@given_or_cases(
    "num,den",
    [(1, 3), (-(2**31 - 1), 1), (2**31 - 1, -1), (5 << 20, 10 << 20),
     (123456789, -987), (0, 0), (42, 0)],
    lambda st: {"num": st.integers(-2**31 + 1, 2**31 - 1),
                "den": st.integers(-2**31 + 1, 2**31 - 1)},
    max_examples=20)
def test_property_scalar_bit_equal(num, den):
    n = np.array([num], np.int32)
    d = np.array([den], np.int32)
    _check_all((32, 20, "round"), n, d, _SAT + _MODEL + _FAST)


@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_quantize_bit_equal(spec):
    jf, tf = _fmts(spec)
    one = 1.0 / jf.scale
    x = np.array([3e9, -3e9, np.inf, -np.inf, np.nan, 0.0, -0.0,
                  0.5 * one, 1.5 * one, 2.5 * one, -0.5 * one, -2.5 * one,
                  1e-30, 12345.678, -9876.5, 2.0**31, -(2.0**31)],
                 np.float64)
    rng = np.random.default_rng(3)
    x = np.concatenate([x, rng.normal(scale=50.0, size=200)])
    _eq(jf.quantize(jnp.asarray(x, jnp.float32)),
        tf.quantize(torch.from_numpy(x)))
    for v in (0.1, -2.5, 1e12, 7.0):
        assert jf.quantize_scalar(v) == tf.quantize_scalar(v)


@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_msq1_const_bit_equal(spec):
    jf, tf = _fmts(spec)
    for m in (3.0, 2, 0.5, 100.0):
        assert j_msq1(jf, m) == t_msq1(tf, m)
    mv = np.array([0.0, 1.5, 3.0, 4.25, 1e3], np.float32)
    _eq(j_msq1(jf, mv), t_msq1(tf, mv))
    q = np.array([7, 1 << 20], np.int32)  # integers pass through as Q
    _eq(j_msq1(jf, q), t_msq1(tf, q))


def test_int64_guard_at_int32_min():
    """-2^31 is outside every format, but the reference's int32
    negation wraps there; the port keeps those bits.  At that numerator
    the reference's bit-serial model (which streams 31 magnitude bits
    and so reads 2^31 as 0) and its fast divider disagree; the port
    reproduces each of the two."""
    spec = (32, 16, "trunc")
    v = np.array([-(2**31), 5, -(2**31), 0, -(2**31)], np.int32)
    w = np.array([-(2**31), -(2**31), 1, -(2**31), 3], np.int32)
    _check_all(spec, v, w, _SAT + _MODEL + _FAST)
    jf, _ = _fmts(spec)
    n, d = jnp.asarray(v[4:]), jnp.asarray(w[4:])
    assert int(jq.div_qi(jf, n, d)[0]) != int(jd.fast_div_qi(jf, n, d)[0])
