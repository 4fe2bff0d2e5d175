"""The CUDA kernels' reciprocal divider, mirrored on the CPU.

`repro_torch.kernels.qdiv.recip_div_mag` runs `q_recip_div_mag`
(`csrc/qformat.cuh`) step for step in int64 and float64: the exact
saturation test, the float64 reciprocal estimate and one correction
step.  It must give the bits of the bit-serial divider's fast image,
`fast_div_mag`, in both packages: exhaustively over the small word
lengths, and at the kernels' formats over seeded random pairs and the
edges (d and n at 0, 1, qmax and 2^31; remainders at the half-way
point, and at 0, 1 and d - 1, where the estimate sits next to an
integer).  The shared-reciprocal form of the Q TEDA row (one reciprocal of
k per row for rk, 1/k, msq1/2k, x/k, d2/k and ratio/k) is held against
the six separate divides.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import given_or_cases

from repro.fixedpoint import QFormat as JQ
from repro.kernels import qdiv as jd
from repro_torch.fixedpoint import QFormat as TQ
from repro_torch.kernels import qdiv as td

torch.set_num_threads(2)

ROUNDINGS = ("round", "trunc")
FORMATS = [(32, 16), (32, 20), (32, 30), (16, 8)]
FMT_IDS = [f"Q{w}.{f}" for w, f in FORMATS]


def _three_way(n, d, shift, rounding, qmax):
    """recip_div_mag against both fast_div_mag images, on int64 n, d."""
    tn, tdd = torch.from_numpy(n), torch.from_numpy(d)
    got = td.recip_div_mag(tn, tdd, shift, rounding, qmax).numpy()
    want = td.fast_div_mag(tn, tdd, shift, rounding, qmax).numpy()
    ref = np.asarray(jd.fast_div_mag(jnp.asarray(n.astype(np.uint32)),
                                     jnp.asarray(d.astype(np.uint32)),
                                     shift, rounding, qmax))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref.astype(np.int64))


@pytest.mark.parametrize("wl", range(2, 9))
def test_exhaustive_small_word_lengths(wl):
    # every magnitude pair (0 .. 2^(WL-1), the magnitude of qmin - 1
    # included), every shift a format of this word length allows, both
    # roundings
    qmax = (1 << (wl - 1)) - 1
    v = np.arange(0, qmax + 2, dtype=np.int64)
    n, d = (a.ravel() for a in np.meshgrid(v, v))
    for shift in range(wl):
        for rounding in ROUNDINGS:
            _three_way(n, d, shift, rounding, qmax)


@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("spec", FORMATS, ids=FMT_IDS)
def test_formats_random_and_edges(spec, rounding):
    wl, fl = spec
    fmt = TQ(wl, fl, rounding)
    rng = np.random.default_rng(wl * 100 + fl + len(rounding))
    edges = np.array([0, 1, 2, fmt.qmax, fmt.qmax + 1, 2**31 - 1, 2**31],
                     np.int64)
    en, ed = (a.ravel() for a in np.meshgrid(edges, edges))
    m = 100_000
    rn = rng.integers(0, 2**31 + 1, size=m)
    rd = rng.integers(0, 2**31 + 1, size=m)
    # small divisors and in-format numerators, where quotients are kept
    sn = rng.integers(0, fmt.qmax + 1, size=m)
    sd = rng.integers(0, 1 << 16, size=m) >> rng.integers(0, 16, size=m)
    for shift in (0, fl):
        hn, hd = td.half_way_pairs(rng, shift, 64)
        en2, ed2 = td.remainder_edge_pairs(rng, shift, 2000)
        n = np.concatenate([en, rn, sn, sn, hn, en2])
        d = np.concatenate([ed, rd, sd, rd, hd, ed2])
        _three_way(n, d, shift, rounding, fmt.qmax)


@pytest.mark.parametrize("spec", FORMATS, ids=FMT_IDS)
def test_signed_wrappers(spec):
    # the Q/Q and Q/int sign-magnitude wrappers, int32 operands of both
    # signs including -2^31
    wl, fl = spec
    rng = np.random.default_rng(wl + fl)
    n = rng.integers(-2**31, 2**31, size=50_000).astype(np.int32)
    d = rng.integers(-2**31, 2**31, size=50_000).astype(np.int32)
    d[::7] >>= 12
    n[:4], d[:4] = [-2**31, 2**31 - 1, 0, 5], [-2**31, 1, -3, 0]
    for rounding in ROUNDINGS:
        jf, tf = JQ(wl, fl, rounding), TQ(wl, fl, rounding)
        tn, tdd = torch.from_numpy(n), torch.from_numpy(d)
        for name in ("qq", "qi"):
            got = getattr(td, f"recip_div_{name}")(tf, tn, tdd).numpy()
            np.testing.assert_array_equal(
                got, getattr(td, f"fast_div_{name}")(tf, tn, tdd).numpy())
            np.testing.assert_array_equal(got, np.asarray(
                getattr(jd, f"fast_div_{name}")(jf, jnp.asarray(n),
                                                jnp.asarray(d))))


@pytest.mark.parametrize("spec", [(32, 20, "trunc"), (32, 20, "round"),
                                  (32, 16, "round"), (16, 8, "trunc")],
                         ids=lambda s: f"Q{s[0]}.{s[1]}{s[2][0]}")
def test_shared_k_reciprocal_equals_separate_divides(spec):
    # q_teda_tile: one rn(1/k) per row for rk, 1/k, x/k, d2/k and
    # ratio/k, and rn(1/2k) = rn(1/k)/2 for msq1/2k; every k of
    # [1, 2^20], 2^19 more up to 2^24, and the int32 edges of 2k
    fmt = TQ(*spec)
    rng = np.random.default_rng(spec[1] * 31 + len(spec[2]))
    k = np.concatenate([
        np.arange(1, 2**20 + 1), rng.integers(2**20, 2**24 + 1, 2**19),
        [2**24, 2**30 - 1, 2**30, 2**31 - 1, -1, -2**30, -2**31, 0]])
    k = torch.from_numpy(k.astype(np.int64))
    rcp = td.recip(k.abs())
    rcp2 = td.recip_2k(k, rcp)
    k2 = (2 * k.to(torch.int32))  # the kernel's int32 2k, wrapping
    x = torch.from_numpy(rng.integers(-fmt.qmax, fmt.qmax + 1, k.shape[0]))
    d2 = torch.from_numpy(rng.integers(0, fmt.qmax + 1, k.shape[0]))
    msq1 = torch.from_numpy(rng.integers(0, fmt.qmax + 1, k.shape[0]))
    pairs = [
        (td.recip_div_qq(fmt, k - 1, k, rcp), td.fast_div_qq(fmt, k - 1, k)),
        (td.recip_div_qi(fmt, fmt.one, k, rcp),
         td.fast_div_qi(fmt, fmt.one, k)),
        (td.recip_div_qi(fmt, msq1, k2, rcp2), td.fast_div_qi(fmt, msq1, k2)),
        (td.recip_div_qi(fmt, x, k, rcp), td.fast_div_qi(fmt, x, k)),
        (td.recip_div_qi(fmt, d2, k, rcp), td.fast_div_qi(fmt, d2, k)),
        (td.recip_div_qi(fmt, d2 >> 3, k, rcp),
         td.fast_div_qi(fmt, d2 >> 3, k)),
    ]
    for got, want in pairs:
        assert torch.equal(got, want)


@given_or_cases(
    "n,d,shift",
    [(2**31, 1, 0), (2**31, 2**31, 30), (1, 3, 20), (2**31 - 1, 2, 0),
     (0, 0, 5), (12345, 2**31 - 1, 30), (7 << 20, 14 << 20, 20)],
    lambda st: {"n": st.integers(0, 2**31), "d": st.integers(0, 2**31),
                "shift": st.integers(0, 30)},
    max_examples=40)
def test_property_scalar(n, d, shift):
    for rounding in ROUNDINGS:
        _three_way(np.array([n], np.int64), np.array([d], np.int64), shift,
                   rounding, 2**31 - 1)


def test_div_mag_call_takes_the_plain_version_on_cpu():
    rng = np.random.default_rng(3)
    n = torch.from_numpy(rng.integers(0, 2**31 + 1, 1000))
    d = torch.from_numpy(rng.integers(0, 2**16, 1000))
    for shift in (0, 20):
        assert torch.equal(td.div_mag_call(n, d, shift, "round", 2**31 - 1),
                           td.fast_div_mag(n, d, shift, "round", 2**31 - 1))
    with pytest.raises(ValueError, match="unsupported device"):
        td.div_mag_call(torch.empty(4, device="meta"), d[:4], 0, "trunc", 7)
