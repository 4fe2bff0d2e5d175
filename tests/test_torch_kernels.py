"""The port's kernel contract layer against the JAX package's kernels.

On the CPU the wrappers run the kernels' plain PyTorch versions; these
are held to the JAX wrappers (`ops.teda_scan_tpu` / `teda_q_scan_tpu`,
Pallas in interpret mode), the float64 `teda_ref` oracle and the
`teda_q_scan_chan` oracle, for both output contracts: ragged `vlen`
including 0 and T, per-slot `m`, carried state across chunks, and
invariance under the block arguments.  Q outputs are bit-exact; float
outputs hold rtol 5e-4 / atol 1e-5 with equal flags, the reference's
own tolerance for its kernel.  The CUDA kernels themselves are compared
with the plain versions only where a GPU is present.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.teda import TedaState as JState
from repro.fixedpoint import QFormat as JQ
from repro.fixedpoint.teda_q import teda_q_scan_chan as j_chan
from repro.kernels import ops as jops
from repro.kernels.ref import teda_ref
from repro_torch.core.teda import TedaState as TState
from repro_torch.fixedpoint import QFormat as TQ
from repro_torch.kernels import ops as tops
from repro_torch.kernels import teda_q_scan as tq_kernel
from repro_torch.kernels import teda_scan as tf_kernel

torch.set_num_threads(2)

RTOL, ATOL = 5e-4, 1e-5
SPEC = (32, 20, "trunc")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the GPU")
    return torch.device("cuda")


def _x(t, c, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(loc=1.0, size=(t, c)).astype(np.float32)
    x[t // 2, : max(1, c // 3)] += 9.0  # spikes that flag
    return x


def _vlen(t, c, seed):
    v = np.random.default_rng(seed).integers(0, t + 1, size=c)
    v[0], v[-1] = 0, t
    if c > 2:
        v[1] = 1
    return v.astype(np.int32)


def _valid(t, vl):
    return np.arange(t)[:, None] < vl[None, :]


def _float_state(c, seed):
    rng = np.random.default_rng(seed)
    k0 = rng.integers(0, 300, size=c).astype(np.float32)
    k0[0] = 0.0
    mean0 = np.where(k0 > 0, rng.normal(loc=1.0, size=c), 0).astype(
        np.float32)
    var0 = np.where(k0 > 1, rng.uniform(0.5, 1.5, size=c), 0).astype(
        np.float32)
    return k0, mean0, var0


def _q_state(fmt, c, seed):
    k0, mean0, var0 = _float_state(c, seed)
    return (k0.astype(np.int32), np.array(fmt.quantize(mean0)),
            np.array(fmt.quantize(var0)))


def _close_valid(j, t, valid):
    np.testing.assert_allclose(t.numpy()[valid], np.asarray(j)[valid],
                               rtol=RTOL, atol=ATOL)


# ------------------------------------------------------------- float
@pytest.mark.parametrize("per_slot", [False, True])
def test_float_full_matches_jax_kernel(per_slot):
    t, c = 48, 10
    x = _x(t, c, seed=1)
    k0, mean0, var0 = _float_state(c, seed=2)
    vl = _vlen(t, c, seed=3)
    m = np.linspace(1.5, 4.0, c).astype(np.float32) if per_slot else 2.5
    jfin, jout = jops.teda_scan_tpu(
        jnp.asarray(x), jnp.asarray(m) if per_slot else m,
        JState(k=jnp.asarray(k0), mean=jnp.asarray(mean0)[:, None],
               var=jnp.asarray(var0)),
        valid_lens=jnp.asarray(vl), block_t=16)
    tfin, tout = tops.teda_scan_full(
        torch.from_numpy(x), torch.from_numpy(m) if per_slot else m,
        TState(k=torch.from_numpy(k0), mean=torch.from_numpy(mean0)[:, None],
               var=torch.from_numpy(var0)),
        valid_lens=torch.from_numpy(vl))
    valid = _valid(t, vl)
    for key in ("mean", "var", "ecc", "zeta"):
        _close_valid(jout[key], tout[key], valid)
    np.testing.assert_allclose(tout["threshold"].numpy(),
                               np.asarray(jout["threshold"]), rtol=1e-6)
    np.testing.assert_array_equal(tout["outlier"].numpy(),
                                  np.asarray(jout["outlier"]))
    assert tout["outlier"].numpy().any()
    for a, b in zip(jfin, tfin):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("t,c", [(1, 1), (37, 5), (130, 130), (300, 3)])
def test_float_verdict_matches_teda_ref(t, c):
    x = _x(t, c, seed=t + c)
    k0 = 7
    mean0 = np.full(c, 0.9, np.float32)
    var0 = np.full(c, 1.1, np.float32)
    ref = teda_ref(x, 3.0, k0=k0, sum0=mean0 * k0, var0=var0)
    st = TState(k=torch.tensor(float(k0)), mean=torch.from_numpy(mean0),
                var=torch.from_numpy(var0))
    fin, out = tops.teda_scan_verdict(torch.from_numpy(x), 3.0, st)
    np.testing.assert_allclose(out["ecc"].numpy(), ref["ecc"], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(out["outlier"].numpy(), ref["outlier"])
    np.testing.assert_allclose(fin.var.numpy(), ref["var"][-1], rtol=RTOL)
    np.testing.assert_allclose(fin.mean[:, 0].numpy(), ref["mean"][-1],
                               rtol=RTOL)
    np.testing.assert_array_equal(fin.k.numpy(), k0 + t)


def test_float_chunked_equals_full_and_block_args():
    t, c = 120, 6
    x = torch.from_numpy(_x(t, c, seed=9))
    full_fin, full = tops.teda_scan_verdict(x, 3.0)
    st, eccs, flags = None, [], []
    for lo, hi in [(0, 1), (1, 50), (50, 51), (51, 120)]:
        st, out = tops.teda_scan_verdict(x[lo:hi], 3.0, st, block_t=8,
                                         block_c=128, lane_pad=256)
        eccs.append(out["ecc"])
        flags.append(out["outlier"])
    np.testing.assert_allclose(torch.cat(eccs).numpy(), full["ecc"].numpy(),
                               rtol=RTOL, atol=ATOL)
    assert torch.equal(torch.cat(flags), full["outlier"])
    for a, b in zip(full_fin, st):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=RTOL)
    with pytest.raises(ValueError, match="multiple of 128"):
        tops.teda_scan_verdict(x, 3.0, block_c=100)


def test_float_ragged_zero_freezes_exactly():
    t, c = 20, 4
    x = torch.from_numpy(_x(t, c, seed=10))
    k0, mean0, var0 = (torch.from_numpy(v) for v in _float_state(c, 11))
    st = TState(k=k0, mean=mean0, var=var0)
    vl = torch.tensor([0, 0, t, 5])
    fin, out = tops.teda_scan_verdict(x, 3.0, st, valid_lens=vl)
    assert torch.equal(fin.k[:2], k0[:2])
    assert torch.equal(fin.var[:2], var0[:2])
    assert not out["outlier"][:, :2].any()
    assert not out["outlier"][5:, 3].any()


# ----------------------------------------------------------------- Q
def test_q_full_matches_jax_kernel_interpret():
    """One small case through the Q Pallas kernel in interpret mode:
    ragged vlen with 0 and T, per-slot m, carried state."""
    t, c = 24, 10
    fmt_j, fmt_t = JQ(*SPEC), TQ(*SPEC)
    x = _x(t, c, seed=12)
    k0, mean0, var0 = _q_state(fmt_j, c, seed=13)
    vl = _vlen(t, c, seed=14)
    m = np.linspace(1.5, 4.0, c).astype(np.float32)
    jfin, jout = jops.teda_q_scan_tpu(
        jnp.asarray(x), fmt_j, jnp.asarray(m),
        JState(k=jnp.asarray(k0), mean=jnp.asarray(mean0)[:, None],
               var=jnp.asarray(var0)),
        valid_lens=jnp.asarray(vl), block_t=8)
    tfin, tout = tops.teda_q_scan_full(
        torch.from_numpy(x), fmt_t, torch.from_numpy(m),
        TState(k=torch.from_numpy(k0), mean=torch.from_numpy(mean0)[:, None],
               var=torch.from_numpy(var0)),
        valid_lens=torch.from_numpy(vl))
    valid = _valid(t, vl)
    for key in ("mean", "var", "ecc", "zeta"):
        np.testing.assert_array_equal(tout[key].numpy()[valid],
                                      np.asarray(jout[key])[valid])
    for key in ("threshold", "outlier"):
        np.testing.assert_array_equal(tout[key].numpy(),
                                      np.asarray(jout[key]))
    for a, b in zip(jfin, tfin):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("spec", [(32, 20, "trunc"), (24, 12, "round"),
                                  (16, 8, "trunc")],
                         ids=lambda s: f"Q{s[0]}.{s[1]}")
@pytest.mark.parametrize("contract", ["verdict", "full"])
def test_q_matches_scan_chan_oracle(spec, contract):
    """Ragged vlen (0, 1, T), per-slot m and carried state, bit-exact
    against the lax.scan oracle: each channel's rows below vlen are the
    oracle's rows, and its final state is the oracle's row vlen-1."""
    t, c = 40, 12
    fmt_j, fmt_t = JQ(*spec), TQ(*spec)
    x = _x(t, c, seed=spec[1])
    k0, mean0, var0 = _q_state(fmt_j, c, seed=15)
    vl = _vlen(t, c, seed=16)
    m = np.linspace(1.0, 4.0, c).astype(np.float32)
    (jk, jm, jv), jout = j_chan(jnp.asarray(x), fmt_j, m, k0=jnp.asarray(k0),
                                mean0=jnp.asarray(mean0),
                                var0=jnp.asarray(var0))
    call = (tops.teda_q_scan_verdict if contract == "verdict"
            else tops.teda_q_scan_full)
    fin, out = call(torch.from_numpy(x), fmt_t, torch.from_numpy(m),
                    TState(k=torch.from_numpy(k0),
                           mean=torch.from_numpy(mean0),
                           var=torch.from_numpy(var0)),
                    valid_lens=torch.from_numpy(vl))
    valid = _valid(t, vl)
    keys = ("ecc",) if contract == "verdict" else ("ecc", "mean", "var",
                                                   "zeta", "threshold")
    for key in keys:
        np.testing.assert_array_equal(out[key].numpy()[valid],
                                      np.asarray(jout[key])[valid])
    np.testing.assert_array_equal(out["outlier"].numpy(),
                                  np.asarray(jout["outlier"]) & valid)
    last = np.maximum(vl - 1, 0)
    cols = np.arange(c)
    exp_mean = np.where(vl > 0, np.asarray(jout["mean"])[last, cols], mean0)
    exp_var = np.where(vl > 0, np.asarray(jout["var"])[last, cols], var0)
    np.testing.assert_array_equal(fin.k.numpy(), k0 + vl)
    np.testing.assert_array_equal(fin.mean[:, 0].numpy(), exp_mean)
    np.testing.assert_array_equal(fin.var.numpy(), exp_var)
    del jk, jm, jv


def test_q_chunked_equals_full_bit_exact():
    t, c = 90, 7
    fmt = TQ(*SPEC)
    x = torch.from_numpy(_x(t, c, seed=17))
    full_fin, full = tops.teda_q_scan_verdict(x, fmt, 3.0)
    st, eccs, flags = None, [], []
    for lo, hi in [(0, 1), (1, 33), (33, 34), (34, 90)]:
        st, out = tops.teda_q_scan_verdict(x[lo:hi], fmt, 3.0, st,
                                           block_t=16, block_c=128)
        eccs.append(out["ecc"])
        flags.append(out["outlier"])
    assert torch.equal(torch.cat(eccs), full["ecc"])
    assert torch.equal(torch.cat(flags), full["outlier"])
    for a, b in zip(full_fin, st):
        assert torch.equal(a, b)


def test_q_float_input_is_quantized_like_int_input():
    fmt = TQ(*SPEC)
    x = torch.from_numpy(_x(30, 3, seed=18))
    _, a = tops.teda_q_scan_verdict(x, fmt, 3.0)
    _, b = tops.teda_q_scan_verdict(fmt.quantize(x), fmt, 3.0)
    assert torch.equal(a["ecc"], b["ecc"])


def test_cpu_tensors_take_the_plain_version():
    n_f, n_q = tf_kernel.launches, tq_kernel.launches
    x = torch.from_numpy(_x(8, 3, seed=19))
    tops.teda_scan_verdict(x, 3.0)
    tops.teda_q_scan_verdict(x, TQ(*SPEC), 3.0)
    assert (tf_kernel.launches, tq_kernel.launches) == (n_f, n_q)
    meta = torch.empty((4, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tops.teda_scan_verdict(meta, 3.0)


@pytest.mark.parametrize("full", [False, True])
def test_q_call_clamps_vlen(full):
    # vlen outside [0, T] gives the result of the clamped vlen: carries,
    # final k and flags of a channel with vlen > T are those of vlen = T
    t, c = 20, 4
    fmt = TQ(*SPEC)
    x = fmt.quantize(torch.from_numpy(_x(t, c, seed=24)))
    k0, mean0, var0 = (torch.from_numpy(v) for v in _q_state(fmt, c, 25))
    msq1 = torch.full((c,), 10 << 20, dtype=torch.int32)
    wild = torch.tensor([-5, t + 7, 2**31 - 1, 3], dtype=torch.int32)
    got = tq_kernel.teda_q_scan_call(x, msq1, wild, k0, mean0, var0,
                                     fmt=fmt, full=full)
    want = tq_kernel.teda_q_scan_call(x, msq1, wild.clamp(0, t), k0, mean0,
                                      var0, fmt=fmt, full=full)
    for a, b in zip(got, want):
        assert (a is None and b is None) or torch.equal(a, b)
    assert got[4].tolist() == (k0 + torch.tensor([0, t, t, 3])).tolist()


# ------------------------------------- float, at the staged tiles' edges
S = tf_kernel.STAGE_ROWS  # rows per tile of csrc/teda_scan.cu
EDGE_T = (0, 1, S - 1, S, S + 1, 2 * S + 1, 37)
EDGE_C = (1, 127, 129, 1000)


def _edge_x(t, c, seed):
    """(T, C) samples with spikes that flag and, in channels 4 and up,
    NaN and +-inf samples."""
    rng = np.random.default_rng(seed)
    x = rng.normal(loc=1.0, size=(t, c)).astype(np.float32)
    x[rng.random((t, c)) < 0.01] += 9.0
    if c > 4:
        u = rng.random((t, c))
        u[:, :4] = 1.0
        x[u < 0.004] = np.nan
        x[(u >= 0.004) & (u < 0.006)] = np.inf
        x[(u >= 0.006) & (u < 0.008)] = -np.inf
    return x


def _edge_vlen(t, c, seed):
    """Ragged vlen in [0, T] with 0 and T among them (vlen = T for one
    channel)."""
    return (np.minimum(_vlen(t, c, seed), t) if c > 1
            else np.full(1, t, np.int32))


@pytest.mark.parametrize("c", EDGE_C)
@pytest.mark.parametrize("t", EDGE_T)
def test_plain_matches_teda_ref_at_stage_edges(t, c):
    """teda_scan_plain against the float64 oracle at the T and C edges of
    the kernel's staged tiles, from a warm carry with ragged vlen (0 and
    T included) and NaN/+-inf samples: rows below a channel's vlen are
    teda_ref's rows; rows at or past it keep mean = sum/k, var frozen,
    ecc = 1/k and no flag; the finals are the last valid row's."""
    k0 = 7
    x = _edge_x(t, c, seed=100 + t + c)
    vl = _edge_vlen(t, c, seed=200 + t + c)
    rng = np.random.default_rng(300 + t + c)
    sum0 = (k0 * rng.normal(loc=1.0, size=c)).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, size=c).astype(np.float32)
    mean, var, ecc, outlier, fk, fsum, fvar = tf_kernel.teda_scan_plain(
        torch.from_numpy(x), torch.full((c,), 3.0), torch.from_numpy(vl),
        torch.full((c,), float(k0)), torch.from_numpy(sum0),
        torch.from_numpy(var0), full=True)

    ref = teda_ref(x, 3.0, k0=k0, sum0=sum0, var0=var0)
    valid = _valid(t, vl)
    kk = k0 + np.arange(1, t + 1, dtype=np.float64)[:, None]
    last = np.maximum(vl - 1, 0)
    cols = np.arange(c)
    x_valid = np.where(valid, x.astype(np.float64), 0.0)
    with np.errstate(invalid="ignore"):  # +inf and -inf in one channel
        s_v = sum0 + (np.cumsum(x_valid, axis=0)[last, cols] if t else 0.0)
    var_v = np.where(vl > 0, ref["var"][last, cols] if t else 0.0, var0)
    want = {"mean": np.where(valid, ref["mean"], s_v / kk),
            "var": np.where(valid, ref["var"], var_v),
            "ecc": np.where(valid, ref["ecc"], 1.0 / kk)}
    for key, got in (("mean", mean), ("var", var), ("ecc", ecc)):
        np.testing.assert_allclose(got.numpy(), want[key], rtol=RTOL,
                                   atol=ATOL, err_msg=key)
    np.testing.assert_array_equal(outlier.numpy(), ref["outlier"] & valid)
    np.testing.assert_array_equal(fk.numpy(), k0 + vl)
    np.testing.assert_allclose(fsum.numpy(), s_v, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(fvar.numpy(), var_v, rtol=RTOL, atol=ATOL)


def test_plain_matches_jax_kernel_interpret_at_stage_edges():
    """One shape through the Pallas kernel in interpret mode: T = 2S + 1
    over 16-row time blocks, C = 129 (one past the block width), ragged
    vlen with 0 and T, per-slot m, a warm per-channel carry, NaN/+-inf
    samples.  Every row is compared, rows past vlen included."""
    t, c = 2 * S + 1, 129
    x = _edge_x(t, c, seed=31)
    k0, mean0, var0 = _float_state(c, seed=32)
    vl = _vlen(t, c, seed=33)
    m = np.linspace(1.5, 4.0, c).astype(np.float32)
    jfin, jout = jops.teda_scan_tpu(
        jnp.asarray(x), jnp.asarray(m),
        JState(k=jnp.asarray(k0), mean=jnp.asarray(mean0)[:, None],
               var=jnp.asarray(var0)),
        valid_lens=jnp.asarray(vl), block_t=16)
    mean, var, ecc, outlier, fk, fsum, fvar = tf_kernel.teda_scan_plain(
        torch.from_numpy(x), torch.from_numpy(m), torch.from_numpy(vl),
        torch.from_numpy(k0), torch.from_numpy(mean0 * k0),
        torch.from_numpy(var0), full=True)
    for key, got in (("mean", mean), ("var", var), ("ecc", ecc)):
        np.testing.assert_allclose(got.numpy(), np.asarray(jout[key]),
                                   rtol=RTOL, atol=ATOL, err_msg=key)
    np.testing.assert_array_equal(outlier.numpy(), np.asarray(jout["outlier"]))
    np.testing.assert_array_equal(fk.numpy(), np.asarray(jfin.k))
    np.testing.assert_allclose(fvar.numpy(), np.asarray(jfin.var), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(
        (fsum / torch.clamp(fk, min=1.0)).numpy(),
        np.asarray(jfin.mean)[:, 0], rtol=RTOL, atol=ATOL)


def _words(v):
    return v.view(torch.int32) if v.dtype == torch.float32 else v


@pytest.mark.parametrize("ragged", [False, True], ids=["uniform", "ragged"])
@pytest.mark.parametrize("full", [False, True], ids=["verdict", "full"])
def test_plain_chunked_at_stage_boundaries_is_bit_identical(full, ragged):
    """The plain version run in chunks cut at the kernel's tile boundaries
    (S - 1, S, S + 1, 2S, 2S + 1) equals one full run bit for bit, NaN
    and +-inf samples and warm carries included: rows below vlen as
    int32 words, the flags everywhere, the finals."""
    t, c = 2 * S + 5, 129
    x = torch.from_numpy(_edge_x(t, c, seed=40))
    k0, mean0, var0 = (torch.from_numpy(v) for v in _float_state(c, 41))
    m = torch.from_numpy(np.linspace(1.5, 4.0, c).astype(np.float32))
    vl = torch.from_numpy(_vlen(t, c, seed=42) if ragged
                          else np.full(c, t, np.int32))
    carry = (k0, mean0 * k0, var0)
    whole = tf_kernel.teda_scan_plain(x, m, vl, *carry, full=full)
    parts = []
    cuts = (0, S - 1, S, S + 1, 2 * S, 2 * S + 1, t)
    for lo, hi in zip(cuts, cuts[1:]):
        part = tf_kernel.teda_scan_plain(
            x[lo:hi], m, (vl - lo).clamp(0, hi - lo).to(torch.int32),
            *carry, full=full)
        carry = part[4:]
        parts.append(part)
    valid = torch.arange(t)[:, None] < vl[None, :]
    for i, name in enumerate(("mean", "var", "ecc")):
        if whole[i] is None:
            assert not full and all(p[i] is None for p in parts)
            continue
        rows = torch.cat([p[i] for p in parts])
        assert torch.equal(_words(rows)[valid], _words(whole[i])[valid]), name
    assert torch.equal(torch.cat([p[3] for p in parts]), whole[3])
    for name, a, b in zip(("fk", "fsum", "fvar"), carry, whole[4:]):
        assert torch.equal(_words(a), _words(b)), name


# -------------------------------------------------------------- GPU
@pytest.mark.parametrize("full", [False, True])
def test_cuda_kernels_match_plain(cuda, full):
    """The CUDA kernels against their plain versions on the card."""
    t, c = 64, 300
    x = _x(t, c, seed=20)
    vl = torch.from_numpy(_vlen(t, c, seed=21))
    k0, mean0, var0 = (torch.from_numpy(v) for v in _float_state(c, 22))
    m = torch.linspace(1.5, 4.0, c)
    args = (torch.from_numpy(x), m, vl, k0, mean0 * k0, var0)
    plain = tf_kernel.teda_scan_call(*args, full=full)
    n = tf_kernel.launches
    kern = tf_kernel.teda_scan_call(*(a.to(cuda) for a in args), full=full)
    assert tf_kernel.launches == n + 1
    for p, k in zip(plain, kern):
        if p is None:
            assert k is None
        elif p.dtype == torch.bool:
            assert torch.equal(p, k.cpu())
        else:
            np.testing.assert_allclose(k.cpu().numpy(), p.numpy(),
                                       rtol=RTOL, atol=ATOL)
    fmt = TQ(*SPEC)
    qk0, qmean0, qvar0 = (torch.from_numpy(v) for v in _q_state(fmt, c, 23))
    qargs = (fmt.quantize(torch.from_numpy(x)),
             torch.full((c,), 10 << 20, dtype=torch.int32), vl, qk0,
             qmean0, qvar0)
    plain = tq_kernel.teda_q_scan_call(*qargs, fmt=fmt, full=full)
    kern = tq_kernel.teda_q_scan_call(*(a.to(cuda) for a in qargs),
                                      fmt=fmt, full=full)
    for p, k in zip(plain, kern):
        assert (p is None and k is None) or torch.equal(p, k.cpu())
