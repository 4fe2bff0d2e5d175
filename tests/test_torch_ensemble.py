"""The port's fused detector ensemble against the JAX package's.

On the CPU `ensemble_scan` runs the CUDA kernel's plain PyTorch version
(`kernels/ensemble_scan.py::ensemble_scan_plain`); it is held to the
JAX `ensemble_scan` (its Pallas kernel in interpret mode) over member
subsets, ragged valid lengths, NaN samples and a carried state, to the
port's own oracle composition `ensemble_ref` under selection and vote
variants, and to the port's float TEDA kernel's plain version on the
TEDA lane.  Exactness tiers are the reference's: bitmask, vote, final k
and the hst / teda-q scores and aux regions exact (aux compared as
int32 views, since some Q payloads are float NaN patterns); moment
scores within rtol 5e-3 / atol 5e-3 and moment aux rows within 1e-4
(the reference sums by blocks, the port row by row).  The CUDA kernel
itself is compared with the plain version only where a GPU is present.
"""
import numpy as np
import pytest
import torch

from repro.detectors.ensemble import ensemble_scan as j_scan
from repro.detectors.spec import ensemble_spec as j_spec
from repro.fixedpoint import QFormat as JQ
from repro_torch.detectors import vote_threshold
from repro_torch.detectors.ensemble import (EnsembleState, ensemble_init,
                                            ensemble_ref, ensemble_scan)
from repro_torch.detectors.spec import MOMENT_MEMBERS, ensemble_spec
from repro_torch.fixedpoint import QFormat as TQ
from repro_torch.kernels import ensemble_scan as ek
from repro_torch.kernels.teda_scan import teda_scan_plain

torch.set_num_threads(2)

ALL5 = ("teda", "rde", "zscore", "hst", "teda-q")
SPEC = (32, 20, "trunc")
RTOL = ATOL = 5e-3
T, C = 40, 8
SUBSETS = [(ALL5, 8), (("teda",), 8), (("rde", "zscore"), 3),
           (("teda-q", "hst"), 2), (("zscore", "teda-q", "teda"), 8)]


def _spiky(seed, t=T, c=C):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(t, c)) + rng.normal(0, 2, size=c)) \
        .astype(np.float32)
    spikes = rng.random((t, c)) < 0.05
    spikes[:3] = False
    x[spikes] += 12.0
    return x


def _m(c=C):
    return np.resize(np.array([2.0, 3.0, 2.5, 4.003289222717285],
                              np.float32), c)


def _vlen(seed, t=T, c=C):
    v = np.random.default_rng(seed).integers(0, t + 1, size=c)
    v[:3] = [0, 1, t]
    return v.astype(np.int32)


def _words(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32)


def _same_aux(dets, w, ta, ja, moment_tol=1e-4):
    spec = ensemble_spec(dets, w)
    ta, ja = np.asarray(ta), np.asarray(ja)
    for region in spec.regions:
        sl = spec.slc(region.name)
        if region.name.startswith("moment:"):
            np.testing.assert_allclose(ta[sl], ja[sl], rtol=moment_tol,
                                       atol=moment_tol, err_msg=region.name)
        else:
            np.testing.assert_array_equal(_words(ta[sl]), _words(ja[sl]),
                                          err_msg=region.name)


def _same_out(dets, tout, jout):
    np.testing.assert_array_equal(tout["det_flags"].numpy(),
                                  np.asarray(jout["det_flags"]))
    np.testing.assert_array_equal(tout["vote"].numpy(),
                                  np.asarray(jout["vote"]))
    ts, js = tout["scores"].numpy(), np.asarray(jout["scores"])
    assert ts.shape == js.shape == (len(dets),) + ts.shape[1:]
    for d, name in enumerate(dets):
        if name in MOMENT_MEMBERS:
            np.testing.assert_allclose(ts[d], js[d], rtol=RTOL, atol=ATOL,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(_words(ts[d]), _words(js[d]),
                                          err_msg=name)


@pytest.mark.parametrize("dets,w", SUBSETS,
                         ids=["+".join(d) + f"-w{w}" for d, w in SUBSETS])
def test_plain_kernel_matches_jax_kernel(dets, w):
    """Two chunks, the second from the carried state: a warm-up with
    ragged valid lengths (0, 1, T), then a dense one; per-channel m and
    one channel with NaN samples."""
    x, m, vl = _spiky(1), _m(), _vlen(2)
    x[[4, 25, 26], 5] = np.nan
    fmt, jfmt = TQ(*SPEC), JQ(*SPEC)
    tq = fmt if "teda-q" in dets else None
    jq = jfmt if "teda-q" in dets else None
    tst, jst = None, None
    flagged = 0
    for chunk, vlc in ((x[:T // 2], vl // 2), (x[T // 2:], None)):
        tst, tout = ensemble_scan(chunk, m, tst, detectors=dets, window=w,
                                  fmt=tq, valid_lens=vlc)
        jst, jout = j_scan(chunk, m, jst, detectors=dets, window=w, fmt=jq,
                           valid_lens=vlc, block_t=8, interpret=True)
        _same_out(dets, tout, jout)
        np.testing.assert_array_equal(tst.k.numpy(), np.asarray(jst.k))
        _same_aux(dets, w, tst.aux, jst.aux)
        assert tst.aux.shape == (j_spec(dets, w).rows, C)
        flagged += int(tout["det_flags"].ne(0).sum())
    assert flagged > 0
    np.testing.assert_array_equal(tst.k.numpy(), vl // 2 + T // 2)


@pytest.mark.parametrize("variant", ["unit", "weighted", "masked", "all"])
def test_plain_kernel_matches_ensemble_ref(variant):
    """Fresh streams, ragged: the fused kernel's bits and vote equal the
    composed oracles under selection and vote variants; hst / teda-q
    scores exact, moment scores within tolerance."""
    t, c = 64, 8
    x, m, vl = _spiky(3, t, c), _m(c), _vlen(4, t, c)
    w = np.ones(5, np.float32)
    if variant == "weighted":
        w = np.array([1.0, 0.5, 2.0, 0.25, 1.0], np.float32)
    sel = np.broadcast_to(w[:, None], (5, c)).copy()
    if variant == "masked":
        sel[:, 1::3] = 0.0      # one member alone on some channels
        sel[0, 1::3] = 1.0
        sel[2, 2::3] = 0.0      # one member unselected on others
    mode = {"all": "all", "weighted": "majority"}.get(variant, "any")
    thr = np.array([vote_threshold(mode, sel[:, i]) for i in range(c)],
                   np.float32)
    kw = dict(detectors=ALL5, window=4, fmt=TQ(*SPEC), valid_lens=vl,
              sel=sel, thr=thr)
    _, out = ensemble_scan(x, m, **kw)
    ref = ensemble_ref(x, m, **kw)
    assert torch.equal(out["det_flags"], ref["det_flags"])
    assert torch.equal(out["vote"], ref["vote"])
    for d, name in enumerate(ALL5):
        got, want = out["scores"][d], ref["per_score"][name]
        if name in MOMENT_MEMBERS:
            torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
        else:
            assert torch.equal(got, want), name
    assert out["det_flags"].ne(0).any()
    assert out["vote"].any() or variant == "all"
    # nothing past a channel's valid prefix
    dead = torch.arange(t)[:, None] >= torch.from_numpy(vl)[None, :]
    assert not out["det_flags"][dead].any() and not out["vote"][dead].any()
    assert not out["scores"][:, dead].any()


def test_chunked_carry_equals_full_run():
    x, m = _spiky(5, 64, C), _m()
    kw = dict(detectors=ALL5, window=8, fmt=TQ(*SPEC))
    full_st, full = ensemble_scan(x, m, **kw)
    st = ensemble_init(C, 8, detectors=ALL5)
    outs = []
    for lo, hi in ((0, 11), (11, 37), (37, 64)):
        st, o = ensemble_scan(x[lo:hi], m, st, **kw)
        outs.append(o)
    for key in ("det_flags", "vote"):
        assert torch.equal(torch.cat([o[key] for o in outs]), full[key])
    assert torch.equal(torch.cat([o["scores"] for o in outs], 1),
                       full["scores"])
    assert torch.equal(st.k, full_st.k)
    # row-sequential sums: the chunked carry is the single-shot one,
    # bit for bit, moment rows included
    assert torch.equal(st.aux.view(torch.int32),
                       full_st.aux.view(torch.int32))


def test_teda_lane_bitidentical_to_teda_scan_plain():
    """The ensemble's TEDA lane is `csrc/teda_scan.cu`'s arithmetic:
    from the same carried (k, S, var), eccentricity, flags and the final
    carries are bit-identical to the float kernel's plain version."""
    x, m = _spiky(6, 48, C), _m()
    w = 8
    st = ensemble_init(C, w, detectors=("teda",))
    for lo, hi, vl in ((0, 20, _vlen(7, 20)), (20, 48, None)):
        chunk = torch.from_numpy(x[lo:hi])
        vlen = torch.from_numpy(_vlen(7, 20) if vl is not None
                                else np.full(C, hi - lo, np.int32))
        _, _, ecc, outl, fk, fsum, fvar = teda_scan_plain(
            chunk, torch.from_numpy(m), vlen, st.k, st.aux[w - 1],
            st.aux[2 * w])
        st, out = ensemble_scan(chunk, m, st, detectors=("teda",),
                                window=w, valid_lens=vl)
        live = torch.arange(hi - lo)[:, None] < vlen[None, :]
        assert torch.equal(out["scores"][0], torch.where(live, ecc, 0.0))
        assert torch.equal(out["det_flags"] == 1, outl)
        assert torch.equal(st.k, fk)
        assert torch.equal(st.aux[w - 1], fsum)
        assert torch.equal(st.aux[2 * w], fvar)
    assert out["det_flags"].any()


@pytest.mark.parametrize("d,name", list(enumerate(ALL5)), ids=list(ALL5))
def test_selection_mask_equals_single_detector(d, name):
    """Zero-weighting all but one member equals the one-member ensemble:
    same flags (at bit d), same vote, same k."""
    x, m = _spiky(8, 48, C), _m()
    sel = np.zeros((5, C), np.float32)
    sel[d] = 1.0
    fmt = TQ(*SPEC)
    fm, masked = ensemble_scan(x, m, detectors=ALL5, window=4, fmt=fmt,
                               sel=sel)
    fs, single = ensemble_scan(x, m, detectors=(name,), window=4, fmt=fmt)
    assert torch.equal(masked["det_flags"], single["det_flags"] << d)
    assert torch.equal(masked["vote"], single["vote"])
    assert torch.equal(masked["scores"][d], single["scores"][0])
    assert torch.equal(fm.k, fs.k)


def test_selection_leaves_state_untouched():
    x, m = _spiky(9), _m()
    sel = np.zeros((5, C), np.float32)
    sel[1] = 1.0
    kw = dict(detectors=ALL5, fmt=TQ(*SPEC))
    fm, _ = ensemble_scan(x, m, sel=sel, **kw)
    ff, _ = ensemble_scan(x, m, **kw)
    assert torch.equal(fm.k, ff.k)
    assert torch.equal(fm.aux.view(torch.int32), ff.aux.view(torch.int32))


def test_vote_host_recomputable_in_detector_order():
    x, m = _spiky(10), _m()
    w = np.array([1.0, 0.5, 1.0, 0.25, 2.0], np.float32)
    sel = np.broadcast_to(w[:, None], (5, C))
    thr = np.full(C, 2.0, np.float32)
    _, out = ensemble_scan(x, m, detectors=ALL5, window=4, fmt=TQ(*SPEC),
                           sel=sel, thr=thr)
    bits = out["det_flags"].numpy()
    votew = np.zeros(bits.shape, np.float32)
    for d in range(5):
        votew = (votew + ((bits >> d) & 1).astype(np.float32) * w[d]) \
            .astype(np.float32)
    np.testing.assert_array_equal(out["vote"].numpy(), votew >= 2.0)
    assert bits.any()


def _payload_aux(dets, w, c, seed):
    """An aux block of arbitrary 32-bit words, NaN patterns included."""
    rows = ensemble_spec(dets, w).rows
    rng = np.random.default_rng(seed)
    words = rng.integers(-2 ** 31, 2 ** 31, size=(rows, c), dtype=np.int64)
    words[:, ::2] = 0x7FC00001  # a quiet-NaN pattern in every row
    return torch.from_numpy(words.astype(np.int32)).view(torch.float32)


@pytest.mark.parametrize("dets", [("teda",), ("rde",), ("hst",),
                                  ("teda-q",), ("zscore", "hst")],
                         ids=["teda", "rde", "hst", "teda-q", "zscore+hst"])
def test_rows_a_member_does_not_own_keep_their_bits(dets):
    """The reference's carry discipline: without zscore only row W-1 of
    the S tail (and row 2W-1 of S2, with rde) advances; the variance
    row advances only with teda; with no moment member rows [0, 2W]
    stay; vlen = 0 channels keep every word.  With zscore, tail row j
    holds S_{k-(W-1)+j} for the valid extent."""
    w, c = 4, 6
    x = _spiky(11, 12, c)
    aux = _payload_aux(dets, w, c, 12)
    if "zscore" in dets:  # a fresh tail, so S is the plain prefix sum
        aux[:2 * w + 1] = 0.0
    vl = np.array([0, 12, 5, 1, 12, 7], np.int32)
    st, _ = ensemble_scan(x, 3.0, EnsembleState(torch.zeros(c), aux),
                          detectors=dets, window=w, fmt=TQ(*SPEC),
                          valid_lens=vl)
    before, after = aux.view(torch.int32), st.aux.view(torch.int32)
    assert torch.equal(after[:, 0], before[:, 0])  # vlen 0: every word
    moved = set()
    if any(d in MOMENT_MEMBERS for d in dets):
        moved.add(w - 1)
    if "rde" in dets or "zscore" in dets:
        moved.add(2 * w - 1)
    if "teda" in dets:
        moved.add(2 * w)
    if "zscore" in dets:
        moved |= set(range(2 * w))
    for r in range(2 * w + 1):
        if r not in moved:
            assert torch.equal(after[r], before[r]), r
    if "zscore" in dets:
        for ch in range(1, c):
            n = int(vl[ch])
            s = np.concatenate([np.zeros(w, np.float32),
                                np.cumsum(x[:n, ch], dtype=np.float32)])
            np.testing.assert_array_equal(st.aux[0:w, ch].numpy(),
                                          s[n:n + w])


def test_q_payloads_survive_the_kernel_and_the_engine():
    """int32 Q registers whose bits are float NaNs come back unchanged
    where nothing advances them: through the kernel on vlen = 0
    channels, and through the engine's freeze."""
    from repro_torch.engine import StreamEngine
    c = 4
    eng = StreamEngine(c, "ensemble", device="cpu", detectors=ALL5,
                       fmt=TQ(*SPEC))
    aux = _payload_aux(ALL5, 8, c, 13).view(torch.int32).numpy()
    z = np.zeros(c, np.float32)
    eng.load_state((z, z, z, np.ones(c, bool), aux))
    out = eng.process(_spiky(14, 8, c), valid_lens=[0, 8, 0, 3])
    got = eng.state.aux.view(torch.int32).numpy()
    np.testing.assert_array_equal(got[:, [0, 2]], aux[:, [0, 2]])
    assert not out["det_flags"][:, [0, 2]].any()


def test_rejects_bad_args():
    x = np.zeros((4, 2), np.float32)
    for bad in ((), ("teda", "teda"), ("teda", "lof")):
        with pytest.raises(ValueError, match="non-empty unique subset"):
            ensemble_scan(x, detectors=bad)
    with pytest.raises(ValueError, match="state.aux"):
        ensemble_scan(x, state=ensemble_init(2, window=4), window=8)
    with pytest.raises(ValueError, match="needs fmt=QFormat"):
        ensemble_scan(x, detectors=("teda", "teda-q"))
    with pytest.raises(ValueError, match="multiple of 128"):
        ensemble_scan(x, block_c=100)
    z = torch.zeros(2)
    with pytest.raises(ValueError, match="sel"):
        ek.ensemble_scan_call(torch.zeros(4, 2), z.int(), z, z, z,
                              torch.zeros(2, 2), torch.zeros(17, 2),
                              detectors=("teda",), window=8)
    with pytest.raises(ValueError, match="needs fmt"):
        ek.ensemble_scan_call(torch.zeros(4, 2), z.int(), z, z, z,
                              torch.zeros(1, 2), torch.zeros(19, 2),
                              detectors=("teda-q",), window=8)


def _wrapper_args(seed, t, c, vl):
    x = _spiky(seed, t, c)
    x[4::13, 1] = np.nan
    return [torch.from_numpy(a) for a in (
        x, vl, np.full(c, 5.0, np.float32), _m(c),
        np.full(c, 2.5, np.float32), np.ones((5, c), np.float32),
        np.zeros((ensemble_spec(ALL5, 8).rows, c), np.float32))]


def _bits_equal(got, want):
    for a, b in zip(got, want):
        a = a.cpu()
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)


def test_wrapper_clamps_vlen():
    """A valid length below 0 or above T acts as 0 or T: rows, scores,
    the final k and the carried aux all equal the clamped call's."""
    t, c = 24, 6
    vl = np.array([-3, 0, 7, t, t + 5, 2**30], np.int32)
    kw = dict(detectors=ALL5, window=8, fmt=TQ(*SPEC))
    args = _wrapper_args(18, t, c, vl)
    want = ek.ensemble_scan_call(
        *args[:1], torch.from_numpy(np.clip(vl, 0, t)), *args[2:], **kw)
    _bits_equal(ek.ensemble_scan_call(*args, **kw), want)
    np.testing.assert_array_equal(want[2].numpy(), 5.0 + np.clip(vl, 0, t))


def test_plain_version_launches_nothing():
    n = ek.launches
    ensemble_scan(_spiky(15, 8, 3), detectors=ALL5, fmt=TQ(*SPEC))
    assert ek.launches == n


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the GPU")
    return torch.device("cuda")


def test_cuda_kernel_matches_plain(cuda):
    """The CUDA kernel against its plain version on the card: bits,
    vote, k, scores and aux words all bit-exact."""
    t, c = 96, 300
    x, m, vl = _spiky(16, t, c), _m(c), _vlen(17, t, c)
    x[5::31, 7] = np.nan
    sel = np.ones((5, c), np.float32)
    sel[0, ::4] = 0.0
    thr = np.resize(np.array([1.0, 2.5, 5.0], np.float32), c)
    args = [torch.from_numpy(a) for a in (
        x, vl, np.zeros(c, np.float32), m, thr, sel,
        np.zeros((ensemble_spec(ALL5, 8).rows, c), np.float32))]
    kw = dict(detectors=ALL5, window=8, fmt=TQ(*SPEC))
    warm = ek.ensemble_scan_plain(*args, **kw)
    args[2], args[6] = warm[2], warm[3]
    plain = ek.ensemble_scan_plain(*args, **kw)
    n = ek.launches
    kern = ek.ensemble_scan_call(*(a.to(cuda) for a in args), **kw)
    torch.cuda.synchronize()
    assert ek.launches == n + 1
    for a, b in zip(kern, plain):
        a = a.cpu()
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)


def test_cuda_kernel_clamps_vlen(cuda):
    """Out-of-range valid lengths reach the kernel clamped to [0, T]."""
    t, c = 24, 6
    vl = np.array([-3, 0, 7, t, t + 5, 2**30], np.int32)
    kw = dict(detectors=ALL5, window=8, fmt=TQ(*SPEC))
    args = _wrapper_args(18, t, c, vl)
    want = ek.ensemble_scan_plain(
        *args[:1], torch.from_numpy(np.clip(vl, 0, t)), *args[2:], **kw)
    kern = ek.ensemble_scan_call(*(a.to(cuda) for a in args), **kw)
    torch.cuda.synchronize()
    _bits_equal(kern, want)
