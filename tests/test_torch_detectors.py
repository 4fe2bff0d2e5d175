"""The port's detector oracles against the JAX package's.

Each of the five members — teda, rde, zscore, hst, teda-q — gets the
same numpy stream and per-channel m in both packages, dense, ragged
(valid lengths 0, 1, T and between) and chunked with the state carried
across the cut.  hst and teda-q are exact (flags, scores, carried
state); teda, rde and zscore have equal flags on well-separated spiky
data and scores within rtol 5e-3 / atol 5e-3, the reference's own
tolerance for moment scores (`s2/k - mean^2` cancels at small k).
"""
import numpy as np
import pytest
import torch

from repro.detectors import hst as j_hst
from repro.detectors import rde as j_rde
from repro.detectors import teda as j_teda
from repro.detectors import teda_q as j_tq
from repro.detectors import zscore as j_z
from repro.fixedpoint import QFormat as JQ
from repro_torch.detectors import hst as t_hst
from repro_torch.detectors import rde as t_rde
from repro_torch.detectors import teda as t_teda
from repro_torch.detectors import teda_q as t_tq
from repro_torch.detectors import zscore as t_z
from repro_torch.fixedpoint import QFormat as TQ

torch.set_num_threads(2)

RTOL = ATOL = 5e-3
SPEC = (32, 20, "trunc")
T, C, CUT = 64, 6, 37
# zscore's squared z-score is at most W - 1, so W = 8 lets it flag at
# m = 2; hst's reference window (W * 8 samples) fills at row 32 with W = 4
W_Z, W = 8, 4
EXACT = ("hst", "teda-q")


def _spiky(seed, t=T, c=C):
    """Unit noise around per-channel levels with sparse +12 spikes: the
    flags sit far from every threshold."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(t, c)) + rng.normal(0, 2, size=c)) \
        .astype(np.float32)
    spikes = rng.random((t, c)) < 0.05
    spikes[:3] = False
    x[spikes] += 12.0
    return x


def _m(c=C):
    # m = 4.003289222717285 is where the float32 and float64
    # quantizations of m^2+1 differ
    return np.resize(np.array([2.0, 3.0, 2.5, 4.003289222717285],
                              np.float32), c)


def _vlen(seed, t=T, c=C):
    v = np.random.default_rng(seed).integers(0, t + 1, size=c)
    v[:3] = [0, 1, t]
    return v.astype(np.int32)


def _run(side, name, x, m, state, vl):
    """(state', {"outlier", "score"}) of one package's oracle."""
    if side == "jax":
        mods = {"teda": j_teda, "rde": j_rde, "zscore": j_z, "hst": j_hst,
                "teda-q": j_tq}
        fmt, xv, mv = JQ(*SPEC), x, m
    else:
        mods = {"teda": t_teda, "rde": t_rde, "zscore": t_z, "hst": t_hst,
                "teda-q": t_tq}
        fmt, xv, mv = TQ(*SPEC), torch.from_numpy(x), torch.from_numpy(m)
    mod = mods[name]
    if name == "teda":
        return mod.teda_detector_scan(xv, mv, state, valid_lens=vl)
    if name == "rde":
        return mod.rde_scan(xv, mv, state, valid_lens=vl)
    if name == "zscore":
        return mod.zscore_scan(xv, mv, state, window=W_Z, valid_lens=vl)
    if name == "hst":
        return mod.hst_scan(xv, mv, state, window=W, valid_lens=vl)
    return mod.teda_q_member_scan(xv, fmt, mv, state, valid_lens=vl)


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _same(name, tout, jout, tst, jst, vl):
    np.testing.assert_array_equal(_np(tout["outlier"]), _np(jout["outlier"]),
                                  err_msg=f"{name} flags")
    ts, js = _np(tout["score"]), _np(jout["score"])
    if vl is not None:  # moment oracles leave invalid rows unspecified
        live = np.arange(ts.shape[0])[:, None] < np.asarray(vl)[None, :]
        ts, js = np.where(live, ts, 0), np.where(live, js, 0)
    if name in EXACT:
        np.testing.assert_array_equal(ts.view(np.int32), js.view(np.int32),
                                      err_msg=f"{name} scores")
    else:
        np.testing.assert_allclose(ts, js, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name} scores")
    for f, a, b in zip(tst._fields, tst, jst):
        a, b = _np(a), _np(b)
        if name in EXACT or f == "k":
            np.testing.assert_array_equal(a, b, err_msg=f"{name} {f}")
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5,
                                       err_msg=f"{name} {f}")


NAMES = ["teda", "rde", "zscore", "hst", "teda-q"]
MODES = ["dense", "ragged", "chunked"]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", NAMES)
def test_oracle_matches_jax(name, mode):
    x, m = _spiky(10 * NAMES.index(name) + MODES.index(mode)), _m()
    vl = _vlen(7) if mode == "ragged" else None
    if mode == "chunked":
        tst, tout = _run("torch", name, x[:CUT], m, None, None)
        jst, jout = _run("jax", name, x[:CUT], m, None, None)
        _same(name, tout, jout, tst, jst, None)
        tst, tout2 = _run("torch", name, x[CUT:], m, tst, None)
        jst, jout2 = _run("jax", name, x[CUT:], m, jst, None)
        flags = np.concatenate([_np(tout["outlier"]),
                                _np(tout2["outlier"])])
        _same(name, tout2, jout2, tst, jst, None)
        # chunked equals the single-shot run inside the port
        _, full = _run("torch", name, x, m, None, None)
        np.testing.assert_array_equal(flags, _np(full["outlier"]))
    else:
        tst, tout = _run("torch", name, x, m, None, vl)
        jst, jout = _run("jax", name, x, m, None, vl)
        _same(name, tout, jout, tst, jst, vl)
        flags = _np(tout["outlier"])
    assert flags.any(), f"{name}: the stream raised no flag"
    if vl is not None:
        assert not flags[:, 0].any()  # vlen 0
        if "k" in tst._fields:
            np.testing.assert_array_equal(_np(tst.k)[:3], [0, 1, T])


def test_hst_nan_samples_match_jax():
    """A NaN sample has no leaf: score 0, a flag once the reference
    table is filled, no cell count, and the phase still advances."""
    x, m = _spiky(11), _m()
    x[[5, 40, 41, 50], 1] = np.nan
    x[45:, 3] = np.nan
    tst, tout = _run("torch", "hst", x, m, None, None)
    jst, jout = _run("jax", "hst", x, m, None, None)
    _same("hst", tout, jout, tst, jst, None)
    flags, scores = _np(tout["outlier"]), _np(tout["score"])
    assert flags[40, 1] and flags[41, 1] and flags[45:, 3].all()
    assert scores[40, 1] == 0.0 and not flags[5, 1]  # table not filled
    # the phase counted every sample, NaN or not
    np.testing.assert_array_equal(_np(tst.phase), np.full(C, T % (W * 8)))


def test_teda_q_member_at_the_msq1_rounding_point():
    """m = 4.003289222717285 on every channel: the member quantizes
    m^2+1 in float32, as the JAX member does."""
    x = _spiky(12)
    x[20::9] += 40.0
    m = np.full(C, 4.003289222717285, np.float32)
    tst, tout = _run("torch", "teda-q", x, m, None, _vlen(13))
    jst, jout = _run("jax", "teda-q", x, m, None, _vlen(13))
    _same("teda-q", tout, jout, tst, jst, _vlen(13))
    np.testing.assert_array_equal(_np(tout["ecc"]), _np(jout["ecc"]))
    assert _np(tout["outlier"]).any()
