"""The port's detector-state layout against the JAX package's.

`StateSpec` layouts (names, tags, rows, offsets) equal the reference's
for every member subset and order at W in {1, 3, 8}; the int32 <-> f32
bit views round-trip NaN-aliasing payloads, also through the engine's
aux moves; `vote_threshold`, `aux_rows`, `hst_leaf` and the teda-q ROM
constant (`member_msq1`, float32) are bit-equal to JAX's.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.detectors import aux_rows as j_aux_rows
from repro.detectors import vote_threshold as j_vote
from repro.detectors.hst import hst_leaf as j_hst_leaf
from repro.detectors.spec import ensemble_spec as j_spec
from repro.detectors.spec import f32_to_i32_bits as j_f2i
from repro.detectors.spec import i32_to_f32_bits as j_i2f
from repro.detectors.teda_q import member_msq1 as j_msq1
from repro.fixedpoint import QFormat as JQ
from repro_torch.detectors import aux_rows, vote_threshold
from repro_torch.detectors.hst import hst_leaf
from repro_torch.detectors.spec import (Region, ensemble_spec,
                                        f32_to_i32_bits, i32_to_f32_bits,
                                        member_regions)
from repro_torch.detectors.teda_q import member_msq1
from repro_torch.engine.state import (engine_init, engine_reset,
                                      engine_state_from_numpy)
from repro_torch.fixedpoint import QFormat as TQ
from repro_torch.fixedpoint import msq1_const

ALL5 = ("teda", "rde", "zscore", "hst", "teda-q")

#: int32 payloads whose bits are float NaNs (quiet, signalling, negative)
#: or other special floats, beside ordinary Q values
NAN_PAYLOADS = np.array([0x7FC00001, 0x7F800001, -0x00000001, 0x7FFFFFFF,
                         -0x7FFFFFFF, 0x7F800000, -0x80000000, 0, 1,
                         2143289345, -4194304], np.int64).astype(np.int32)


def _subsets():
    """Every non-empty member subset in canonical order, plus a few
    reorderings (opaque regions follow the detector order)."""
    subs = [s for n in range(1, 6) for s in itertools.combinations(ALL5, n)]
    return subs + [("teda-q", "hst"), ("hst", "teda", "teda-q"),
                   ("teda-q", "zscore", "hst", "rde", "teda")]


@pytest.mark.parametrize("window", [1, 3, 8])
def test_layout_equals_jax_for_every_subset(window):
    for dets in _subsets():
        t, j = ensemble_spec(dets, window), j_spec(dets, window)
        assert [tuple(r) for r in t.regions] == \
            [tuple(r) for r in j.regions], dets
        assert t.rows == j.rows == aux_rows(window, dets) \
            == j_aux_rows(window, dets)
        for name in t.names():
            assert t.offset(name) == j.offset(name)
            assert t.slc(name) == j.slc(name)
            assert t.has(name) and j.has(name)
    assert aux_rows(window) == j_aux_rows(window) == 2 * window + 1


def test_spec_errors_and_init():
    with pytest.raises(ValueError, match="window"):
        ensemble_spec(("teda",), 0)
    with pytest.raises(ValueError, match="window"):
        aux_rows(0)
    with pytest.raises(KeyError, match="unknown ensemble member"):
        member_regions("lof", 8)
    spec = ensemble_spec(ALL5, 8)
    assert spec.rows == 36 and not spec.has("lof")
    with pytest.raises(KeyError, match="no region"):
        spec.offset("lof")
    aux = spec.init_aux(5)
    assert aux.shape == (36, 5) and aux.dtype == torch.float32
    assert not aux.view(torch.int32).any()
    spec.validate_aux(aux, 5)
    with pytest.raises(ValueError, match=r"state.aux must be \(36, 4\)"):
        spec.validate_aux(aux, 4)
    assert spec.region("teda-q:var") == Region("teda-q:var", 1, "i32")


def test_bit_views_round_trip_nan_payloads():
    q = torch.from_numpy(NAN_PAYLOADS)
    f = i32_to_f32_bits(q)
    assert f.dtype == torch.float32
    assert torch.equal(f32_to_i32_bits(f), q)
    assert torch.equal(f32_to_i32_bits(f.clone()), q)
    # the same bits as the JAX bitcasts
    jf = np.asarray(j_i2f(jnp.asarray(NAN_PAYLOADS)))
    np.testing.assert_array_equal(f.numpy().view(np.int32),
                                  jf.view(np.int32))
    np.testing.assert_array_equal(
        np.asarray(j_f2i(jnp.asarray(jf))), NAN_PAYLOADS)


def test_engine_moves_aux_as_raw_bits():
    """The hand-off (int32 or float32 words), reset and the state select
    keep NaN-aliasing payloads bit for bit."""
    c = len(NAN_PAYLOADS)
    words = np.stack([NAN_PAYLOADS, NAN_PAYLOADS[::-1]])
    z = np.zeros(c, np.float32)
    for aux in (words, words.view(np.float32)):
        st = engine_state_from_numpy(z, z, z, np.ones(c, bool),
                                     dtype=torch.float32, device="cpu",
                                     aux=aux)
        assert st.aux.dtype == torch.float32
        np.testing.assert_array_equal(st.aux.view(torch.int32).numpy(),
                                      words)
        keep = np.arange(c) % 2 == 0
        st2 = engine_reset(st, np.flatnonzero(~keep))
        got = st2.aux.view(torch.int32).numpy()
        np.testing.assert_array_equal(got[:, keep], words[:, keep])
        assert not got[:, ~keep].any()
    with pytest.raises(TypeError, match="int32 or float32"):
        engine_state_from_numpy(z, z, z, np.ones(c, bool),
                                dtype=torch.float32, device="cpu",
                                aux=words.astype(np.int64))
    assert engine_init(4).aux is None
    assert engine_init(4, aux_rows=17).aux.shape == (17, 4)


@pytest.mark.parametrize("weights", [
    [1.0, 1.0, 1.0], [1.0, 0.5, 2.0], [0.0, 1.0, 0.0],
    [1.0, 1.0, 1.0, 0.25, 2.0], [0.1, 0.2, 0.7], [0.0, 0.0, 0.0]])
def test_vote_threshold_bit_equal_to_jax(weights):
    for vote in ("any", "majority", "all", 0.5, 1.0, 0.3, 1 / 3, 0.9):
        t, j = vote_threshold(vote, weights), j_vote(vote, weights)
        assert type(t) is type(j) is float
        assert np.float32(t).tobytes() == np.float32(j).tobytes(), vote
        assert t == j, vote
    for bad in ("quorum", 0.0, 1.5, -0.25, None, True):
        with pytest.raises(ValueError):
            vote_threshold(bad, weights)


def test_hst_leaf_equals_jax():
    x = np.array([np.nan, -np.inf, np.inf, -4.0, -4.0001, -3.9999, -0.5,
                  0.0, 0.5, 3.0, 3.999, 4.0, 1e30, -1e30, 2.5, -2.5],
                 np.float32)
    got = hst_leaf(torch.from_numpy(x)).numpy()
    want = np.asarray(j_hst_leaf(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)  # NaN stays NaN on both
    assert np.isnan(got[0])


def test_member_msq1_is_the_float32_quantization():
    fmt, jfmt = TQ(32, 20), JQ(32, 20)
    m = np.array([2.0, 3.0, 4.5, 4.003289222717285, 0.5, 5.999, 100.0,
                  np.nan], np.float32)
    got = member_msq1(fmt, torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_msq1(jfmt, m)))
    # at m = 4.003289222717285 the float32 and float64 paths differ by
    # one in the last bit: the ensemble must use the float32 one
    assert got[3] == 17853396
    assert int(msq1_const(fmt, float(m[3]))) == 17853395
    assert got[7] == 0  # NaN quantizes to 0
