"""The port's TEDAGuard and StragglerDetector against the JAX package's.

The reference's three telemetry streams (`tests/test_guard.py`: a loss
spike, a NaN, a spike train), and the (loss, grad norm) trace of a
24-step llama3.2-1b run at full width, go through both guards step by
step: the skip verdicts, every step's per-channel outlier flags and the
final `skipped` count are equal, and the carried TEDA state holds rtol
1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import GuardConfig as JGuardConfig
from repro.core import StragglerDetector as JStraggler
from repro.core import guard_init as jguard_init
from repro.core import guard_step as jguard_step
from repro_torch.core import (GuardConfig, StragglerDetector, apply_guard,
                              guard_init, guard_step)


def _spike():
    rng = np.random.default_rng(0)
    loss = 2.0 + 0.05 * rng.normal(size=100)
    gnorm = 1.0 + 0.02 * rng.normal(size=100)
    loss[70] = 40.0
    return np.stack([loss, gnorm], -1), dict(m=3.0, warmup_steps=20)


def _nan():
    rng = np.random.default_rng(1)
    loss = 2.0 + 0.05 * rng.normal(size=50)
    loss[40] = np.nan
    return np.stack([loss, np.ones(50)], -1), dict(m=3.0, warmup_steps=10)


def _spike_train(exclude=True):
    rng = np.random.default_rng(2)
    loss = 2.0 + 0.05 * rng.normal(size=120)
    loss[80:100] = 30.0
    return np.stack([loss, np.ones(120)], -1), dict(
        m=3.0, warmup_steps=20, exclude_outliers=exclude)


def _run_both(stream, kw):
    jcfg, tcfg = JGuardConfig(**kw), GuardConfig(**kw)
    js, ts = jguard_init(jcfg), guard_init(tcfg, device="cpu")
    jskips, tskips = [], []
    for row in stream.astype(np.float32):
        js, jv = jguard_step(js, jnp.asarray(row), jcfg)
        ts, tv = guard_step(ts, torch.from_numpy(row), tcfg)
        assert tv.skip.dtype == torch.bool and tv.skip.ndim == 0
        jskips.append(bool(jv.skip))
        tskips.append(bool(tv.skip))
        np.testing.assert_array_equal(ts.last_outlier.numpy(),
                                      np.asarray(js.last_outlier))
    return js, ts, np.asarray(jskips), np.asarray(tskips)


# `chip_smoke.py` phase 8 (b) on an NVIDIA H100: llama3.2-1b at full
# width, batch 8 x seq 128, a saturated batch at steps 10 and 20
FULL_WIDTH_LOSS = [
    12.241739273071289, 9.515924453735352, 11.637725830078125,
    8.751355171203613, 10.231834411621094, 14.03995418548584,
    14.454557418823242, 10.269889831542969, 9.025087356567383,
    7.796025276184082, 11.600310325622559, 7.179168701171875,
    6.678572177886963, 6.538489818572998, 6.0885844230651855,
    5.813940525054932, 5.458004951477051, 5.594252586364746,
    5.266526222229004, 5.549559593200684, 0.0, 5.35935640335083,
    5.004388809204102, 5.197635650634766]
FULL_WIDTH_GNORM = [
    30.22688102722168, 31.86815071105957, 26.07664680480957,
    48.456600189208984, 38.08823776245117, 27.867191314697266,
    46.22805404663086, 30.801490783691406, 20.145063400268555,
    8.303566932678223, 102.78016662597656, 22.690847396850586,
    6.12516450881958, 14.326018333435059, 11.958531379699707,
    8.579713821411133, 3.801534414291382, 12.043008804321289,
    11.850351333618164, 8.659337997436523, 6.86269956418073e-08,
    4.588312149047852, 4.630640029907227, 3.95149302482605]


def _full_width():
    return (np.stack([FULL_WIDTH_LOSS, FULL_WIDTH_GNORM], -1),
            dict(m=3.0, warmup_steps=8))


@pytest.mark.parametrize("make", [_spike, _nan, _spike_train,
                                  lambda: _spike_train(False), _full_width],
                         ids=["spike", "nan", "spike_train",
                              "spike_train_absorbed", "full_width_trace"])
def test_guard_streams_match_reference(make):
    stream, kw = make()
    js, ts, jsk, tsk = _run_both(stream, kw)
    np.testing.assert_array_equal(tsk, jsk)
    assert int(ts.skipped) == int(js.skipped) == tsk.sum()
    for a, b in ((ts.teda.k, js.teda.k), (ts.teda.mean, js.teda.mean),
                 (ts.teda.var, js.teda.var)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    assert tsk[:kw["warmup_steps"]].sum() == 0


def test_full_width_trace_trips_neither_guard():
    """The saturated batches at steps 10 and 20 of the full-width trace
    read eccentric but under the threshold on both guards: the grad-norm
    spike at step 10 misses by ~2%, and the trivially predictable batch
    at step 20 (loss 0) sits inside the variance of the falling loss."""
    js, ts, jsk, tsk = _run_both(*_full_width())
    assert not jsk.any() and not tsk.any()


def test_guard_catches_what_the_reference_catches():
    _, _, _, tsk = _run_both(*_spike())
    assert tsk[70]
    _, _, _, tsk = _run_both(*_nan())
    assert tsk[40]
    stream, kw = _spike_train()
    _, _, _, tsk = _run_both(stream, kw)
    assert tsk[80:100].sum() >= 18


def test_apply_guard_masks_tree():
    old = {"w": torch.zeros(3), "b": [torch.zeros(())]}
    new = {"w": torch.ones(3), "b": [torch.ones(())]}
    kept = apply_guard(torch.tensor(True), new, old)
    assert torch.equal(kept["w"], old["w"]) and kept["b"][0] == 0
    taken = apply_guard(torch.tensor(False), new, old)
    assert torch.equal(taken["w"], new["w"]) and taken["b"][0] == 1


def test_straggler_trips_match_reference():
    rng = np.random.default_rng(3)
    times = 1.0 + 0.01 * rng.normal(size=60)
    times[[30, 45, 46]] = [5.0, 3.0, 0.2]
    j, t = JStraggler(m=3.0, warmup=10), StragglerDetector(m=3.0, warmup=10)
    trips = [(j.check(float(d)), t.check(float(d))) for d in times]
    assert [a for a, _ in trips] == [b for _, b in trips]
    assert t.trips == j.trips >= 1
    assert (t.k, t.mean, t.var) == (j.k, j.mean, j.var)


def test_guard_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        guard_init(GuardConfig())
