"""The port's TEDA data clouds against the JAX package's, on the CPU.

`tests/test_clouds.py`'s inputs (three sequential blobs, a saturating
capacity of 2, a stationary stream) go through both `clouds_run`s:
memberships, counts k and `n_active` are equal, cloud means and
variances hold rtol 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.clouds import clouds_run as jclouds_run
from repro.core.clouds import clouds_step as jclouds_step
from repro.core.clouds import clouds_init as jclouds_init
from repro_torch.core import clouds_init, clouds_run, clouds_step


def _blobs(per=60, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(per, 2)) * 0.15 + np.array([0.0, 0.0])
    b = rng.normal(size=(per, 2)) * 0.15 + np.array([5.0, 5.0])
    c = rng.normal(size=(per, 2)) * 0.15 + np.array([-5.0, 5.0])
    return np.concatenate([a, b, c], axis=0).astype(np.float32)


def _stationary():
    rng = np.random.default_rng(1)
    return rng.normal(size=(200, 3)).astype(np.float32) * 0.1


@pytest.mark.parametrize("x,capacity,expect", [
    (_blobs(), 8, 3), (_blobs(per=30), 2, 2), (_stationary(), 8, 1)],
    ids=["three_blobs", "saturation", "stationary"])
def test_clouds_run_matches_reference(x, capacity, expect):
    js, jmem = jclouds_run(jnp.asarray(x), capacity=capacity, m=3.0)
    ts, tmem = clouds_run(torch.from_numpy(x), capacity=capacity, m=3.0)
    np.testing.assert_array_equal(tmem.numpy(), np.asarray(jmem))
    np.testing.assert_array_equal(ts.k.numpy(), np.asarray(js.k))
    assert int(ts.n_active) == int(js.n_active) == expect
    np.testing.assert_allclose(ts.mean.numpy(), np.asarray(js.mean),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ts.var.numpy(), np.asarray(js.var),
                               rtol=1e-5, atol=1e-7)
    assert bool(tmem.any(dim=1).all())  # nobody dropped


def test_clouds_step_and_init():
    ts = clouds_init(4, 2, device="cpu")
    js = jclouds_init(4, 2)
    for v in ([1.0, 2.0], [1.1, 2.1], [9.0, -3.0]):
        ts, tm = clouds_step(ts, torch.tensor(v), 3.0)
        js, jm = jclouds_step(js, jnp.asarray(v), 3.0)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert int(ts.n_active) == int(js.n_active)
    assert ts.n_active.dtype == torch.int32


def test_clouds_init_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        clouds_init(4, 2)
