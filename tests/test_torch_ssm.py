"""The port's Mamba2 (SSD) block (`models/ssm.py`) against the JAX
package's, on the CPU.

One reference parameter tree (the JAX `ssm_init`) is copied into the
port's module: zamba2-2.7b `reduced()` (d 128, state 16, 16 heads of 16,
chunk 32) and the reference's own `tests/test_layers.py` block (d 32,
chunk 16).  Float32 compute: outputs rtol 1e-4 / atol 1e-5, every
gradient leaf rtol 1e-3 / atol 1e-5, decode caches rtol 1e-4 / atol
1e-5; bfloat16 decode rtol 2e-2 / atol 2e-2 * max|ref|.

The reference agrees with itself where B = 1 or T <= ssm_chunk, and
there the port is held to it directly.  With B > 1 and several chunks
the reference's forward mixes batch rows (`src/repro/models/ssm.py:102`
reshapes the decays without the transpose every other input gets): the
port is held to the reference run one row at a time and to the
reference's decode recurrence, and one test pins the reference's
batched difference (ROADMAP.md queue 3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget
from repro.models.common import ModelConfig as JConfig
from repro.models.ssm import ssm_cache_init as jcache_init
from repro.models.ssm import ssm_decode_step as jdecode
from repro.models.ssm import ssm_forward as jforward
from repro.models.ssm import ssm_init as jinit
from repro_torch.configs import get_config
from repro_torch.models.common import ModelConfig
from repro_torch.models.ssm import (SSMCache, ssm_cache_init,
                                    ssm_decode_step, ssm_forward, ssm_init)
from repro_torch.tree import tree_paths

torch.set_num_threads(2)

F32 = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=1e-5)
# the reference's block of tests/test_layers.py::_ssm_cfg
LAYER_CFG = dict(name="t", family="hybrid", n_layers=1, d_model=32,
                 n_heads=4, n_kv=4, d_ff=64, vocab=64, ssm_state=8,
                 ssm_head_dim=8, ssm_expand=2, ssm_chunk=16,
                 compute_dtype="float32")


def _cfgs(**over):
    return (jget("zamba2-2.7b").reduced(**over),
            get_config("zamba2-2.7b").reduced(**over))


def _into(module, tree):
    with torch.no_grad():
        for path, leaf in tree_paths(tree):
            module.get_parameter(".".join(path)).copy_(
                torch.from_numpy(np.array(leaf)))
    return module


def _pair(jc, tc, seed=0):
    jp = jinit(jax.random.PRNGKey(seed), jc)
    # nonzero decay rates and skips: the init's zeros and ones test less
    rng = np.random.default_rng(seed + 100)
    h = jp["a_log"].shape[0]
    jp = dict(jp, a_log=jnp.asarray(rng.normal(size=h) * 0.5, jnp.float32),
              d_skip=jnp.asarray(rng.normal(size=h), jnp.float32))
    tp = _into(ssm_init(None, tc, device="cpu"),
               jax.tree_util.tree_map(np.asarray, jp))
    return jp, tp


def _x(tc, b, t, seed=1, scale=0.5):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, t, tc.d_model)) * scale).astype(np.float32)


def _port(tp, x, tc):
    with torch.no_grad():
        return ssm_forward(tp, torch.from_numpy(x), tc).numpy()


@pytest.mark.parametrize("b,t", [(1, 128), (2, 32)],
                         ids=["b1_four_chunks", "b2_one_chunk"])
def test_ssm_forward_and_grads_match_reference(b, t):
    jc, tc = _cfgs(compute_dtype="float32")
    jp, tp = _pair(jc, tc)
    x = _x(tc, b, t)
    w = np.random.default_rng(2).normal(size=x.shape).astype(np.float32)
    fn = jax.jit(jax.value_and_grad(
        lambda p, x: jnp.sum(jforward(p, x, jc) * w), argnums=(0, 1)))
    jl, (jgp, jgx) = fn(jp, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = ssm_forward(tp, xt, tc)
    np.testing.assert_allclose(y.detach().numpy(),
                               np.asarray(jforward(jp, jnp.asarray(x), jc)),
                               **F32)
    tl = torch.sum(y * torch.from_numpy(w))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), **F32)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), **GRAD)
    jg = dict(tree_paths(jax.tree_util.tree_map(np.asarray, jgp)))
    for name, p in tp.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   jg[tuple(name.split("."))], **GRAD,
                                   err_msg=name)


def test_batched_chunks_follow_each_sequence():
    """B = 2 over three chunks: the port's batched forward against the
    reference run row by row, and against the reference's decode."""
    jc, tc = _cfgs(compute_dtype="float32")
    jp, tp = _pair(jc, tc, seed=3)
    x = _x(tc, 2, 96, seed=4)
    x[1] *= 3.0
    got = _port(tp, x, tc)
    rows = np.concatenate([np.asarray(jforward(jp, jnp.asarray(x[i:i + 1]),
                                               jc)) for i in range(2)])
    np.testing.assert_allclose(got, rows, **F32)
    step = jax.jit(lambda p, x, c: jdecode(p, x, c, jc))
    cache, outs = jcache_init(jc, 2), []
    for i in range(x.shape[1]):
        y, cache = step(jp, jnp.asarray(x[:, i:i + 1]), cache)
        outs.append(np.asarray(y))
    np.testing.assert_allclose(got, np.concatenate(outs, axis=1),
                               rtol=1e-3, atol=1e-4)


def test_reference_batched_forward_mixes_rows():
    """Pins the reference's fault on its own test block (B = 2, T = 64,
    chunk 16, row 1 scaled by 4): its batched row 1 differs from the
    same row run alone by more than 0.1 (about 0.35 against a scale of
    4); the port's batched row 1 equals that row alone."""
    jc, tc = JConfig(**LAYER_CFG), ModelConfig(**LAYER_CFG)
    jp = jinit(jax.random.PRNGKey(0), jc)
    tp = _into(ssm_init(None, tc, device="cpu"),
               jax.tree_util.tree_map(np.asarray, jp))
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (2, 64, 32))
                 * 0.5)
    x[1] *= 4.0
    batched = np.asarray(jforward(jp, jnp.asarray(x), jc))
    alone = np.asarray(jforward(jp, jnp.asarray(x[1:]), jc))[0]
    assert np.abs(batched[1] - alone).max() > 0.1
    got = _port(tp, x, tc)
    np.testing.assert_allclose(got[1], alone, **F32)
    np.testing.assert_allclose(got[0], np.asarray(
        jforward(jp, jnp.asarray(x[:1]), jc))[0], **F32)
    # one chunk (nc = 1): the reference agrees with itself and the port
    one = dataclasses.replace(jc, ssm_chunk=64)
    np.testing.assert_allclose(
        _port(tp, x, dataclasses.replace(tc, ssm_chunk=64)),
        np.asarray(jforward(jp, jnp.asarray(x), one)), **F32)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_decode_steps_and_caches_match_reference(cd):
    jc, tc = _cfgs(compute_dtype=cd)
    jp, tp = _pair(jc, tc, seed=5)
    x = _x(tc, 2, 12, seed=6)
    jcache = jcache_init(jc, 2)
    tcache = ssm_cache_init(tc, 2, device="cpu")
    assert isinstance(tcache, SSMCache)
    assert [tuple(c.shape) for c in tcache] == [c.shape for c in jcache]
    step = jax.jit(lambda p, x, c: jdecode(p, x, c, jc))
    for i in range(x.shape[1]):
        xi = x[:, i:i + 1]
        jy, jcache = step(jp, jnp.asarray(xi, jc.cdtype), jcache)
        with torch.inference_mode():
            ty, out = ssm_decode_step(
                tp, torch.from_numpy(xi).to(tc.cdtype), tcache, tc)
        assert out is tcache and tcache.state.dtype == torch.float32
        ref = np.asarray(jy, np.float32)
        tol = F32 if cd == "float32" else dict(
            rtol=2e-2, atol=2e-2 * np.abs(ref).max())
        np.testing.assert_allclose(ty.float().numpy(), ref, **tol)
        for a, b in zip(tcache, jcache):
            b = np.asarray(b, np.float32)
            tol = F32 if cd == "float32" else dict(
                rtol=2e-2, atol=2e-2 * np.abs(b).max())
            np.testing.assert_allclose(a.numpy(), b, **tol)


def test_chunk_size_invariance():
    jc, tc = _cfgs(compute_dtype="float32")
    _, tp = _pair(jc, tc, seed=7)
    x = _x(tc, 1, 64, seed=8)
    a = _port(tp, x, dataclasses.replace(tc, ssm_chunk=16))
    b = _port(tp, x, dataclasses.replace(tc, ssm_chunk=64))
    np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4)


def test_masked_half_overflow_keeps_the_gradients_finite():
    """A chunk whose decays sum past ~88 (dt_bias 2, chunk 64): the
    reference's exp over the masked half overflows and every gradient it
    returns is NaN; the port masks first, so its forward equals the
    reference's and its gradients are finite and equal the reference's
    at chunk 16, where nothing overflows (ROADMAP.md queue 3)."""
    jc, tc = _cfgs(compute_dtype="float32", ssm_chunk=64)
    jp, tp = _pair(jc, tc, seed=9)
    h = jp["dt_bias"].shape[0]
    jp = dict(jp, a_log=jnp.zeros((h,), jnp.float32),
              dt_bias=jnp.full((h,), 2.0, jnp.float32))
    tp = _into(tp, {"a_log": np.zeros(h, np.float32),
                    "dt_bias": np.full(h, 2.0, np.float32)})
    x = _x(tc, 1, 64, seed=10)
    w = np.random.default_rng(11).normal(size=x.shape).astype(np.float32)

    def jgrad(cfg):
        return jax.grad(lambda p: jnp.sum(jforward(p, jnp.asarray(x), cfg)
                                          * w))(jp)

    assert not all(np.isfinite(np.asarray(a)).all()
                   for a in jax.tree_util.tree_leaves(jgrad(jc)))
    y = ssm_forward(tp, torch.from_numpy(x), tc)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(
        jforward(jp, jnp.asarray(x), jc)), **F32)
    torch.sum(y * torch.from_numpy(w)).backward()
    small = dict(tree_paths(jax.tree_util.tree_map(
        np.asarray, jgrad(dataclasses.replace(jc, ssm_chunk=16)))))
    for name, p in tp.named_parameters():
        assert torch.isfinite(p.grad).all(), name
        np.testing.assert_allclose(p.grad.numpy(),
                                   small[tuple(name.split("."))],
                                   rtol=1e-3, atol=1e-4, err_msg=name)
