"""The port's xLSTM blocks (`models/xlstm.py`: the chunkwise mLSTM and
the sequential sLSTM) against the JAX package's, on the CPU.

One reference parameter tree (the JAX `mlstm_init` / `slstm_init`) is
copied into the port's module: xlstm-350m `reduced()` (d 128, 4 heads,
mLSTM inner width 256, chunk 32), B = 2 over three chunks (the
reference's chunk-major transposes are right for B > 1 here).  Float32
compute: outputs rtol 1e-4 / atol 1e-5, every gradient leaf rtol 1e-3 /
atol 1e-5, decode outputs and caches rtol 1e-4 / atol 1e-5 (bfloat16:
rtol 2e-2 / atol 2e-2 * max|ref|).  Chunk-size invariance as the
reference's own test holds it: rtol 2e-3 / atol 2e-3.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget
from repro.models import xlstm as jx
from repro_torch.configs import get_config
from repro_torch.models import xlstm as tx
from repro_torch.tree import tree_paths

torch.set_num_threads(2)

F32 = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=1e-5)
KINDS = {"mlstm": (jx.mlstm_init, jx.mlstm_forward, jx.mlstm_cache_init,
                   jx.mlstm_decode_step, tx.mlstm_init, tx.mlstm_forward,
                   tx.mlstm_cache_init, tx.mlstm_decode_step),
         "slstm": (jx.slstm_init, jx.slstm_forward, jx.slstm_cache_init,
                   jx.slstm_decode_step, tx.slstm_init, tx.slstm_forward,
                   tx.slstm_cache_init, tx.slstm_decode_step)}


def _cfgs(**over):
    return (jget("xlstm-350m").reduced(**over),
            get_config("xlstm-350m").reduced(**over))


def _into(module, tree):
    with torch.no_grad():
        for path, leaf in tree_paths(tree):
            module.get_parameter(".".join(path)).copy_(
                torch.from_numpy(np.array(leaf)))
    return module


def _pair(kind, jc, tc, seed=0):
    jinit, tinit = KINDS[kind][0], KINDS[kind][4]
    jp = jinit(jax.random.PRNGKey(seed), jc)
    if kind == "mlstm":  # a nonzero gate bias: the init's zeros test less
        b = np.random.default_rng(seed).normal(size=jp["wif"]["b"].shape)
        jp = dict(jp, wif=dict(jp["wif"], b=jnp.asarray(b, jnp.float32)))
    tp = _into(tinit(None, tc, device="cpu"),
               jax.tree_util.tree_map(np.asarray, jp))
    return jp, tp


def _x(tc, b, t, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, t, tc.d_model)) * 0.5).astype(np.float32)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_forward_and_grads_match_reference(kind):
    jc, tc = _cfgs(compute_dtype="float32")
    jp, tp = _pair(kind, jc, tc)
    jfwd, tfwd = KINDS[kind][1], KINDS[kind][5]
    x = _x(tc, 2, 96)
    w = np.random.default_rng(2).normal(size=x.shape).astype(np.float32)
    jy = np.asarray(jfwd(jp, jnp.asarray(x), jc))
    jl, (jgp, jgx) = jax.jit(jax.value_and_grad(
        lambda p, x: jnp.sum(jfwd(p, x, jc) * w), argnums=(0, 1)))(
            jp, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tfwd(tp, xt, tc)
    np.testing.assert_allclose(y.detach().numpy(), jy, **F32)
    tl = torch.sum(y * torch.from_numpy(w))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), **F32)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), **GRAD)
    jg = dict(tree_paths(jax.tree_util.tree_map(np.asarray, jgp)))
    for name, p in tp.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   jg[tuple(name.split("."))], **GRAD,
                                   err_msg=name)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_decode_steps_and_caches_match_reference(kind, cd):
    jc, tc = _cfgs(compute_dtype=cd)
    jp, tp = _pair(kind, jc, tc, seed=3)
    jcache_init, jstep_fn = KINDS[kind][2:4]
    tcache_init, tstep = KINDS[kind][6:8]
    x = _x(tc, 2, 10, seed=4)
    jcache = jcache_init(jc, 2)
    tcache = tcache_init(tc, 2, device="cpu")
    assert tcache._fields == jcache._fields
    for a, b in zip(tcache, jcache):  # the reference's fills
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    step = jax.jit(lambda p, x, c: jstep_fn(p, x, c, jc))
    for i in range(x.shape[1]):
        xi = x[:, i:i + 1]
        jy, jcache = step(jp, jnp.asarray(xi, jc.cdtype), jcache)
        with torch.inference_mode():
            ty, out = tstep(tp, torch.from_numpy(xi).to(tc.cdtype), tcache,
                            tc)
        assert out is tcache
        for a, b in [(ty.float(), jy)] + list(zip(tcache, jcache)):
            b = np.asarray(b, np.float32)
            tol = F32 if cd == "float32" else dict(
                rtol=2e-2, atol=2e-2 * np.abs(b).max())
            np.testing.assert_allclose(a.float().numpy(), b, **tol)
    assert all(c.dtype == torch.float32 for c in tcache)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_decode_follows_the_forward(kind):
    """The port's decode steps against its own forward, as the
    reference's `test_mlstm_chunked_vs_decode_recurrence`."""
    jc, tc = _cfgs(compute_dtype="float32")
    _, tp = _pair(kind, jc, tc, seed=5)
    tfwd, tcache_init, tstep = (KINDS[kind][i] for i in (5, 6, 7))
    x = torch.from_numpy(_x(tc, 2, 64, seed=6))
    with torch.inference_mode():
        full = tfwd(tp, x, tc)
        cache, outs = tcache_init(tc, 2, device="cpu"), []
        for i in range(x.shape[1]):
            y, cache = tstep(tp, x[:, i:i + 1], cache, tc)
            outs.append(y)
    np.testing.assert_allclose(torch.cat(outs, dim=1).numpy(),
                               full.numpy(), rtol=2e-3, atol=2e-3)


def test_mlstm_chunk_size_invariance():
    jc, tc = _cfgs(compute_dtype="float32")
    _, tp = _pair("mlstm", jc, tc, seed=7)
    x = torch.from_numpy(_x(tc, 1, 64, seed=8))
    with torch.no_grad():
        a = tx.mlstm_forward(tp, x, dataclasses.replace(tc, ssm_chunk=16))
        b = tx.mlstm_forward(tp, x, dataclasses.replace(tc, ssm_chunk=64))
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3, atol=2e-3)


def test_mlstm_masked_half_overflow_keeps_the_gradients_finite():
    """Forget gates at -4 (log-forget ~ -4 per step) over a 64-step
    chunk: the reference's exp over the masked half of the scores
    overflows and its gradients turn NaN; the port masks first, so its
    forward equals the reference's and its gradients are finite and
    equal the reference's at chunk 8, where nothing overflows (ROADMAP.md
    queue 3)."""
    jc, tc = _cfgs(compute_dtype="float32", ssm_chunk=64)
    jp, tp = _pair("mlstm", jc, tc, seed=9)
    h = tc.n_heads
    bias = np.concatenate([np.zeros(h), np.full(h, -4.0)]).astype(
        np.float32)
    jp = dict(jp, wif=dict(jp["wif"], b=jnp.asarray(bias)))
    tp = _into(tp, {"wif": {"b": bias}})
    x = _x(tc, 1, 64, seed=10)
    w = np.random.default_rng(11).normal(size=x.shape).astype(np.float32)

    def jgrad(cfg):
        return jax.grad(lambda p: jnp.sum(
            jx.mlstm_forward(p, jnp.asarray(x), cfg) * w))(jp)

    assert not all(np.isfinite(np.asarray(a)).all()
                   for a in jax.tree_util.tree_leaves(jgrad(jc)))
    y = tx.mlstm_forward(tp, torch.from_numpy(x), tc)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(
        jx.mlstm_forward(jp, jnp.asarray(x), jc)), **F32)
    torch.sum(y * torch.from_numpy(w)).backward()
    small = dict(tree_paths(jax.tree_util.tree_map(
        np.asarray, jgrad(dataclasses.replace(jc, ssm_chunk=8)))))
    for name, p in tp.named_parameters():
        assert torch.isfinite(p.grad).all(), name
        np.testing.assert_allclose(p.grad.numpy(),
                                   small[tuple(name.split("."))],
                                   rtol=2e-3, atol=2e-3, err_msg=name)
