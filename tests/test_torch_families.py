"""The port's other decoder families (MoE, the Mamba2 hybrid with its
shared block, xLSTM) as whole models against the JAX package's, on the
CPU.

One reference parameter tree (`init_lm_params`, as numpy) is carried
into the port with `lm_params_from_numpy`; caches cross with
`lm_cache_{from,to}_numpy`.  All configs are `reduced()`: mixtral-8x7b
(4 experts, top-2, window 64), dbrx-132b with 8 experts and top-4,
zamba2-2.7b (two SSM layers and the shared block, chunk 32: B = 2 x T =
32 is one chunk, B = 1 x T = 128 four) and xlstm-350m (an mLSTM and an
sLSTM block).  Before the MoE losses are compared, every MoE layer's
routes (`choice`, `keep`) are recomputed by the reference's routing on
the port's layer input and must be equal.  Float32 compute: loss rtol
1e-4 / atol 1e-5, every gradient leaf rtol 1e-3 / atol 1e-5; 12 greedy
decode steps: logits and caches rtol 1e-4 / atol 1e-5, tokens equal;
decode against the port's own forward: rtol 5e-2 / atol 5e-2, argmax
equal.  Serving and training these families through the launchers:
`tests/test_torch_families_launch.py`.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget
from repro.models import init_cache as jinit_cache
from repro.models import init_lm_params as jinit
from repro.models import lm_decode_step as jdecode
from repro.models import lm_loss as jloss
from repro_torch.configs import get_config
from repro_torch.models import (block_layout, init_cache, init_lm_params,
                                lm_cache_from_numpy, lm_cache_to_numpy,
                                lm_decode_step, lm_forward, lm_loss,
                                lm_params_from_numpy, lm_params_to_numpy)
from repro_torch.models import moe as moe_mod

torch.set_num_threads(2)

F32 = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=1e-5)
ARCHS = {"mixtral": ("mixtral-8x7b", {}),
         "dbrx": ("dbrx-132b", dict(n_experts=8, top_k=4)),
         "zamba2": ("zamba2-2.7b", {}),
         "xlstm": ("xlstm-350m", {})}


def _pair(arch, seed=0, **over):
    name, base = ARCHS[arch]
    over = dict(base, **over)
    jc, tc = jget(name).reduced(**over), get_config(name).reduced(**over)
    jp = jinit(jax.random.PRNGKey(seed), jc)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jc, tc, jp, lm_params_from_numpy(tree, tc, device="cpu")


def _tokens(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, size=(b, s + 1)).astype(np.int32)


def _grads_tree(model):
    twin = copy.deepcopy(model)
    with torch.no_grad():
        for g, p in zip(twin.parameters(), model.parameters()):
            g.copy_(p.grad)
    return lm_params_to_numpy(twin)


def _jroute(p, xf, jc):
    """The reference's routing (`src/repro/models/moe.py:67-89`) of one
    token block: choice, and keep in its sorted order."""
    t = xf.shape[0]
    e, k = jc.n_experts, jc.top_k
    cap = max(8, min(int(t * k * jc.capacity_factor / e + 0.999), t))
    logits = jnp.asarray(xf, jnp.float32) @ jnp.asarray(p["router"]["w"])
    _, choice = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    se = jnp.sort(choice.reshape(-1), stable=True)
    counts = jnp.bincount(se, length=e)
    pos = jnp.arange(t * k) - (jnp.cumsum(counts) - counts)[se]
    return np.asarray(choice), np.asarray(pos < cap)


def _recording_route(log):
    real = moe_mod._route

    def route(xf, w, cfg):
        r = real(xf, w, cfg)
        log.append((xf.detach().float().numpy(), r))
        return r

    return route


@pytest.mark.parametrize("arch,b,s", [
    ("mixtral", 2, 64), ("dbrx", 2, 32), ("zamba2", 2, 32),
    ("zamba2", 1, 128), ("xlstm", 2, 64)],
    ids=["mixtral", "dbrx", "zamba2-b2-one-chunk", "zamba2-b1-four-chunks",
         "xlstm"])
def test_loss_and_grads_match_reference(arch, b, s, monkeypatch):
    jc, tc, jp, model = _pair(arch, compute_dtype="float32")
    toks = _tokens(tc, b, s, seed=1)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, t: jloss(p, {"tokens": t}, jc), has_aux=True))(
            jp, jnp.asarray(toks))
    log = []
    monkeypatch.setattr(moe_mod, "_route", _recording_route(log))
    tl, tm = lm_loss(model, {"tokens": torch.from_numpy(toks)}, tc)
    if tc.family == "moe":
        assert len(log) == tc.n_layers
        for layer, (xf, r) in enumerate(log):
            choice, keep = _jroute(
                jax.tree_util.tree_map(lambda a: a[layer],
                                       jp["blocks_0"]["moe"]), xf, jc)
            np.testing.assert_array_equal(r.choice.numpy(), choice)
            np.testing.assert_array_equal(r.keep.numpy(), keep)
        assert float(tm["aux"].detach()) > 0  # the aux loss is live
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), **F32)
    for k in ("ce", "aux", "ppl_proxy"):
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]),
                                   **F32, err_msg=k)
    got = _grads_tree(model)
    want = jax.tree_util.tree_map(np.asarray, jg)
    assert jax.tree_util.tree_structure(got) \
        == jax.tree_util.tree_structure(want)
    for (path, a), b_ in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                             jax.tree_util.tree_leaves(got)):
        np.testing.assert_allclose(b_, a, **GRAD,
                                   err_msg=jax.tree_util.keystr(path))


def _np_cache(tree):
    return {k: type(c)(*(np.asarray(a, np.float32) for a in c))
            for k, c in tree.items()}


@pytest.mark.parametrize("arch", ["mixtral", "zamba2", "xlstm"])
def test_greedy_decode_steps_match_reference(arch):
    jc, tc, jp, model = _pair(arch, compute_dtype="float32")
    b, n = 2, 12
    jcache = jinit_cache(jc, b, 16, dtype=jnp.float32)
    tcache = init_cache(tc, b, 16, dtype=torch.float32, device="cpu")
    assert all(a.dtype == torch.float32 for c in tcache for a in c)
    step = jax.jit(lambda p, t, pos, c: jdecode(p, t, pos, c, jc))
    jt = tt = _tokens(tc, b, 0, seed=2)[:, 0]
    with torch.inference_mode():
        for i in range(n):
            jlog, jcache = step(jp, jnp.asarray(jt), jnp.int32(i), jcache)
            tlog, tcache = lm_decode_step(
                model, torch.from_numpy(np.asarray(tt)).long(), i, tcache,
                tc)
            np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                       **F32)
            jt, tt = np.asarray(jlog.argmax(-1)), tlog.argmax(-1).numpy()
            np.testing.assert_array_equal(tt, jt)
    got, want = lm_cache_to_numpy(tcache, tc), _np_cache(jcache)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key]._fields == want[key]._fields
        for a, b_ in zip(got[key], want[key]):
            assert a.shape == b_.shape, key
            np.testing.assert_allclose(a, b_, **F32, err_msg=key)
    # ... and the port continues from the reference's caches
    back = lm_cache_from_numpy(jax.tree_util.tree_map(np.asarray, jcache),
                               tc, device="cpu")
    with torch.inference_mode():
        tlog, _ = lm_decode_step(model, torch.tensor(jt).long(), n, back,
                                 tc)
    jlog, _ = step(jp, jnp.asarray(jt), jnp.int32(n), jcache)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **F32)


@pytest.mark.parametrize("arch,over", [
    ("mixtral", dict(capacity_factor=2.0)), ("zamba2", {}), ("xlstm", {})],
    ids=["mixtral", "zamba2", "xlstm"])
def test_decode_follows_the_forward(arch, over):
    """Decoding token by token == the port's forward on the prefix (bf16
    compute, f32 caches); MoE with capacity_factor = E / top_k, so the
    forward drops nothing either."""
    name, base = ARCHS[arch]
    tc = get_config(name).reduced(**base, **over)
    model = init_lm_params(0, tc, device="cpu")
    toks = torch.from_numpy(_tokens(tc, 1, 32, seed=3)[:, :32]).long()
    with torch.inference_mode():
        full, _ = lm_forward(model, toks, tc)
        caches = init_cache(tc, 1, 32, dtype=torch.float32, device="cpu")
        outs = []
        for t in range(32):
            lg, caches = lm_decode_step(model, toks[:, t], t, caches, tc)
            outs.append(lg)
    dec = torch.stack(outs, dim=1)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), rtol=5e-2,
                               atol=5e-2)
    np.testing.assert_array_equal(dec.argmax(-1).numpy(),
                                  full.argmax(-1).numpy())


def test_shared_block_is_stored_once():
    """zamba2: one shared weight set (`LM.shared`), used by every group;
    its gradient sums over every invocation; the "shared" entries of
    `blocks` hold no parameters."""
    tc = get_config("zamba2-2.7b").reduced(compute_dtype="float32",
                                          n_layers=4)
    grp, n_groups = block_layout(tc)
    assert [bd.kind for bd in grp] == ["ssm", "ssm", "shared"]
    assert n_groups == 2
    model = init_lm_params(1, tc, device="cpu")
    names = [n for n, _ in model.named_parameters()]
    assert sum(n.startswith("shared.") for n in names) == len(
        list(model.shared.parameters()))
    assert not any(n.startswith(("blocks.2.", "blocks.5.")) for n in names)
    toks = torch.from_numpy(_tokens(tc, 1, 32, seed=4))
    loss, _ = lm_loss(model, {"tokens": toks}, tc)
    loss.backward()
    tree = lm_params_to_numpy(model)
    assert sorted(k for k in tree if k.startswith("blocks_")) == [
        "blocks_0", "blocks_1"]
    assert tree["shared"]["win"]["w"].shape == (2 * tc.d_model, tc.d_model)
    assert model.shared.win.w.grad.abs().sum() > 0


def test_moe_aux_counts_once_per_moe_block():
    """lm_loss = ce + 0.01 * sum over MoE blocks of load_balance + 1e-3
    * router_z."""
    tc = get_config("mixtral-8x7b").reduced(compute_dtype="float32")
    model = init_lm_params(2, tc, device="cpu")
    log = []
    real = moe_mod._moe_tokens

    def spy(p, xf, cfg):
        y, aux = real(p, xf, cfg)
        log.append(aux)
        return y, aux

    toks = torch.from_numpy(_tokens(tc, 2, 16, seed=6))
    with torch.no_grad():
        moe_mod._moe_tokens = spy
        try:
            loss, m = lm_loss(model, {"tokens": toks}, tc)
        finally:
            moe_mod._moe_tokens = real
    want = sum(float(a["load_balance"]) + 1e-3 * float(a["router_z"])
               for a in log)
    assert len(log) == tc.n_layers
    np.testing.assert_allclose(float(m["aux"]), want, rtol=1e-6)
    np.testing.assert_allclose(float(loss), float(m["ce"]) + 0.01 * want,
                               rtol=1e-6)


def test_remat_keeps_the_numerics_of_the_new_families():
    for name in ("zamba2-2.7b", "xlstm-350m", "mixtral-8x7b"):
        cfg = get_config(name).reduced(compute_dtype="float32")
        toks = torch.from_numpy(_tokens(cfg, 1, 32, seed=7))
        model = init_lm_params(3, cfg, device="cpu")
        twin = copy.deepcopy(model)
        loss, _ = lm_loss(model, {"tokens": toks}, cfg)
        loss.backward()
        rloss, _ = lm_loss(twin, {"tokens": toks},
                           dataclasses.replace(cfg, remat=True))
        rloss.backward()
        assert torch.equal(loss, rloss), name
        for a, b in zip(model.parameters(), twin.parameters()):
            assert torch.equal(a.grad, b.grad), name


def test_remat_dots_names_the_queue():
    """remat_policy "dots" (once without a counterpart, waiting for its
    queue item) computes: the loss and every gradient bit-equal to
    "nothing" (`tests/test_torch_remat.py` holds it against the
    reference's "dots")."""
    cfg = get_config("zamba2-2.7b").reduced(remat=True, remat_policy="dots")
    model = init_lm_params(0, cfg, device="cpu")
    twin = copy.deepcopy(model)
    toks = torch.from_numpy(_tokens(cfg, 1, 32, seed=8))
    loss, _ = lm_loss(model, {"tokens": toks}, cfg)
    loss.backward()
    nloss, _ = lm_loss(twin, {"tokens": toks},
                       dataclasses.replace(cfg, remat_policy="nothing"))
    nloss.backward()
    assert torch.isfinite(loss) and torch.equal(loss, nloss)
    for a, b in zip(model.parameters(), twin.parameters()):
        assert torch.equal(a.grad, b.grad)
