"""The port's dense LM against the JAX package's, on the CPU.

One reference parameter tree (`init_lm_params` of the JAX package, as
numpy) is carried into the port with `lm_params_from_numpy`; both sides
then see the same numpy token batches.  llama3.2-1b `reduced()` at seq
128 chunks its attention (q_chunk 32, kv_chunk 64) so that chunks are
skipped and checkpointed.  Float32 compute: loss rtol 1e-4 / atol 1e-5,
every gradient leaf rtol 1e-3 / atol 1e-5; bfloat16 compute: rtol 2e-2.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.configs.registry import get_config as jget
from repro.models import init_encdec_params as jinit_encdec
from repro.models import init_lm_params as jinit
from repro.models import lm_loss as jloss
from repro.models.attention import flash_attention as jflash
from repro.models.layers import rope as jrope
from repro.models.layers import unembed as junembed
from repro.models.common import param_count as jparam_count
from repro_torch.configs import get_config, registry
from repro_torch.models import (block_layout, encdec_params_to_numpy,
                                init_encdec_params, init_lm_params,
                                lm_params_from_numpy, lm_params_to_numpy,
                                lm_loss, param_count)
from repro_torch.models.attention import flash_attention
from repro_torch.models.layers import rope, unembed

torch.set_num_threads(2)


def _tokens(cfg, b=2, s=128, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, size=(b, s + 1)).astype(np.int32)


def _pair(arch, **over):
    jc, tc = jget(arch).reduced(**over), get_config(arch).reduced(**over)
    jp = jinit(jax.random.PRNGKey(0), jc)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jc, tc, jp, lm_params_from_numpy(tree, tc, device="cpu")


def _grads_tree(model):
    """The port's gradients in the reference's tree layout."""
    twin = copy.deepcopy(model)
    with torch.no_grad():
        for g, p in zip(twin.parameters(), model.parameters()):
            g.copy_(p.grad)
    return lm_params_to_numpy(twin)


def _loss_and_grads(arch, toks, **over):
    jc, tc, jp, model = _pair(arch, **over)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jloss(p, b, jc), has_aux=True))(
            jp, {"tokens": jnp.asarray(toks)})
    tl, tm = lm_loss(model, {"tokens": torch.from_numpy(toks)}, tc)
    tl.backward()
    return (float(jl), jax.tree_util.tree_map(np.asarray, jg), jm,
            float(tl.detach()), _grads_tree(model), tm)


def _check_grads(jg, tg, rtol, atol):
    jl, tl = (jax.tree_util.tree_flatten_with_path(t)[0] for t in (jg, tg))
    assert len(jl) == len(tl)
    tmap = {jax.tree_util.keystr(p): v for p, v in tl}
    for path, a in jl:
        b = tmap[jax.tree_util.keystr(path)]
        np.testing.assert_allclose(b, a, rtol=rtol, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


def test_loss_and_grads_f32_match_reference():
    cfg = get_config("llama3.2-1b").reduced()
    toks = _tokens(cfg)
    jl, jg, jm, tl, tg, tm = _loss_and_grads("llama3.2-1b", toks,
                                             compute_dtype="float32")
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-5)
    for k in ("ce", "aux", "ppl_proxy"):
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]),
                                   rtol=1e-4, atol=1e-5)
    _check_grads(jg, tg, rtol=1e-3, atol=1e-5)


def test_loss_and_grads_bf16_match_reference():
    cfg = get_config("llama3.2-1b").reduced()
    toks = _tokens(cfg, seed=1)
    jl, jg, _, tl, tg, _ = _loss_and_grads("llama3.2-1b", toks)
    np.testing.assert_allclose(tl, jl, rtol=2e-2)
    # bf16 activations: elementwise gradients hold 2e-2 relative to the
    # leaf's scale
    for a, b in zip(jax.tree_util.tree_leaves(jg),
                    jax.tree_util.tree_leaves(tg)):
        np.testing.assert_allclose(b, a, rtol=2e-2,
                                   atol=2e-2 * float(np.abs(a).max()))


def test_chunked_ce_branch_matches_reference():
    cfg = get_config("llama3.2-1b").reduced()
    toks = _tokens(cfg, seed=2)
    jl, jg, _, tl, tg, _ = _loss_and_grads(
        "llama3.2-1b", toks, compute_dtype="float32", ce_chunk=32)
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-5)
    _check_grads(jg, tg, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen2-7b", "starcoder2-3b"])
def test_dense_variants_forward_loss(arch):
    jc, tc, jp, model = _pair(arch, compute_dtype="float32")
    toks = _tokens(tc, seed=3)
    jl, _ = jax.jit(lambda p, b: jloss(p, b, jc))(
        jp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tl, _ = lm_loss(model, {"tokens": torch.from_numpy(toks)}, tc)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("window,cap", [(None, None), (48, None),
                                        (None, 50.0), (40, 30.0)])
def test_flash_attention_matches_reference(window, cap):
    rng = np.random.default_rng(4)
    b, s, kvh, g, d = 2, 128, 2, 2, 16
    q = rng.normal(size=(b, s, kvh, g, d)).astype(np.float32)
    k = rng.normal(size=(b, s, kvh, d)).astype(np.float32)
    v = rng.normal(size=(b, s, kvh, d)).astype(np.float32)
    kw = dict(causal=True, window=window, cap=cap, q_chunk=32, kv_chunk=64)
    ref = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            **kw))
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), **kw).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_flash_attention_bf16_matches_reference():
    rng = np.random.default_rng(5)
    b, s, kvh, g, d = 1, 64, 1, 4, 32
    arrs = [rng.normal(size=sh).astype(np.float32)
            for sh in ((b, s, kvh, g, d), (b, s, kvh, d), (b, s, kvh, d))]
    kw = dict(window=24, q_chunk=16, kv_chunk=32)
    ref = jflash(*(jnp.asarray(a, jnp.bfloat16) for a in arrs), **kw)
    out = flash_attention(*(torch.from_numpy(a).bfloat16() for a in arrs),
                          **kw)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)


def test_unembed_masks_padded_rows():
    rng = np.random.default_rng(6)
    table = rng.normal(size=(256, 16)).astype(np.float32)  # 200 live rows
    x = rng.normal(size=(3, 5, 16)).astype(np.float32)
    ref = np.asarray(junembed({"table": jnp.asarray(table)},
                              jnp.asarray(x), 200))
    out = unembed({"table": torch.from_numpy(table)}, torch.from_numpy(x),
                  200).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    assert (out[..., 200:] == -1e30).all()


def test_rope_half_split_matches_reference():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 9, 4, 32)).astype(np.float32)
    pos = np.arange(9)[None]
    ref = np.asarray(jrope(jnp.asarray(x), jnp.asarray(pos), 500000.0))
    out = rope(torch.from_numpy(x), torch.from_numpy(pos), 500000.0)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_configs_are_the_reference_numbers():
    assert registry.ARCHS == jregistry.ARCHS
    assert registry.ALIASES == jregistry.ALIASES
    assert [(a, tuple(sp), skip) for a, sp, skip in registry.all_cells()] \
        == [(a, tuple(sp), skip) for a, sp, skip in jregistry.all_cells()]
    for name in list(registry.ARCHS) + list(registry.ALIASES):
        assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(
            jget(name))
        assert [tuple(sp) for sp in registry.shape_specs(name)] == [
            tuple(sp) for sp in jregistry.shape_specs(name)]
    assert get_config("llama3.2-1b").cdtype == torch.bfloat16
    assert get_config("llama3.2-1b").reduced(
        compute_dtype="float32").cdtype == torch.float32
    with pytest.raises(KeyError):
        get_config("gpt-5")


def test_layout_param_count_and_round_trip():
    for arch in ("llama3.2-1b", "gemma2-2b", "starcoder2-3b"):
        full = get_config(arch)
        assert param_count(full) == jparam_count(jget(arch))
    assert param_count(get_config("llama3.2-1b")) == 1_235_812_352
    cfg = get_config("gemma2-2b").reduced()
    grp, n_groups = block_layout(cfg)
    assert [b.window for b in grp] == [64, None] and n_groups == 1
    model = init_lm_params(0, cfg, device="cpu")
    again = init_lm_params(0, cfg, device="cpu")
    tree = lm_params_to_numpy(model)
    for a, b in zip(model.parameters(), again.parameters()):
        assert torch.equal(a, b)  # the seed fixes the weights
    back = lm_params_to_numpy(lm_params_from_numpy(tree, cfg, device="cpu"))
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "xlstm-350m",
                                  "zamba2-2.7b", "seamless-m4t-medium"])
def test_other_families_not_ported(arch):
    """Each of the other families builds (the name is from when they
    raised), and its parameter tree has the reference's leaf names,
    shapes and dtypes: stacked MoE and recurrent leaves, zamba2's
    shared block once, the encoder-decoder's (L, ...) stacks."""
    jc, tc = jget(arch).reduced(), get_config(arch).reduced()
    if tc.family == "encdec":
        want = jax.eval_shape(lambda: jinit_encdec(jax.random.PRNGKey(0),
                                                   jc))
        got = encdec_params_to_numpy(init_encdec_params(0, tc,
                                                        device="cpu"))
    else:
        want = jax.eval_shape(lambda: jinit(jax.random.PRNGKey(0), jc))
        got = lm_params_to_numpy(init_lm_params(0, tc, device="cpu"))
    assert jax.tree_util.tree_structure(got) \
        == jax.tree_util.tree_structure(want)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree_util.tree_leaves(got)):
        assert (b.shape, b.dtype) == (a.shape, a.dtype), \
            jax.tree_util.keystr(path)


def test_init_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_lm_params(0, get_config("llama3.2-1b").reduced())


def test_remat_keeps_the_numerics():
    """Per-group checkpointing recomputes the same values."""
    cfg = get_config("llama3.2-1b").reduced(compute_dtype="float32")
    toks = torch.from_numpy(_tokens(cfg, s=64, seed=8))
    model = init_lm_params(3, cfg, device="cpu")
    twin = copy.deepcopy(model)
    loss, _ = lm_loss(model, {"tokens": toks}, cfg)
    loss.backward()
    rloss, _ = lm_loss(twin, {"tokens": toks},
                       cfg.__class__(**{**cfg.__dict__, "remat": True}))
    rloss.backward()
    assert torch.equal(loss, rloss)
    for a, b in zip(model.parameters(), twin.parameters()):
        assert torch.equal(a.grad, b.grad)
