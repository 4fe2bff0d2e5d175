"""The port's encoder-decoder (`models/encdec.py`) and its converters
against the JAX package's, on the CPU.

One reference parameter tree (`init_encdec_params`, as numpy) is carried
into the port with `encdec_params_from_numpy`; caches cross with
`encdec_cache_{from,to}_numpy`.  seamless-m4t-medium `reduced()` (2 + 2
layers, d 128, layernorm, the plain GELU MLP), a 32-frame source (one kv
chunk of 32) and 64 target tokens (two query chunks of 32).  Float32
compute: encoder output, logits and loss rtol 1e-4 / atol 1e-5, every
gradient leaf rtol 1e-3 / atol 1e-5, decode logits and caches rtol 1e-4
/ atol 1e-5 with equal greedy tokens.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget
from repro.models import build_cross_cache as jcross
from repro.models import decode_train as jdecode_train
from repro.models import encdec_decode_step as jstep
from repro.models import encdec_loss as jloss
from repro.models import encode as jencode
from repro.models import init_encdec_cache as jinit_cache
from repro.models import init_encdec_params as jinit
from repro_torch.configs import get_config
from repro_torch.models import (EncDec, build_cross_cache, decode_train,
                                encdec_cache_from_numpy,
                                encdec_cache_to_numpy, encdec_decode_step,
                                encdec_loss, encdec_params_from_numpy,
                                encdec_params_to_numpy, encode,
                                init_encdec_cache, init_encdec_params,
                                vocab_padded)
from repro_torch.tree import tree_paths

torch.set_num_threads(2)

ARCH = "seamless-m4t-medium"
F32 = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=1e-5)
B, SRC, TGT = 2, 32, 64


def _pair(seed=0, **over):
    over.setdefault("compute_dtype", "float32")
    jc, tc = jget(ARCH).reduced(**over), get_config(ARCH).reduced(**over)
    jp = jinit(jax.random.PRNGKey(seed), jc)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jc, tc, jp, encdec_params_from_numpy(tree, tc, device="cpu")


def _batch(tc, seed=1, tgt=TGT):
    rng = np.random.default_rng(seed)
    return {"src_emb": rng.normal(size=(B, SRC, tc.d_model)).astype(
                np.float32),
            "tokens": rng.integers(0, tc.vocab, size=(B, tgt + 1)).astype(
                np.int32)}


def test_encode_and_decode_train_match_reference():
    jc, tc, jp, model = _pair()
    batch = _batch(tc)
    src, inp = batch["src_emb"], batch["tokens"][:, :-1]
    jenc = jencode(jp, jnp.asarray(src), jc)
    jlogits = jdecode_train(jp, jenc, jnp.asarray(inp), jc)
    with torch.no_grad():
        tenc = encode(model, torch.from_numpy(src), tc)
        tlogits = decode_train(model, tenc, torch.from_numpy(inp).long(),
                               tc)
    np.testing.assert_allclose(tenc.numpy(), np.asarray(jenc), **F32)
    assert tlogits.shape == (B, TGT, vocab_padded(tc))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **F32)


@pytest.mark.parametrize("ce_chunk", [0, 32])
def test_loss_and_grads_match_reference(ce_chunk):
    jc, tc, jp, model = _pair(seed=2, ce_chunk=ce_chunk)
    batch = _batch(tc, seed=3)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jloss(p, b, jc), has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tm = encdec_loss(model, {k: torch.from_numpy(v)
                                 for k, v in batch.items()}, tc)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), **F32)
    for k in ("ce", "aux", "ppl_proxy"):
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]),
                                   **F32)
    twin = EncDec(tc, device="cpu")
    with torch.no_grad():
        for g, p in zip(twin.parameters(), model.parameters()):
            g.copy_(p.grad)
    got = dict(tree_paths(encdec_params_to_numpy(twin)))
    want = dict(tree_paths(jax.tree_util.tree_map(np.asarray, jg)))
    assert sorted(got) == sorted(want)
    for k, a in want.items():
        np.testing.assert_allclose(got[k], a, **GRAD, err_msg="/".join(k))


def test_cross_cache_and_decode_steps_match_reference():
    jc, tc, jp, model = _pair(seed=4)
    batch = _batch(tc, seed=5)
    src = batch["src_emb"]
    jenc = jencode(jp, jnp.asarray(src), jc)
    jcaches = jinit_cache(jc, B, 12, SRC, dtype=jnp.float32)
    jcaches = dict(jcaches, cross=jcross(jp, jenc, jc, dtype=jnp.float32))
    with torch.no_grad():
        tenc = encode(model, torch.from_numpy(src), tc)
        cross = build_cross_cache(model, tenc, tc, dtype=torch.float32)
    tcaches = init_encdec_cache(tc, B, 12, SRC, dtype=torch.float32,
                                device="cpu")
    tcaches["cross"] = cross
    for a, b in zip(encdec_cache_to_numpy(tcaches, tc)["cross"],
                    jcaches["cross"]):
        np.testing.assert_allclose(a, np.asarray(b), **F32)
    step = jax.jit(lambda p, t, pos, c: jstep(p, t, pos, c, jc))
    jtok = ttok = batch["tokens"][:, 0]
    for i in range(12):
        jlog, jcaches = step(jp, jnp.asarray(jtok), jnp.int32(i), jcaches)
        with torch.inference_mode():
            tlog, tcaches = encdec_decode_step(
                model, torch.from_numpy(np.asarray(ttok)).long(), i,
                tcaches, tc)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **F32)
        jtok, ttok = np.asarray(jlog.argmax(-1)), tlog.argmax(-1).numpy()
        np.testing.assert_array_equal(ttok, jtok)
    got = encdec_cache_to_numpy(tcaches, tc)
    for key in ("self", "cross"):
        for a, b in zip(got[key], jcaches[key]):
            np.testing.assert_allclose(a, np.asarray(b), **F32,
                                       err_msg=key)


def test_init_cache_and_converters_round_trip():
    jc, tc, jp, model = _pair()
    ref = jinit_cache(jc, 3, 20, SRC)
    caches = init_encdec_cache(tc, 3, 20, SRC, device="cpu")
    assert all(c.k.dtype == torch.bfloat16 for k in caches
               for c in caches[k])
    tree = encdec_cache_to_numpy(caches, tc)
    for key in ("self", "cross"):
        assert tree[key].k.shape == ref[key].k.shape == tree[key].v.shape
    rng = np.random.default_rng(6)
    filled = {k: type(c)(*(rng.normal(size=a.shape).astype(np.float32)
                           for a in c)) for k, c in tree.items()}
    back = encdec_cache_to_numpy(encdec_cache_from_numpy(filled, tc,
                                                         device="cpu"), tc)
    for key in ("self", "cross"):
        for a, b in zip(back[key], filled[key]):
            np.testing.assert_array_equal(a, b)
    want = jax.tree_util.tree_map(np.asarray, jp)
    got = encdec_params_to_numpy(model)
    assert jax.tree_util.tree_structure(got) \
        == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)
    fresh = init_encdec_params(0, tc, device="cpu")
    again = encdec_params_to_numpy(encdec_params_from_numpy(
        encdec_params_to_numpy(fresh), tc, device="cpu"))
    for a, b in zip(jax.tree_util.tree_leaves(again),
                    jax.tree_util.tree_leaves(
                        encdec_params_to_numpy(fresh))):
        np.testing.assert_array_equal(a, b)


def test_padded_vocab_never_wins():
    """seamless's vocabulary pads to a multiple of 128 (250 -> 256):
    the padded rows read -1e30 in the loss and in decode, on both
    sides, as `tests/test_models.py::test_vocab_padding_masked`."""
    jc, tc, jp, model = _pair(seed=7, vocab=250)
    assert vocab_padded(tc) == 256
    assert model.embed.table.shape[0] == 256
    batch = _batch(tc, seed=8, tgt=16)
    jl, _ = jloss(jp, {k: jnp.asarray(v) for k, v in batch.items()}, jc)
    with torch.no_grad():
        tl, _ = encdec_loss(model, {k: torch.from_numpy(v)
                                    for k, v in batch.items()}, tc)
    np.testing.assert_allclose(float(tl), float(jl), **F32)
    caches = init_encdec_cache(tc, B, 32, 16, device="cpu")
    with torch.inference_mode():
        logits, _ = encdec_decode_step(model, torch.zeros(B, dtype=torch.long),
                                       0, caches, tc)
    assert logits.shape == (B, 256)
    assert int(logits.argmax(-1).max()) < 250
    assert float(logits[:, 250:].max()) < -1e20


def test_lengths_must_divide_into_chunks_on_both_sides():
    """A 48-frame source under `reduced()`'s q_chunk 32 fails on both
    sides (the reference asserts, the port raises); S_q != S_k that
    divide, as cross attention has them, work (ROADMAP.md queue 3)."""
    from repro.models.attention import flash_attention as jflash
    from repro_torch.models.attention import flash_attention

    rng = np.random.default_rng(9)
    q = rng.normal(size=(1, 48, 2, 2, 16)).astype(np.float32)
    k = rng.normal(size=(1, 48, 2, 16)).astype(np.float32)
    with pytest.raises(AssertionError):
        jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k),
               causal=False, q_chunk=32, kv_chunk=64)
    with pytest.raises(ValueError, match="must divide"):
        flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(k), causal=False, q_chunk=32,
                        kv_chunk=64)
    kw = dict(causal=False, q_chunk=16, kv_chunk=64)
    ref = jflash(jnp.asarray(q), jnp.asarray(k[:, :32]),
                 jnp.asarray(k[:, :32]), **kw)
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k[:, :32]),
                          torch.from_numpy(k[:, :32]), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)


def test_encdec_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is valid here")
    cfg = get_config(ARCH).reduced()
    for make in (lambda: init_encdec_params(0, cfg),
                 lambda: init_encdec_cache(cfg, 1, 8, 8),
                 lambda: encdec_params_from_numpy({}, cfg)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
