"""The port's decode path (`KVCache`, `decode_attention`, `init_cache`,
`lm_decode_step`, `lm_prefill`) against the JAX package's, on the CPU.

One reference parameter tree is carried into the port with
`lm_params_from_numpy`, and caches cross both ways with
`lm_cache_{from,to}_numpy`.  Four dense variants, all `reduced()`:
llama3.2-1b; qwen2-7b with QKV bias and, by override, an untied
read-out; gemma2-2b (softcaps, attn_scale, local/global caches,
sandwich norms, the embedding scale); starcoder2-3b (window 64,
layernorm, GELU, the plain MLP), stepped past the ring's wrap.
Float32 compute: rtol 1e-4 / atol 1e-5 and equal greedy tokens;
bfloat16: rtol 2e-2 / atol 2e-2 * max|ref|.  Decode against the
port's own forward: rtol 5e-2 / atol 5e-2, argmax equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget
from repro.models import init_cache as jinit_cache
from repro.models import init_encdec_cache as jinit_encdec_cache
from repro.models import init_lm_params as jinit
from repro.models import lm_decode_step as jdecode
from repro.models import lm_prefill as jprefill
from repro.models.attention import KVCache as JKV
from repro.models.attention import attention_init as jattn_init
from repro.models.attention import decode_attention as jdecode_attn
from repro_torch.configs import get_config
from repro_torch.models import (KVCache, encdec_cache_to_numpy, init_cache,
                                init_encdec_cache, init_lm_params,
                                lm_cache_from_numpy, lm_cache_to_numpy,
                                lm_decode_step, lm_forward,
                                lm_params_from_numpy, lm_prefill)
from repro_torch.models.attention import decode_attention

torch.set_num_threads(2)

F32 = dict(rtol=1e-4, atol=1e-5)
# (arch, overrides): qwen2's read-out untied to cover `unembed`
VARIANTS = [("llama3.2-1b", {}),
            ("qwen2-7b", {"tie_embeddings": False}),
            ("gemma2-2b", {}), ("starcoder2-3b", {})]
IDS = [a for a, _ in VARIANTS]


def _pair(arch, **over):
    jc, tc = jget(arch).reduced(**over), get_config(arch).reduced(**over)
    jp = jinit(jax.random.PRNGKey(0), jc)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jc, tc, jp, lm_params_from_numpy(tree, tc, device="cpu")


def _np_cache(tree):
    return {k: JKV(k=np.asarray(c.k, np.float32),
                   v=np.asarray(c.v, np.float32)) for k, c in tree.items()}


def _same_cache(port, ref, cfg, **tol):
    got, want = lm_cache_to_numpy(port, cfg), _np_cache(ref)
    assert sorted(got) == sorted(want)
    for key in want:
        for a, b in zip(got[key], want[key]):
            assert a.shape == b.shape, key
            np.testing.assert_allclose(a, b, err_msg=key, **tol)


def _steps(arch, n, max_seq, b=2, seed=0, greedy=False, cache_dtype=None,
           **over):
    """n decode steps on both sides from one tree and zero caches:
    teacher-forced on a numpy token draw, or greedy from its first
    token.  Returns (ref logits, port logits, ref tokens, port tokens,
    ref caches, port caches, port cfg)."""
    jc, tc, jp, model = _pair(arch, **over)
    cd = cache_dtype or "float32"
    jcache = jinit_cache(jc, b, max_seq, dtype=jnp.dtype(cd))
    tcache = init_cache(tc, b, max_seq, dtype=getattr(torch, cd),
                        device="cpu")
    toks = np.random.default_rng(seed).integers(
        0, tc.vocab, size=(n, b)).astype(np.int32)
    step = jax.jit(lambda p, t, pos, c: jdecode(p, t, pos, c, jc))
    jl, tl, jt, tt = [], [], [toks[0]], [torch.from_numpy(toks[0])]
    with torch.inference_mode():
        for i in range(n):
            jlog, jcache = step(jp, jnp.asarray(jt[-1]), jnp.int32(i),
                                jcache)
            tlog, tcache = lm_decode_step(model, tt[-1], i, tcache, tc)
            jl.append(np.asarray(jlog))
            tl.append(tlog.numpy())
            if i + 1 < n:
                jt.append(np.asarray(jlog.argmax(-1)) if greedy
                          else toks[i + 1])
                tt.append(tlog.argmax(-1) if greedy
                          else torch.from_numpy(toks[i + 1]))
    return (np.stack(jl), np.stack(tl), np.stack(jt),
            np.stack([t.numpy() for t in tt]), jcache, tcache, tc)


# ------------------------------------------------------ decode_attention
# (window, ring, cross, S, pos)
ATTN_CASES = {"plain": (None, False, False, 16, 5),
              "window": (4, False, False, 16, 10),
              "ring": (8, True, False, 8, 13),
              "cross": (None, False, True, 12, 3)}


@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen2-7b"])
@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_decode_attention_matches_reference(arch, case):
    window, ring, cross, s, pos = ATTN_CASES[case]
    jc = jget(arch).reduced(compute_dtype="float32")
    tc = get_config(arch).reduced(compute_dtype="float32")
    jp = jattn_init(jax.random.PRNGKey(1), jc)
    if "b" in jp["wq"]:  # nonzero biases: zeros would not test them
        jp = {k: dict(v, b=0.1 * jax.random.normal(
            jax.random.PRNGKey(i), v["b"].shape)) if "b" in v else v
            for i, (k, v) in enumerate(jp.items())}
    tp = {k: {n: torch.from_numpy(np.array(a)) for n, a in v.items()}
          for k, v in jp.items()}
    rng = np.random.default_rng(2)
    b = 2
    x = rng.normal(size=(b, 1, tc.d_model)).astype(np.float32)
    shape = (b, s, tc.n_kv, tc.head_dim)
    ck, cv = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    for p in (pos, jnp.int32(pos)):  # a Python int and a traced scalar
        jout, jcache = jax.jit(lambda x, c, p: jdecode_attn(
            jp, x, c, p, jc, window=window, cross=cross, ring=ring))(
                jnp.asarray(x), JKV(jnp.asarray(ck), jnp.asarray(cv)), p)
        for tpos in (pos, torch.tensor(pos)):
            cache = KVCache(torch.from_numpy(ck.copy()),
                            torch.from_numpy(cv.copy()))
            out, got = decode_attention(tp, torch.from_numpy(x), cache,
                                        tpos, tc, window=window,
                                        cross=cross, ring=ring)
            assert got.k is cache.k  # written in place
            np.testing.assert_allclose(out.numpy(), np.asarray(jout), **F32)
            np.testing.assert_allclose(got.k.numpy(), np.asarray(jcache.k),
                                       **F32)
            np.testing.assert_array_equal(got.v.numpy(),
                                          np.asarray(jcache.v))
    if cross:
        np.testing.assert_array_equal(cache.k.numpy(), ck)


def test_decode_attention_bf16_cache_and_compute():
    jc = jget("llama3.2-1b").reduced()
    tc = get_config("llama3.2-1b").reduced()
    jp = jattn_init(jax.random.PRNGKey(3), jc)
    tp = {k: {n: torch.from_numpy(np.array(a)) for n, a in v.items()}
          for k, v in jp.items()}
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 1, tc.d_model)).astype(np.float32)
    shape = (2, 16, tc.n_kv, tc.head_dim)
    ck, cv = (jnp.asarray(rng.normal(size=shape), jnp.bfloat16)
              for _ in range(2))
    jout, jcache = jdecode_attn(jp, jnp.asarray(x, jnp.bfloat16),
                                JKV(ck, cv), jnp.int32(7), jc)
    tree = {"cache_0": JKV(np.asarray(ck)[None], np.asarray(cv)[None])}
    cache = lm_cache_from_numpy(tree, dataclasses.replace(tc, n_layers=1),
                                device="cpu")[0]
    assert cache.k.dtype == torch.bfloat16
    out, got = decode_attention(
        tp, torch.from_numpy(x).to(torch.bfloat16), cache, 7, tc)
    ref = np.asarray(jout, np.float32)
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=2e-2,
                               atol=2e-2 * np.abs(ref).max())
    np.testing.assert_array_equal(got.k.float().numpy(),
                                  np.asarray(jcache.k, np.float32))


# ------------------------------------------------------------ init_cache
@pytest.mark.parametrize("arch", IDS)
def test_init_cache_matches_reference(arch):
    jc, tc = jget(arch).reduced(), get_config(arch).reduced()
    ref = jinit_cache(jc, 3, 100)
    caches = init_cache(tc, 3, 100, device="cpu")
    assert all(c.k.dtype == torch.bfloat16 and c.k is not c.v
               and not c.k.any() for c in caches)
    tree = lm_cache_to_numpy(caches, tc)
    assert sorted(tree) == sorted(ref)
    for key, c in ref.items():
        assert c.k.dtype == jnp.bfloat16
        assert tree[key].k.shape == c.k.shape == tree[key].v.shape
    if tc.window:  # the windowed block keeps min(max_seq, window) slots
        assert caches[0].k.shape[1] == tc.window
    back = lm_cache_from_numpy(jax.tree_util.tree_map(np.asarray, ref), tc,
                               device="cpu")
    assert [c.k.dtype for c in back] == [torch.bfloat16] * len(caches)
    assert [c.k.shape for c in back] == [c.k.shape for c in caches]


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "xlstm-350m",
                                  "zamba2-2.7b", "seamless-m4t-medium"])
def test_non_dense_kinds_raise(arch):
    """Each other family's cache (the name is from when it raised) has
    the reference's tree, leaf shapes and fills through the converter:
    KV caches in the given dtype (one per shared-block invocation), the
    recurrent states in float32 whatever the dtype, the encoder-decoder's
    self and cross caches."""
    jc, tc = jget(arch).reduced(), get_config(arch).reduced()
    if tc.family == "encdec":
        ref = jinit_encdec_cache(jc, 3, 20, 16)
        tree = encdec_cache_to_numpy(
            init_encdec_cache(tc, 3, 20, 16, device="cpu"), tc)
    else:
        ref = jinit_cache(jc, 3, 100)
        caches = init_cache(tc, 3, 100, device="cpu")
        assert len({id(a) for c in caches for a in c}) \
            == sum(len(c) for c in caches)  # distinct buffers
        tree = lm_cache_to_numpy(caches, tc)
        back = lm_cache_from_numpy(jax.tree_util.tree_map(np.asarray, ref),
                                   tc, device="cpu")
        assert [[(a.shape, a.dtype) for a in c] for c in back] \
            == [[(a.shape, a.dtype) for a in c] for c in caches]
    assert sorted(tree) == sorted(ref)
    for key, c in ref.items():
        assert tree[key]._fields == c._fields, key
        for a, b in zip(tree[key], c):
            assert a.shape == b.shape, key
            # bfloat16 comes back as float32; the fills are equal
            np.testing.assert_array_equal(a, np.asarray(b, np.float32))
            if b.dtype != jnp.bfloat16:
                assert a.dtype == b.dtype, key


# -------------------------------------------------------- lm_decode_step
@pytest.mark.parametrize("arch,over", VARIANTS, ids=IDS)
def test_decode_steps_match_reference_f32(arch, over):
    jl, tl, jt, tt, jc, tcache, tc = _steps(
        arch, 12, 20, greedy=True, compute_dtype="float32", **over)
    np.testing.assert_allclose(tl, jl, **F32)
    np.testing.assert_array_equal(tt, jt)  # greedy tokens
    _same_cache(tcache, jc, tc, **F32)


def test_starcoder2_ring_past_the_wrap():
    """max_seq 80 > window 64: the windowed cache is a 64-slot ring that
    starts cold (zero keys attendable) and wraps at step 64."""
    jl, tl, _, _, jc, tcache, tc = _steps(
        "starcoder2-3b", 70, 80, compute_dtype="float32")
    assert tcache[0].k.shape[1] == 64 == tc.window
    np.testing.assert_allclose(tl, jl, **F32)
    _same_cache(tcache, jc, tc, **F32)


def test_gemma2_local_ring_and_global_past_the_window():
    jl, tl, _, _, jc, tcache, tc = _steps(
        "gemma2-2b", 68, 72, b=1, compute_dtype="float32")
    assert [c.k.shape[1] for c in tcache] == [64, 72]
    np.testing.assert_allclose(tl, jl, **F32)
    _same_cache(tcache, jc, tc, **F32)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "gemma2-2b"])
def test_decode_steps_match_reference_bf16(arch):
    """bfloat16 compute and the default bfloat16 cache."""
    jl, tl, _, _, jc, tcache, tc = _steps(arch, 8, 16,
                                          cache_dtype="bfloat16")
    np.testing.assert_allclose(tl, jl, rtol=2e-2,
                               atol=2e-2 * np.abs(jl).max())
    assert tcache[0].k.dtype == torch.bfloat16
    got, want = lm_cache_to_numpy(tcache, tc), _np_cache(jc)
    for key in want:
        for a, b in zip(got[key], want[key]):
            np.testing.assert_allclose(a, b, rtol=2e-2,
                                       atol=2e-2 * np.abs(b).max())


def test_decode_continues_from_a_carried_cache():
    """Both sides start from one nonzero reference cache (carried in by
    the converter); the port's in-place cache equals the reference's
    returned one after every step."""
    jc, tc, jp, model = _pair("llama3.2-1b", compute_dtype="float32")
    rng = np.random.default_rng(5)
    ref = jinit_cache(jc, 2, 16, dtype=jnp.float32)
    ref = {k: JKV(*(jnp.asarray(rng.normal(size=a.shape), jnp.float32)
                    for a in c)) for k, c in ref.items()}
    caches = lm_cache_from_numpy(jax.tree_util.tree_map(np.asarray, ref),
                                 tc, device="cpu")
    toks = rng.integers(0, tc.vocab, size=(6, 2)).astype(np.int32)
    step = jax.jit(lambda p, t, pos, c: jdecode(p, t, pos, c, jc))
    with torch.inference_mode():
        for i in range(6):
            jlog, ref = step(jp, jnp.asarray(toks[i]), jnp.int32(5 + i), ref)
            tlog, caches = lm_decode_step(
                model, torch.from_numpy(toks[i]), torch.tensor(5 + i),
                caches, tc)
            np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **F32)
            _same_cache(caches, ref, tc, **F32)


# ------------------------------------------------------------ lm_prefill
@pytest.mark.parametrize("arch,over", VARIANTS, ids=IDS)
def test_prefill_matches_reference(arch, over):
    jc, tc, jp, model = _pair(arch, compute_dtype="float32", **over)
    toks = np.random.default_rng(6).integers(
        0, tc.vocab, size=(2, 128)).astype(np.int32)
    ref = np.asarray(jax.jit(lambda p, t: jprefill(p, t, jc))(
        jp, jnp.asarray(toks)))
    got = lm_prefill(model, torch.from_numpy(toks), tc)
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert not torch.is_grad_enabled() or not got.requires_grad
    np.testing.assert_allclose(got.numpy(), ref, **F32)


# ------------------------------------------------ decode against forward
@pytest.mark.parametrize("arch", ["llama3.2-1b", "gemma2-2b",
                                  "starcoder2-3b"])
def test_decode_prefix_consistency(arch):
    """Decoding t tokens step by step == the port's forward on the same
    prefix (bf16 compute, f32 cache), as the reference's own test."""
    tc = get_config(arch).reduced()
    model = init_lm_params(0, tc, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, tc.vocab, size=(1, 8)))
    with torch.inference_mode():
        full, _ = lm_forward(model, toks, tc)
        caches = init_cache(tc, 1, 16, dtype=torch.float32, device="cpu")
        outs = []
        for t in range(8):
            lg, caches = lm_decode_step(model, toks[:, t], t, caches, tc)
            outs.append(lg)
    dec = torch.stack(outs, dim=1)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), rtol=5e-2,
                               atol=5e-2)
    np.testing.assert_array_equal(dec.argmax(-1).numpy(),
                                  full.argmax(-1).numpy())


def test_decode_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_cache(get_config("llama3.2-1b").reduced(), 1, 8)
