"""Decoder-only LM assembly for every decoder family.

The reference stacks each group's parameters on a leading (n_groups,)
axis and runs the stack with `lax.scan`.  The port keeps one module per
layer: `LM.blocks` is a `ModuleList` in layer order (layer g * len(group)
+ j is block j of group g), and `lm_backbone` loops over the groups.
The functions `init_lm_params`, `lm_backbone`, `lm_logits`,
`lm_forward`, `chunked_ce`, `lm_loss`, `init_cache`, `lm_decode_step`
and `lm_prefill` keep the reference's names and arguments, with the
`LM` module in place of the parameter tree.  The decode cache follows
the module: `init_cache` returns one cache per layer, in layer order,
where the reference stacks each group's caches on a leading (n_groups,)
axis under "cache_<j>" (layer g * len(group) + j is `cache_<j>[g]`;
`models/convert.py` carries caches across).

Block kinds:
  attn    GQA attention (RoPE, QKV bias, softcap, sliding window,
          local/global alternation, sandwich norms) + MLP
  moe     attention + mixture-of-experts FFN (`models/moe.py`)
  ssm     Mamba2 (SSD) block (`models/ssm.py`)
  mlstm   xLSTM matrix-memory block (`models/xlstm.py`)
  slstm   xLSTM scalar-memory block
  shared  zamba2's shared attention + MLP block, fed concat(x, the
          embedding output).  Its one weight set is `LM.shared`; its
          place in each group's `blocks` is a module without
          parameters, so the weights are stored, stepped and carried
          once and their gradient sums over every invocation.  Each
          invocation keeps its own KV cache.
The "encdec" family is `models/encdec.py`.

`cfg.remat` checkpoints each group (one layer, gemma2's local/global
pair, xLSTM's mLSTM run with its sLSTM, zamba2's SSM run with the shared
block) with `torch.utils.checkpoint`, the reference's `jax.checkpoint`:
"nothing" saves only the group's input, "dots" also saves the outputs of
the matrix products without batch dims (`mm`, `addmm`: the dense
layers; not the attention's `bmm`), the reference's
`checkpoint_dots_with_no_batch_dims`, and recomputes the rest;
"everything" runs without it.  `cfg.scan_layers` and `cfg.outer_scan`
change only how XLA compiles the stack, so the port ignores them: the
numerics are the same.

`lm_backbone` calls `sharding/hints.py::maybe_shard` on the residual
where the reference does (after the embedding, at each group's entry):
a no-op unless activation hints are installed and the residual is a
DTensor.
"""
from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models.attention import (KVCache, _as_pos, attend_train,
                                          attention_init, decode_attention)
from repro_torch.models.common import ModelConfig, vocab_padded
from repro_torch.models.layers import (Params, dense, dense_init, embed,
                                       embedding_init, layernorm,
                                       layernorm_init, rmsnorm,
                                       rmsnorm_init, softcap, unembed)
from repro_torch.models.mlp import mlp, mlp_init
from repro_torch.models.moe import moe, moe_init
from repro_torch.models.ssm import (ssm_cache_init, ssm_decode_step,
                                    ssm_forward, ssm_init)
from repro_torch.models.xlstm import (mlstm_cache_init, mlstm_decode_step,
                                      mlstm_forward, mlstm_init,
                                      slstm_cache_init, slstm_decode_step,
                                      slstm_forward, slstm_init)
from repro_torch.sharding.hints import (maybe_shard, vocab_parallel_ce,
                                        vocab_split)

__all__ = ["BlockDef", "block_layout", "LM", "init_lm_params",
           "lm_backbone", "lm_logits", "lm_forward", "chunked_ce",
           "lm_loss", "init_cache", "lm_decode_step", "lm_prefill",
           "DOTS", "remat_context"]

# the matrix products without batch dims: what "dots" saves
DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_context(policy: str):
    """`torch.utils.checkpoint`'s `context_fn` for a remat policy:
    "nothing" recomputes the whole group (the default contexts), "dots"
    saves the `DOTS` outputs and recomputes the rest."""
    if policy == "dots":
        return functools.partial(create_selective_checkpoint_contexts,
                                 _dots_policy)
    if policy == "nothing":
        from torch.utils.checkpoint import noop_context_fn
        return noop_context_fn
    raise ValueError(f"no checkpoint for remat_policy {policy!r}")


# ------------------------------------------------------------- layouts --
class BlockDef(NamedTuple):
    kind: str
    window: Optional[int] = None  # sliding window for this block


def block_layout(cfg: ModelConfig) -> Tuple[List[BlockDef], int]:
    """Returns (blocks-per-group, n_groups)."""
    if cfg.family == "moe":
        return [BlockDef("moe", cfg.window)], cfg.n_layers
    if cfg.family == "ssm":  # xlstm
        if cfg.slstm_every:
            grp = [BlockDef("mlstm")] * (cfg.slstm_every - 1) + [
                BlockDef("slstm")]
            assert cfg.n_layers % cfg.slstm_every == 0
            return grp, cfg.n_layers // cfg.slstm_every
        return [BlockDef("mlstm")], cfg.n_layers
    if cfg.family == "hybrid":  # zamba2
        per = cfg.shared_period
        assert per and cfg.n_layers % per == 0
        grp = [BlockDef("ssm")] * per + [BlockDef("shared")]
        return grp, cfg.n_layers // per
    if cfg.local_global_period:  # gemma2
        grp = [BlockDef("attn", cfg.window), BlockDef("attn", None)]
        assert cfg.n_layers % 2 == 0
        return grp, cfg.n_layers // 2
    return [BlockDef("attn", cfg.window)], cfg.n_layers


def _norm_fns(cfg):
    if getattr(cfg, "norm_type", "rmsnorm") == "layernorm":
        return layernorm_init, layernorm
    return rmsnorm_init, rmsnorm


# ---------------------------------------------------------------- init --
class Block(Params):
    """One block of kind `bd.kind`.  A "shared" block holds no
    parameters: it marks where `LM.shared` is applied."""

    def __init__(self, gen, bd: BlockDef, cfg: ModelConfig, device=None):
        super().__init__()
        self.bd = bd
        if bd.kind == "shared":
            return
        ninit, _ = _norm_fns(cfg)
        d, pd = cfg.d_model, cfg.pdtype
        self.ln1 = ninit(d, pd, device)
        if bd.kind in ("attn", "moe"):
            self.attn = attention_init(gen, cfg, device=device)
            self.ln2 = ninit(d, pd, device)
            if cfg.local_global_period:  # gemma2 sandwich norms
                self.post_ln1 = ninit(d, pd, device)
                self.post_ln2 = ninit(d, pd, device)
            if bd.kind == "moe":
                self.moe = moe_init(gen, cfg, device=device)
            else:
                self.mlp = mlp_init(gen, d, cfg.d_ff, pd, cfg.mlp_gated,
                                    device=device)
        elif bd.kind == "ssm":
            self.ssm = ssm_init(gen, cfg, device=device)
        elif bd.kind == "mlstm":
            self.mlstm = mlstm_init(gen, cfg, device=device)
        elif bd.kind == "slstm":
            self.slstm = slstm_init(gen, cfg, device=device)
        else:
            raise ValueError(bd.kind)


def _shared_init(gen, cfg: ModelConfig, device=None) -> Params:
    """zamba2's shared block: concat(x, emb0) -> proj -> attn + mlp."""
    ninit, _ = _norm_fns(cfg)
    d, pd = cfg.d_model, cfg.pdtype
    p = Params()
    p.ln_in = ninit(2 * d, pd, device)
    p.win = dense_init(gen, 2 * d, d, False, pd, device=device)
    p.attn = attention_init(gen, cfg, device=device)
    p.ln2 = ninit(d, pd, device)
    p.mlp = mlp_init(gen, d, cfg.d_ff, pd, device=device)
    return p


class LM(Params):
    """The decoder LM's parameters: `embed`, `final_norm`, `unembed`
    (untied configs only), `blocks` (one per layer) and `shared` (the
    hybrid family's shared block, once)."""

    def __init__(self, cfg: ModelConfig, gen=None, device=None):
        super().__init__()
        grp, n_groups = block_layout(cfg)
        ninit, _ = _norm_fns(cfg)
        d, pd = cfg.d_model, cfg.pdtype
        self.cfg = cfg
        self.embed = embedding_init(gen, vocab_padded(cfg), d, pd, device)
        self.final_norm = ninit(d, pd, device)
        if not cfg.tie_embeddings:
            self.unembed = dense_init(gen, d, cfg.vocab, False, pd,
                                      device=device)
        self.blocks = nn.ModuleList(
            Block(gen, grp[j], cfg, device)
            for _ in range(n_groups) for j in range(len(grp)))
        if any(bd.kind == "shared" for bd in grp):
            self.shared = _shared_init(gen, cfg, device)

    def forward(self, tokens):
        return lm_forward(self, tokens, self.cfg)


def init_lm_params(seed: int, cfg: ModelConfig, device=None) -> LM:
    """A randomly initialised LM on `device` (the card unless the caller
    names another).  The draws come from a CPU generator seeded with
    `seed`, so the weights do not depend on the device."""
    from repro_torch.engine.engine import resolve_device
    gen = torch.Generator().manual_seed(int(seed))
    return LM(cfg, gen=gen, device=resolve_device(device))


# ------------------------------------------------------------- forward --
def _attn_mlp(bp, bd: BlockDef, x, cfg, attend):
    """The "attn" / "moe" block around `attend(h)`, the attention
    sub-layer of the training or the decode path."""
    _, norm = _norm_fns(cfg)
    post = cfg.local_global_period > 0
    h = norm(bp["ln1"], x, cfg.norm_eps)
    h = attend(h)
    if post:
        h = norm(bp["post_ln1"], h, cfg.norm_eps)
    x = x + h
    h = norm(bp["ln2"], x, cfg.norm_eps)
    if bd.kind == "moe":
        h, aux = moe(bp["moe"], h, cfg)
    else:
        h, aux = mlp(bp["mlp"], h, cfg.cdtype,
                     getattr(cfg, "mlp_act", "silu")), {}
    if post:
        h = norm(bp["post_ln2"], h, cfg.norm_eps)
    return x + h, aux


def _shared_block(sp, x, emb0, cfg, attend):
    """zamba2's shared block around `attend(h)`."""
    _, norm = _norm_fns(cfg)
    h = torch.cat([x, emb0], dim=-1)
    h = norm(sp["ln_in"], h, cfg.norm_eps)
    h = dense(sp["win"], h, cfg.cdtype)
    x = x + attend(h)
    h = norm(sp["ln2"], x, cfg.norm_eps)
    return x + mlp(sp["mlp"], h, cfg.cdtype)


_RECURRENT = {"ssm": ssm_forward, "mlstm": mlstm_forward,
              "slstm": slstm_forward}


def _apply_block(bp, bd: BlockDef, x, cfg, shared=None, emb0=None):
    """Training-path block application.  x (B, S, d) -> (x, aux)."""
    if bd.kind in ("attn", "moe"):
        return _attn_mlp(bp, bd, x, cfg, lambda h: attend_train(
            bp["attn"], h, cfg, causal=True, window=bd.window)[0])
    if bd.kind == "shared":
        return _shared_block(shared, x, emb0, cfg, lambda h: attend_train(
            shared["attn"], h, cfg, causal=True)[0]), {}
    _, norm = _norm_fns(cfg)
    h = norm(bp["ln1"], x, cfg.norm_eps)
    return x + _RECURRENT[bd.kind](bp[bd.kind], h, cfg), {}


def _embed(params: LM, tokens, cfg: ModelConfig):
    """Token embeddings in the compute dtype; gemma scales them by
    sqrt(d) rounded to the compute dtype (a Python float of that value,
    so no host-to-device copy)."""
    x = embed(params["embed"], tokens, cfg.cdtype)
    if cfg.local_global_period:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.cdtype).item()
    return x


def _group_body(x, blocks, cfg, shared, emb0):
    """One group: (x, its MoE aux, load_balance + 1e-3 * router_z per
    MoE block)."""
    aux_acc = torch.zeros((), dtype=torch.float32, device=x.device)
    x = x.to(cfg.cdtype)  # keep the remat-saved carry in bf16
    x = maybe_shard(x, "residual")
    for bp in blocks:
        x, aux = _apply_block(bp, bp.bd, x, cfg, shared, emb0)
        if aux:
            aux_acc = aux_acc + aux["load_balance"] \
                + 1e-3 * aux["router_z"]
    return x, aux_acc


def lm_backbone(params: LM, tokens, cfg: ModelConfig):
    """tokens (B, S) int -> (final-norm hidden (B, S, d), aux)."""
    grp, n_groups = block_layout(cfg)
    _, norm = _norm_fns(cfg)
    x = maybe_shard(_embed(params, tokens, cfg), "residual")
    emb0 = x
    shared = params.shared if "shared" in params else None
    remat = (cfg.remat and torch.is_grad_enabled()
             and cfg.remat_policy != "everything")
    context_fn = remat_context(cfg.remat_policy) if remat else None
    blocks = params["blocks"]
    per = len(grp)
    auxs = []
    for g in range(n_groups):
        group = list(blocks[g * per:(g + 1) * per])
        if remat:
            x, aux = checkpoint(_group_body, x, group, cfg, shared, emb0,
                                use_reentrant=False, context_fn=context_fn)
        else:
            x, aux = _group_body(x, group, cfg, shared, emb0)
        auxs.append(aux)
    x = norm(params["final_norm"], x, cfg.norm_eps)
    return x, torch.stack(auxs).sum()


def lm_logits(params: LM, x, cfg: ModelConfig):
    """Read-out head on hidden x (..., d) -> (..., vocab) float32."""
    if cfg.tie_embeddings:
        logits = unembed(params["embed"], x, cfg.vocab)
    else:
        logits = dense(params["unembed"], x).float()
    return softcap(logits, cfg.final_softcap)


def lm_forward(params: LM, tokens, cfg: ModelConfig):
    """tokens (B, S) int -> (logits (B, S, vocab) float32, aux)."""
    x, aux = lm_backbone(params, tokens, cfg)
    return lm_logits(params, x, cfg), aux


def _ce_sum(logits_fn, x, tgt):
    """Per-token logsumexp(logits) - logits[gold], as one fused
    log-softmax + NLL (its backward has no scatter-add, so it stays
    deterministic on the card); over vocab-split DTensor logits, shard
    by shard (`sharding/hints.py::vocab_parallel_ce`)."""
    logits = logits_fn(x)
    if vocab_split(logits):
        return vocab_parallel_ce(logits, tgt)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           tgt.reshape(-1), reduction="none"
                           ).reshape(tgt.shape)


def chunked_ce(logits_fn, x, tgt, chunk: int):
    """Mean next-token CE without materializing (B, S, V): the read-out
    and log-softmax run per sequence chunk, each chunk checkpointed so
    the backward recomputes its logits (flash-CE).  Unchunked when
    `chunk` is 0, at least S, or does not divide S."""
    b, s, _ = x.shape
    if not chunk or s <= chunk or s % chunk:
        return _ce_sum(logits_fn, x, tgt).mean()
    recompute = torch.is_grad_enabled()
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(s // chunk):
        xi = x[:, i * chunk:(i + 1) * chunk]
        ti = tgt[:, i * chunk:(i + 1) * chunk]
        if recompute:
            part = checkpoint(_ce_sum, logits_fn, xi, ti,
                              use_reentrant=False)
        else:
            part = _ce_sum(logits_fn, xi, ti)
        total = total + part.sum()
    return total / (b * s)


def lm_loss(params: LM, batch, cfg: ModelConfig):
    """batch: {tokens (B, S+1)} -> (loss, metrics).  Next-token CE."""
    tokens = batch["tokens"].long()
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    x, aux = lm_backbone(params, inp, cfg)
    ce = chunked_ce(lambda h: lm_logits(params, h, cfg), x, tgt,
                    cfg.ce_chunk)
    loss = ce + 0.01 * aux
    return loss, {"ce": ce, "aux": aux,
                  "ppl_proxy": torch.exp(torch.clamp(ce, max=20.0))}


# -------------------------------------------------------------- serving
def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None) -> list:
    """One zeroed cache per layer, in layer order, on `device` (the card
    unless the caller names another).  Attention blocks ("attn", "moe"
    and each invocation of "shared") get a `KVCache` of (batch, S, KV,
    D) in `dtype`, S = min(max_seq, window) for a windowed block; the
    recurrent blocks get their float32 state whatever `dtype` is:
    `SSMCache`, `MLSTMCache` (m at -1e30), `SLSTMCache` (n at 1e-6, m at
    -1e30)."""
    from repro_torch.engine.engine import resolve_device
    dev = resolve_device(device)
    grp, n_groups = block_layout(cfg)
    recurrent = {"ssm": ssm_cache_init, "mlstm": mlstm_cache_init,
                 "slstm": slstm_cache_init}

    def one(bd: BlockDef):
        if bd.kind in recurrent:
            return recurrent[bd.kind](cfg, batch, dtype=torch.float32,
                                      device=dev)
        s = min(max_seq, bd.window) if bd.window else max_seq
        shape = (batch, s, cfg.n_kv, cfg.head_dim)
        return KVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                       v=torch.zeros(shape, dtype=dtype, device=dev))

    return [one(bd) for _ in range(n_groups) for bd in grp]


_RECURRENT_STEP = {"ssm": ssm_decode_step, "mlstm": mlstm_decode_step,
                   "slstm": slstm_decode_step}


def _decode_block(bp, bd: BlockDef, x, cache, pos, cfg, shared=None,
                  emb0=None):
    """Decode-path block application.  x (B, 1, d) -> (x, cache), the
    cache written in place."""
    if bd.kind in ("attn", "moe"):
        ring = bd.window is not None and cache.k.shape[1] == bd.window
        x, _ = _attn_mlp(bp, bd, x, cfg, lambda h: decode_attention(
            bp["attn"], h, cache, pos, cfg, window=bd.window,
            ring=ring)[0])
        return x, cache
    if bd.kind == "shared":
        return _shared_block(shared, x, emb0, cfg, lambda h:
                             decode_attention(shared["attn"], h, cache,
                                              pos, cfg)[0]), cache
    _, norm = _norm_fns(cfg)
    h = norm(bp["ln1"], x, cfg.norm_eps)
    h, cache = _RECURRENT_STEP[bd.kind](bp[bd.kind], h, cache, cfg)
    return x + h, cache


def lm_decode_step(params: LM, token, pos, caches: list, cfg: ModelConfig):
    """One decode step.  token (B,) int, pos a Python int or a 0-d
    integer tensor.  Writes every layer's cache in place; returns
    (logits (B, vocab) float32, caches)."""
    _, norm = _norm_fns(cfg)
    blocks = params["blocks"]
    if len(caches) != len(blocks):
        raise ValueError(f"{len(caches)} caches for {len(blocks)} layers")
    x = _embed(params, token[:, None], cfg)  # (B, 1, d)
    emb0 = x
    shared = params.shared if "shared" in params else None
    pos = _as_pos(pos, x.device)  # one fill, not one per layer
    for i, bp in enumerate(blocks):
        x, caches[i] = _decode_block(bp, bp.bd, x, caches[i], pos, cfg,
                                     shared, emb0)
    x = norm(params["final_norm"], x, cfg.norm_eps)
    return lm_logits(params, x[:, 0], cfg), caches


def lm_prefill(params: LM, tokens, cfg: ModelConfig):
    """Prefill forward: the full backbone over the prompt, the read-out
    on the last position only (materializing (B, S, V) logits would
    dwarf every other buffer).  Runs without autograd, so the backbone
    takes no remat.  Returns logits (B, vocab) float32."""
    with torch.inference_mode():
        x, _ = lm_backbone(params, tokens, cfg)
        return lm_logits(params, x[:, -1], cfg)
