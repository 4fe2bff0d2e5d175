"""Decoder-only LM assembly for the dense families.

The reference stacks each group's parameters on a leading (n_groups,)
axis and runs the stack with `lax.scan`.  The port keeps one module per
layer: `LM.blocks` is a `ModuleList` in layer order (layer g * len(group)
+ j is block j of group g), and `lm_backbone` loops over the groups.
The functions `init_lm_params`, `lm_backbone`, `lm_logits`,
`lm_forward`, `chunked_ce`, `lm_loss`, `init_cache`, `lm_decode_step`
and `lm_prefill` keep the reference's names and arguments, with the
`LM` module in place of the parameter tree.  The decode cache follows
the module: `init_cache` returns one `KVCache` per layer, in layer
order, where the reference stacks each group's caches on a leading
(n_groups,) axis under "cache_<j>" (layer g * len(group) + j is
`cache_<j>[g]`; `models/convert.py` carries caches across).

Block kinds: "attn" (GQA attention + MLP, every dense variant: QKV bias,
softcap, local/global alternation, sandwich norms, the embedding scale,
layernorm, GELU and the non-gated MLP, sliding window).  The kinds
"moe", "ssm", "mlstm", "slstm", "shared" and the "encdec" family raise
`NotImplementedError`; they wait for the other model families (ROADMAP.md
queue 1).

`cfg.remat` checkpoints each group (one layer, or gemma2's local/global
pair) with `torch.utils.checkpoint`, the reference's `jax.checkpoint`
with the "nothing" policy; "everything" runs without it and "dots" has
no counterpart.  `cfg.scan_layers` and `cfg.outer_scan` change only how
XLA compiles the stack, so the port ignores them: the numerics are the
same.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.attention import (KVCache, _as_pos, attend_train,
                                          attention_init, decode_attention)
from repro_torch.models.common import ModelConfig, vocab_padded
from repro_torch.models.layers import (Params, dense, dense_init, embed,
                                       embedding_init, layernorm,
                                       layernorm_init, rmsnorm,
                                       rmsnorm_init, softcap, unembed)
from repro_torch.models.mlp import mlp, mlp_init

__all__ = ["BlockDef", "block_layout", "LM", "init_lm_params",
           "lm_backbone", "lm_logits", "lm_forward", "chunked_ce",
           "lm_loss", "init_cache", "lm_decode_step", "lm_prefill"]

_LATER = ("is not ported yet: the port has the dense decoder only "
          "(ROADMAP.md queue 1: the other model families)")


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
    """One "attn" block: pre-norm attention and MLP, gemma2's sandwich
    norms when the config alternates local and global layers."""

    def __init__(self, gen, bd: BlockDef, cfg: ModelConfig, device=None):
        super().__init__()
        if bd.kind != "attn":
            raise NotImplementedError(f"block kind {bd.kind!r} {_LATER}")
        self.bd = bd
        ninit, _ = _norm_fns(cfg)
        d, pd = cfg.d_model, cfg.pdtype
        self.ln1 = ninit(d, pd, device)
        self.attn = attention_init(gen, cfg, device=device)
        self.ln2 = ninit(d, pd, device)
        if cfg.local_global_period:  # gemma2 sandwich norms
            self.post_ln1 = ninit(d, pd, device)
            self.post_ln2 = ninit(d, pd, device)
        self.mlp = mlp_init(gen, d, cfg.d_ff, pd, cfg.mlp_gated,
                            device=device)


class LM(Params):
    """The decoder LM's parameters: `embed`, `final_norm`, `unembed`
    (untied configs only) and `blocks`, one per layer."""

    def __init__(self, cfg: ModelConfig, gen=None, device=None):
        super().__init__()
        if cfg.family == "encdec":
            raise NotImplementedError(f"family 'encdec' {_LATER}")
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
def _apply_block(bp, bd: BlockDef, x, cfg):
    """Training-path block application. x (B, S, d)."""
    _, norm = _norm_fns(cfg)
    post = cfg.local_global_period > 0
    h = norm(bp["ln1"], x, cfg.norm_eps)
    h, _ = attend_train(bp["attn"], h, cfg, causal=True, window=bd.window)
    if post:
        h = norm(bp["post_ln1"], h, cfg.norm_eps)
    x = x + h
    h = norm(bp["ln2"], x, cfg.norm_eps)
    h = mlp(bp["mlp"], h, cfg.cdtype, getattr(cfg, "mlp_act", "silu"))
    if post:
        h = norm(bp["post_ln2"], h, cfg.norm_eps)
    return x + h


def _embed(params: LM, tokens, cfg: ModelConfig):
    """Token embeddings in the compute dtype; gemma scales them by
    sqrt(d) rounded to the compute dtype (a Python float of that value,
    so no host-to-device copy)."""
    x = embed(params["embed"], tokens, cfg.cdtype)
    if cfg.local_global_period:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.cdtype).item()
    return x


def _group_body(x, blocks, cfg):
    x = x.to(cfg.cdtype)  # keep the remat-saved carry in bf16
    for bp in blocks:
        x = _apply_block(bp, bp.bd, x, cfg)
    return x


def lm_backbone(params: LM, tokens, cfg: ModelConfig):
    """tokens (B, S) int -> (final-norm hidden (B, S, d), aux)."""
    grp, n_groups = block_layout(cfg)
    _, norm = _norm_fns(cfg)
    x = _embed(params, tokens, cfg)
    remat = cfg.remat and torch.is_grad_enabled()
    if remat and cfg.remat_policy == "dots":
        raise NotImplementedError(
            "remat_policy='dots' has no counterpart in the port "
            "(ROADMAP.md queue 1: multi-device and XLA tooling)")
    remat = remat and cfg.remat_policy == "nothing"
    blocks = params["blocks"]
    per = len(grp)
    for g in range(n_groups):
        group = list(blocks[g * per:(g + 1) * per])
        if remat:
            x = checkpoint(_group_body, x, group, cfg, use_reentrant=False)
        else:
            x = _group_body(x, group, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x = norm(params["final_norm"], x, cfg.norm_eps)
    return x, aux


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
    deterministic on the card)."""
    logits = logits_fn(x)
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
               dtype=torch.bfloat16, device=None) -> List[KVCache]:
    """One zeroed `KVCache` per layer, (batch, S, KV, D) each, on
    `device` (the card unless the caller names another).  A windowed
    block keeps S = min(max_seq, window)."""
    from repro_torch.engine.engine import resolve_device
    if cfg.family == "encdec":
        raise NotImplementedError(f"family 'encdec' {_LATER}")
    dev = resolve_device(device)
    grp, n_groups = block_layout(cfg)
    caches = []
    for _ in range(n_groups):
        for bd in grp:
            if bd.kind != "attn":
                raise NotImplementedError(
                    f"block kind {bd.kind!r} {_LATER}")
            s = min(max_seq, bd.window) if bd.window else max_seq
            shape = (batch, s, cfg.n_kv, cfg.head_dim)
            caches.append(KVCache(
                k=torch.zeros(shape, dtype=dtype, device=dev),
                v=torch.zeros(shape, dtype=dtype, device=dev)))
    return caches


def _decode_block(bp, bd: BlockDef, x, cache: KVCache, pos, cfg):
    """Decode-path block application. x (B, 1, d)."""
    _, norm = _norm_fns(cfg)
    post = cfg.local_global_period > 0
    ring = bd.window is not None and cache.k.shape[1] == bd.window
    h = norm(bp["ln1"], x, cfg.norm_eps)
    h, cache = decode_attention(bp["attn"], h, cache, pos, cfg,
                                window=bd.window, ring=ring)
    if post:
        h = norm(bp["post_ln1"], h, cfg.norm_eps)
    x = x + h
    h = norm(bp["ln2"], x, cfg.norm_eps)
    h = mlp(bp["mlp"], h, cfg.cdtype, getattr(cfg, "mlp_act", "silu"))
    if post:
        h = norm(bp["post_ln2"], h, cfg.norm_eps)
    return x + h, cache


def lm_decode_step(params: LM, token, pos, caches: List[KVCache],
                   cfg: ModelConfig):
    """One decode step.  token (B,) int, pos a Python int or a 0-d
    integer tensor.  Writes each layer's new K and V into `caches` in
    place; returns (logits (B, vocab) float32, caches)."""
    _, norm = _norm_fns(cfg)
    blocks = params["blocks"]
    if len(caches) != len(blocks):
        raise ValueError(f"{len(caches)} caches for {len(blocks)} layers")
    x = _embed(params, token[:, None], cfg)  # (B, 1, d)
    pos = _as_pos(pos, x.device)  # one fill, not one per layer
    for i, bp in enumerate(blocks):
        x, caches[i] = _decode_block(bp, bp.bd, x, caches[i], pos, cfg)
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
