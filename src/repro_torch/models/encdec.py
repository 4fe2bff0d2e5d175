"""Encoder-decoder transformer (the seamless-m4t backbone), as the
reference's `models/encdec.py`.

The modality frontend is a stub: the encoder consumes precomputed frame
embeddings (B, S_src, d).  Encoder blocks are bidirectional
self-attention + MLP; decoder blocks are causal self-attention +
cross-attention + MLP.  `EncDec.enc_blocks` and `EncDec.dec_blocks` hold
one module per layer where the reference stacks them on a leading (L,)
axis (`models/convert.py` carries trees across).

Each encoder and decoder block starts with
`sharding/hints.py::maybe_shard(x, "residual")`, where the reference
constrains the residual (a no-op without activation hints).

Decode keeps, per decoder layer, a self-attention `KVCache` written in
place and a cross-attention `KVCache` built once from the encoder's
output: `{"self": [KVCache] * L, "cross": [KVCache] * L}`.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models.attention import (KVCache, _as_pos, attend_train,
                                          attention_init, decode_attention)
from repro_torch.models.common import ModelConfig, vocab_padded
from repro_torch.models.layers import (Params, dense, embed, embedding_init,
                                       unembed)
from repro_torch.models.mlp import mlp, mlp_init
from repro_torch.models.transformer import _norm_fns, chunked_ce
from repro_torch.sharding.hints import maybe_shard

__all__ = ["EncDec", "init_encdec_params", "encode", "decode_train",
           "encdec_loss", "init_encdec_cache", "build_cross_cache",
           "encdec_decode_step"]


def _enc_block_init(gen, cfg, device) -> Params:
    ninit, _ = _norm_fns(cfg)
    d, pd = cfg.d_model, cfg.pdtype
    p = Params()
    p.ln1 = ninit(d, pd, device)
    p.attn = attention_init(gen, cfg, device=device)
    p.ln2 = ninit(d, pd, device)
    p.mlp = mlp_init(gen, d, cfg.d_ff, pd, cfg.mlp_gated, device=device)
    return p


def _dec_block_init(gen, cfg, device) -> Params:
    ninit, _ = _norm_fns(cfg)
    d, pd = cfg.d_model, cfg.pdtype
    p = Params()
    p.ln1 = ninit(d, pd, device)
    p.self_attn = attention_init(gen, cfg, device=device)
    p.ln_x = ninit(d, pd, device)
    p.cross_attn = attention_init(gen, cfg, device=device)
    p.ln2 = ninit(d, pd, device)
    p.mlp = mlp_init(gen, d, cfg.d_ff, pd, cfg.mlp_gated, device=device)
    return p


class EncDec(Params):
    """The encoder-decoder's parameters: `embed` (tied read-out),
    `enc_blocks`, `dec_blocks` (one module per layer), `enc_norm` and
    `final_norm`."""

    def __init__(self, cfg: ModelConfig, gen=None, device=None):
        super().__init__()
        ninit, _ = _norm_fns(cfg)
        self.cfg = cfg
        self.embed = embedding_init(gen, vocab_padded(cfg), cfg.d_model,
                                    cfg.pdtype, device)
        self.enc_blocks = nn.ModuleList(_enc_block_init(gen, cfg, device)
                                        for _ in range(cfg.enc_layers))
        self.dec_blocks = nn.ModuleList(_dec_block_init(gen, cfg, device)
                                        for _ in range(cfg.dec_layers))
        self.enc_norm = ninit(cfg.d_model, cfg.pdtype, device)
        self.final_norm = ninit(cfg.d_model, cfg.pdtype, device)


def init_encdec_params(seed: int, cfg: ModelConfig, device=None) -> EncDec:
    """A randomly initialised `EncDec` on `device` (the card unless the
    caller names another), drawn from a CPU generator seeded with
    `seed`."""
    from repro_torch.engine.engine import resolve_device
    gen = torch.Generator().manual_seed(int(seed))
    return EncDec(cfg, gen=gen, device=resolve_device(device))


def _stack(body, x, blocks, cfg, *extra):
    """`body(x, block, *extra)` over the blocks, each checkpointed when
    `cfg.remat` (the reference's "nothing" policy) under autograd."""
    remat = cfg.remat and torch.is_grad_enabled()
    for bp in blocks:
        x = (checkpoint(body, x, bp, cfg, *extra, use_reentrant=False)
             if remat else body(x, bp, cfg, *extra))
    return x


def _enc_body(x, bp, cfg):
    _, norm = _norm_fns(cfg)
    x = maybe_shard(x, "residual")
    h = norm(bp["ln1"], x, cfg.norm_eps)
    h, _ = attend_train(bp["attn"], h, cfg, causal=False)
    x = x + h
    h = norm(bp["ln2"], x, cfg.norm_eps)
    return x + mlp(bp["mlp"], h, cfg.cdtype, cfg.mlp_act)


def encode(params: EncDec, src_emb, cfg: ModelConfig):
    """src_emb (B, Ss, d) -> encoder output (B, Ss, d)."""
    _, norm = _norm_fns(cfg)
    x = _stack(_enc_body, src_emb.to(cfg.cdtype), params["enc_blocks"], cfg)
    return norm(params["enc_norm"], x, cfg.norm_eps)


def _dec_body(x, bp, cfg, enc_out):
    _, norm = _norm_fns(cfg)
    x = maybe_shard(x, "residual")
    h = norm(bp["ln1"], x, cfg.norm_eps)
    h, _ = attend_train(bp["self_attn"], h, cfg, causal=True)
    x = x + h
    h = norm(bp["ln_x"], x, cfg.norm_eps)
    h, _ = attend_train(bp["cross_attn"], h, cfg, causal=False,
                        kv_x=enc_out)
    x = x + h
    h = norm(bp["ln2"], x, cfg.norm_eps)
    return x + mlp(bp["mlp"], h, cfg.cdtype, cfg.mlp_act)


def decode_train(params: EncDec, enc_out, tgt_tokens, cfg: ModelConfig,
                 return_hidden: bool = False):
    """Teacher-forced decoder.  tgt_tokens (B, St) -> logits (B, St,
    vocab_padded) float32, or the final-norm hidden when
    `return_hidden`."""
    _, norm = _norm_fns(cfg)
    x = embed(params["embed"], tgt_tokens, cfg.cdtype)
    x = _stack(_dec_body, x, params["dec_blocks"], cfg, enc_out)
    x = norm(params["final_norm"], x, cfg.norm_eps)
    if return_hidden:
        return x
    return unembed(params["embed"], x, cfg.vocab)


def encdec_loss(params: EncDec, batch, cfg: ModelConfig):
    """batch: {src_emb (B, Ss, d), tokens (B, St + 1)} -> (loss,
    metrics).  Chunked CE over the tied read-out."""
    tokens = batch["tokens"].long()
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    enc_out = encode(params, batch["src_emb"], cfg)
    x = decode_train(params, enc_out, inp, cfg, return_hidden=True)
    ce = chunked_ce(lambda h: unembed(params["embed"], h, cfg.vocab),
                    x, tgt, cfg.ce_chunk)
    return ce, {"ce": ce, "aux": torch.zeros((), device=ce.device),
                "ppl_proxy": torch.exp(torch.clamp(ce, max=20.0))}


# ---------------------------------------------------------------- decode --
def init_encdec_cache(cfg: ModelConfig, batch: int, max_tgt: int,
                      src_len: int, dtype=torch.bfloat16, device=None):
    """Zeroed {"self": [KVCache], "cross": [KVCache]}, one of each per
    decoder layer: self (batch, max_tgt, KV, D), cross (batch, src_len,
    KV, D), on `device` (the card unless the caller names another)."""
    from repro_torch.engine.engine import resolve_device
    dev = resolve_device(device)

    def kv(s):
        shape = (batch, s, cfg.n_kv, cfg.head_dim)
        return KVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                       v=torch.zeros(shape, dtype=dtype, device=dev))

    return {"self": [kv(max_tgt) for _ in range(cfg.dec_layers)],
            "cross": [kv(src_len) for _ in range(cfg.dec_layers)]}


def build_cross_cache(params: EncDec, enc_out, cfg: ModelConfig,
                      dtype=torch.bfloat16):
    """Each decoder layer's cross-attention K and V of the encoder's
    output, (B, Ss, KV, D) in `dtype`: the "cross" list."""
    b, ss, _ = enc_out.shape

    def one(bp):
        k = dense(bp["cross_attn"]["wk"], enc_out, cfg.cdtype)
        v = dense(bp["cross_attn"]["wv"], enc_out, cfg.cdtype)
        return KVCache(
            k=k.reshape(b, ss, cfg.n_kv, cfg.head_dim).to(dtype),
            v=v.reshape(b, ss, cfg.n_kv, cfg.head_dim).to(dtype))

    return [one(bp) for bp in params["dec_blocks"]]


def encdec_decode_step(params: EncDec, token, pos, caches,
                       cfg: ModelConfig):
    """token (B,), pos a Python int or a 0-d integer tensor; caches
    {"self": [KVCache], "cross": [KVCache]}.  Writes each layer's new
    self-attention K and V in place; returns (logits (B, vocab_padded)
    float32, caches)."""
    _, norm = _norm_fns(cfg)
    x = embed(params["embed"], token[:, None], cfg.cdtype)
    pos = _as_pos(pos, x.device)
    for bp, selfc, crossc in zip(params["dec_blocks"], caches["self"],
                                 caches["cross"]):
        h = norm(bp["ln1"], x, cfg.norm_eps)
        h, _ = decode_attention(bp["self_attn"], h, selfc, pos, cfg)
        x = x + h
        h = norm(bp["ln_x"], x, cfg.norm_eps)
        h, _ = decode_attention(bp["cross_attn"], h, crossc, pos, cfg,
                                cross=True)
        x = x + h
        h = norm(bp["ln2"], x, cfg.norm_eps)
        x = x + mlp(bp["mlp"], h, cfg.cdtype, cfg.mlp_act)
    x = norm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params["embed"], x, cfg.vocab)[:, 0], caches
