"""GQA attention: the flash-style chunked training path and the cached
one-token decode path.

Covers every variant: grouped KV heads, RoPE, QKV bias (qwen2),
attention-logit softcap (gemma2), sliding window (mixtral, starcoder2),
local/global alternation (gemma2, chosen per block by the caller) and
non-causal and cross attention (the seamless encoder-decoder: K and V
from the encoder's output, S_q and S_k apart, no RoPE).

The training path is the reference's online-softmax (flash) algorithm in
plain PyTorch: a loop over query chunks x kv chunks keeps the working
set at O(q_chunk * kv_chunk), and kv chunks wholly in the future of a
query chunk (or wholly behind its window) are skipped.  Scores, the
running max and sum and the accumulator are float32; P is cast to V's
dtype before P @ V, as the reference does.  Each query chunk of a
multi-chunk call is checkpointed, so its probabilities are recomputed
in the backward instead of being kept for every chunk.

The decode path (`decode_attention`) reads a `KVCache` of S past
positions and writes the new token's K and V into it in place (the
reference returns an updated copy of a donated buffer; the values are
the same; a DTensor cache is written shard by shard,
`sharding/hints.py::write_slot`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import (Params, dense, dense_init, rope,
                                       softcap)
from repro_torch.sharding.hints import write_slot

NEG = -1e30

__all__ = ["NEG", "KVCache", "attention_init", "flash_attention",
           "attend_train", "decode_attention"]


def attention_init(gen, cfg, d_model: Optional[int] = None,
                   device=None) -> Params:
    d = d_model or cfg.d_model
    hd, h, kv = cfg.head_dim, cfg.n_heads, cfg.n_kv
    p = Params()
    p.wq = dense_init(gen, d, h * hd, cfg.qkv_bias, cfg.pdtype,
                      device=device)
    p.wk = dense_init(gen, d, kv * hd, cfg.qkv_bias, cfg.pdtype,
                      device=device)
    p.wv = dense_init(gen, d, kv * hd, cfg.qkv_bias, cfg.pdtype,
                      device=device)
    p.wo = dense_init(gen, h * hd, d, False, cfg.pdtype,
                      scale=(h * hd) ** -0.5, device=device)
    return p


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S, KV, D)
    v: torch.Tensor  # (B, S, KV, D)


def _mask(q_pos, k_pos, causal: bool, window: Optional[int]):
    """(Sq, Sk) bool; True = attend."""
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        ok &= q_pos[:, None] - k_pos[None, :] < window
    return ok


def _q_chunk(qi, kc, vc, iq: int, *, q_chunk, kv_chunk, causal, window,
             cap, scale):
    """One query chunk against every live kv chunk.
    qi: (B, qc, KV, G, D); kc, vc: (B, nk, kc, KV, D).
    Returns (B, qc, KV, G, D) float32."""
    b, _, kvh, g, d = qi.shape
    dev = qi.device
    m = torch.full((b, kvh, g, q_chunk), NEG, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((b, kvh, g, q_chunk), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, kvh, g, q_chunk, d), dtype=torch.float32,
                      device=dev)
    q_lo = iq * q_chunk
    q_pos = q_lo + torch.arange(q_chunk, device=dev)
    qf = qi.float()  # bf16 products are exact in float32
    for j in range(kc.shape[1]):
        if causal:
            # whole kv chunk in the future of the whole q chunk -> skip
            live = j * kv_chunk <= q_lo + q_chunk - 1
            if window is not None:
                live &= (j + 1) * kv_chunk - 1 >= q_lo - window + 1
            if not live:
                continue
        kj, vj = kc[:, j], vc[:, j]  # (B, kc, KV, D)
        s = torch.einsum("bqkgd,bckd->bkgqc", qf, kj.float()) * scale
        s = softcap(s, cap)
        k_pos = j * kv_chunk + torch.arange(kv_chunk, device=dev)
        msk = _mask(q_pos, k_pos, causal, window)  # (qc, kc)
        s = torch.where(msk, s, NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        p = torch.where(msk, p, 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqc,bckd->bkgqd", p.to(vj.dtype).float(), vj.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]  # (B, KV, G, qc, D)
    return out.permute(0, 3, 1, 2, 4)


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    cap: Optional[float] = None,
                    scale: Optional[float] = None,
                    q_chunk: int = 512, kv_chunk: int = 1024):
    """Online-softmax attention.

    q: (B, Sq, KV, G, D); k, v: (B, Sk, KV, D).  Returns
    (B, Sq, KV, G, D) in q's dtype.  Query i sits at position i.
    """
    b, sq, kvh, g, d = q.shape
    sk = k.shape[1]
    scale = d ** -0.5 if scale is None else scale
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, sk)
    nq, nk = sq // q_chunk, sk // kv_chunk
    if sq % q_chunk or sk % kv_chunk:
        raise ValueError(f"sequence lengths ({sq}, {sk}) must divide into "
                         f"chunks ({q_chunk}, {kv_chunk})")
    kc = k.reshape(b, nk, kv_chunk, kvh, d)
    vc = v.reshape(b, nk, kv_chunk, kvh, d)
    opts = dict(q_chunk=q_chunk, kv_chunk=kv_chunk, causal=causal,
                window=window, cap=cap, scale=scale)
    if nq == 1 and nk == 1:
        out = _q_chunk(q, kc, vc, 0, **opts)
        return out.to(q.dtype)
    recompute = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    outs = []
    for iq in range(nq):
        qi = q[:, iq * q_chunk:(iq + 1) * q_chunk]
        if recompute:
            # flash backward: recompute this chunk's probabilities
            outs.append(checkpoint(_q_chunk, qi, kc, vc, iq,
                                   use_reentrant=False, **opts))
        else:
            outs.append(_q_chunk(qi, kc, vc, iq, **opts))
    return torch.cat(outs, dim=1).to(q.dtype)


def attend_train(params, x, cfg, *, causal=True, window=None,
                 kv_x: Optional[torch.Tensor] = None, positions=None):
    """Full attention sub-layer for training.

    x: (B, S, d).  kv_x: the source of K and V (cross attention, no
    RoPE); x itself when None (self-attention, causal or not, with
    RoPE).  Returns (out (B, S, d), (k, v) of this segment).  Query
    head h reads KV head h // G (the reference's kv-major order).
    """
    b, s, _ = x.shape
    cross = kv_x is not None
    kv_x = x if kv_x is None else kv_x
    sk = kv_x.shape[1]
    hd, h, kvh = cfg.head_dim, cfg.n_heads, cfg.n_kv
    g = cfg.q_per_kv
    cd = cfg.cdtype

    q = dense(params["wq"], x, cd).reshape(b, s, kvh, g, hd)
    k = dense(params["wk"], kv_x, cd).reshape(b, sk, kvh, hd)
    v = dense(params["wv"], kv_x, cd).reshape(b, sk, kvh, hd)

    if not cross:
        if positions is None:
            positions = torch.arange(s, device=x.device)
        q = rope(q.reshape(b, s, kvh * g, hd), positions[None],
                 cfg.rope_theta).reshape(b, s, kvh, g, hd)
        k = rope(k, torch.arange(sk, device=x.device)[None],
                 cfg.rope_theta)

    out = flash_attention(
        q, k, v, causal=causal, window=window, cap=cfg.attn_softcap,
        scale=cfg.attn_scale, q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    out = out.reshape(b, s, h * hd)
    return dense(params["wo"], out, cd), (k, v)


def decode_attention(params, x, cache: KVCache, pos, cfg, *,
                     window=None, cross: bool = False, ring: bool = False):
    """One-token decode.  x: (B, 1, d); cache holds S past positions.

    Returns (out (B, 1, d), cache).  `pos` is this token's position, a
    Python int or a 0-d integer tensor.  Self-attention writes the new
    K and V into slot `pos` of the cache, in place.  Cross attention
    reads the cache without update or RoPE.  `ring=True` treats the
    cache as a rolling window buffer (S == window): the new K and V
    overwrite slot pos % S and every slot is attendable, zeros included
    until the buffer is warm, as in the reference.
    """
    b = x.shape[0]
    hd, h, kvh, g = cfg.head_dim, cfg.n_heads, cfg.n_kv, cfg.q_per_kv
    cd = cfg.cdtype
    s = cache.k.shape[1]
    pos = _as_pos(pos, x.device)

    q = dense(params["wq"], x, cd).reshape(b, 1, kvh * g, hd)
    if not cross:
        where = pos.reshape(1, 1)
        q = rope(q, where, cfg.rope_theta)
        k_new = dense(params["wk"], x, cd).reshape(b, 1, kvh, hd)
        k_new = rope(k_new, where, cfg.rope_theta)
        v_new = dense(params["wv"], x, cd).reshape(b, 1, kvh, hd)
        slot = (pos % s if ring else pos).reshape(1)
        write_slot(cache.k, slot, k_new.to(cache.k.dtype))
        write_slot(cache.v, slot, v_new.to(cache.v.dtype))

    q = q.reshape(b, kvh, g, hd)
    scale = hd ** -0.5 if cfg.attn_scale is None else cfg.attn_scale
    # compute-dtype operands, float32 products and sums (bf16 upcasts
    # exactly)
    s_log = torch.einsum("bkgd,bskd->bkgs", q.float(),
                         cache.k.to(cd).float()) * scale
    s_log = softcap(s_log, cfg.attn_softcap)
    if not (cross or ring):  # ring: every slot is attendable
        k_pos = torch.arange(s, device=x.device)
        ok = k_pos <= pos
        if window is not None:
            ok &= pos - k_pos < window
        s_log = torch.where(ok, s_log, NEG)
    p = torch.softmax(s_log, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(cd).float(),
                       cache.v.to(cd).float())
    out = out.reshape(b, 1, h * hd).to(cd)
    return dense(params["wo"], out, cd), cache


def _as_pos(pos, device) -> torch.Tensor:
    """`pos` as a 0-d int64 tensor on `device`.  A Python int becomes a
    device fill, not a host-to-device copy (which would wait for the
    device)."""
    if isinstance(pos, torch.Tensor):
        return pos.to(device=device, dtype=torch.int64).reshape(())
    return torch.full((), int(pos), dtype=torch.int64, device=device)
