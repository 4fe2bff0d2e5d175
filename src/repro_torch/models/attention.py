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
from repro_torch.sharding.hints import (cache_split, head_split, row_split,
                                        write_slot)

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
             cap, scale, q_offset=0):
    """One query chunk against every live kv chunk.
    qi: (B, qc, KV, G, D); kc, vc: (B, nk, kc, KV, D); the chunk's
    first query at position q_offset + iq * q_chunk.
    Returns (B, qc, KV, G, D) float32."""
    b, _, kvh, g, d = qi.shape
    dev = qi.device
    m = torch.full((b, kvh, g, q_chunk), NEG, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((b, kvh, g, q_chunk), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, kvh, g, q_chunk, d), dtype=torch.float32,
                      device=dev)
    q_lo = q_offset + iq * q_chunk
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
                    q_chunk: int = 512, kv_chunk: int = 1024,
                    q_offset: int = 0):
    """Online-softmax attention.

    q: (B, Sq, KV, G, D); k, v: (B, Sk, KV, D).  Returns
    (B, Sq, KV, G, D) in q's dtype.  Query i sits at position
    q_offset + i (the reference's `q_offset`), key j at j.
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
                window=window, cap=cap, scale=scale, q_offset=q_offset)
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
    head h reads KV head h // G (the reference's kv-major order).  On
    a mesh whose "model" axis splits the heads
    (`sharding/hints.py::head_split`), each rank attends with its own
    query heads and the KV heads they read (`_attend_local`); where the
    heads do not split over it, with two blocks of its query rows
    (`row_split`, `_attend_rows`).
    """
    b, s, _ = x.shape
    cross = kv_x is not None
    kv_x = x if kv_x is None else kv_x
    sk = kv_x.shape[1]
    hd, h, kvh = cfg.head_dim, cfg.n_heads, cfg.n_kv
    g = cfg.q_per_kv
    cd = cfg.cdtype

    q = dense(params["wq"], x, cd)
    k = dense(params["wk"], kv_x, cd)
    v = dense(params["wv"], kv_x, cd)
    opts = dict(causal=causal, window=window, cap=cfg.attn_softcap,
                scale=cfg.attn_scale, q_chunk=cfg.q_chunk,
                kv_chunk=cfg.kv_chunk)
    split = head_split(q, h, kvh)
    if split is not None:
        out, kv = _attend_local(split, q, k, v, cfg, cross, positions,
                                opts)
        return dense(params["wo"], out, cd), kv
    rows = row_split(q, s, cfg.q_chunk)
    if rows is not None:
        return _attend_rows(rows, params, q, k, v, cfg, cross, positions,
                            opts)

    q = q.reshape(b, s, kvh, g, hd)
    k = k.reshape(b, sk, kvh, hd)
    v = v.reshape(b, sk, kvh, hd)
    if not cross:
        if positions is None:
            positions = torch.arange(s, device=x.device)
        q = rope(q.reshape(b, s, kvh * g, hd), positions[None],
                 cfg.rope_theta).reshape(b, s, kvh, g, hd)
        k = rope(k, torch.arange(sk, device=x.device)[None],
                 cfg.rope_theta)

    out = flash_attention(q, k, v, **opts)
    out = out.reshape(b, s, h * hd)
    return dense(params["wo"], out, cd), (k, v)


def _attend_local(split, q, k, v, cfg, cross, positions, opts):
    """`attend_train`'s attention on this rank's heads: q (B, S, h *
    hd) and K, V (B, Sk, kvh * hd) DTensors.  Returns the output (B, S,
    h * hd) split over "model" like q, and this rank's K and V heads
    (B_l, Sk, kv_l, hd), local tensors."""
    b, s, _ = q.shape
    sk = k.shape[1]
    hd, kvh = cfg.head_dim, cfg.n_kv
    ql = split.local(q)
    bl = ql.shape[0]
    ql = ql.reshape(bl, s, split.n, hd)
    kl = split.local(k, kv=True).reshape(bl, sk, kvh, hd)[:, :, split.kv]
    vl = split.local(v, kv=True).reshape(bl, sk, kvh, hd)[:, :, split.kv]
    if not cross:
        if positions is None:
            positions = torch.arange(s, device=ql.device)
        ql = rope(ql, positions[None], cfg.rope_theta)
        kl = rope(kl, torch.arange(sk, device=ql.device)[None],
                  cfg.rope_theta)
    kv_l = kl.shape[2]
    out = flash_attention(ql.reshape(bl, s, kv_l, split.n // kv_l, hd),
                          kl, vl, **opts)
    return split.wrap(out.reshape(bl, s, split.n * hd),
                      (b, s, q.shape[2])), (kl, vl)


def _attend_rows(rows, params, q, k, v, cfg, cross, positions, opts):
    """`attend_train` on this rank's two blocks of query rows
    (`sharding/hints.py::row_split`: the heads do not split over
    "model"), every head, the output projection on those rows; q (B, S,
    h * hd) and K, V (B, Sk, kvh * hd) DTensors.  Returns (out, (k,
    v)): out (B, S, d) a DTensor batch split as q, whole over "model";
    k, v this rank's whole K and V (B_l, Sk, kvh, hd), local tensors."""
    b, s, _ = q.shape
    sk = k.shape[1]
    hd, h, kvh, g = cfg.head_dim, cfg.n_heads, cfg.n_kv, cfg.q_per_kv
    cd = cfg.cdtype
    ql, kl, vl = rows.local(q), rows.local(k), rows.local(v)
    bl = ql.shape[0]
    kl = kl.reshape(bl, sk, kvh, hd)
    vl = vl.reshape(bl, sk, kvh, hd)
    if not cross:
        if positions is None:
            positions = torch.arange(s, device=ql.device)
        kl = rope(kl, torch.arange(sk, device=ql.device)[None],
                  cfg.rope_theta)
    wo = rows.weight(params["wo"]["w"].to(cd))
    outs = []
    for lo, hi in rows.blocks:
        qb = ql[:, lo:hi].reshape(bl, hi - lo, h, hd)
        if not cross:
            qb = rope(qb, positions[None, lo:hi], cfg.rope_theta)
        ob = flash_attention(qb.reshape(bl, hi - lo, kvh, g, hd), kl, vl,
                             **dict(opts, q_offset=lo))
        outs.append(ob.reshape(bl, hi - lo, h * hd).to(cd) @ wo)
    return rows.wrap(outs, (b, s, wo.shape[1])), (kl, vl)


def decode_attention(params, x, cache: KVCache, pos, cfg, *,
                     window=None, cross: bool = False, ring: bool = False):
    """One-token decode.  x: (B, 1, d); cache holds S past positions.

    Returns (out (B, 1, d), cache).  `pos` is this token's position, a
    Python int or a 0-d integer tensor.  Self-attention writes the new
    K and V into slot `pos` of the cache, in place.  Cross attention
    reads the cache without update or RoPE.  `ring=True` treats the
    cache as a rolling window buffer (S == window): the new K and V
    overwrite slot pos % S and every slot is attendable, zeros included
    until the buffer is warm, as in the reference.  A DTensor cache on a
    mesh with a "model" axis is read where it lies, on each rank's own
    shard (`sharding/hints.py::cache_split`).
    """
    b = x.shape[0]
    hd, h, kvh, g = cfg.head_dim, cfg.n_heads, cfg.n_kv, cfg.q_per_kv
    cd = cfg.cdtype
    s = cache.k.shape[1]
    pos = _as_pos(pos, x.device)
    split = cache_split(cache.k)
    local = split.local if split is not None else (lambda t: t)
    scale = hd ** -0.5 if cfg.attn_scale is None else cfg.attn_scale

    q = local(dense(params["wq"], x, cd))
    bl = q.shape[0]
    q = q.reshape(bl, 1, kvh * g, hd)
    if not cross:
        where = pos.reshape(1, 1)
        q = rope(q, where, cfg.rope_theta)
        k_new = local(dense(params["wk"], x, cd)).reshape(bl, 1, kvh, hd)
        k_new = rope(k_new, where, cfg.rope_theta)
        v_new = local(dense(params["wv"], x, cd)).reshape(bl, 1, kvh, hd)
        slot = (pos % s if ring else pos).reshape(1)
        for c, new in ((cache.k, k_new), (cache.v, v_new)):
            new = new.to(c.dtype)
            if split is not None:
                new = split.wrap(new, (b, 1, kvh, hd))
            write_slot(c, slot, new)

    q = q.reshape(bl, kvh, g, hd)
    ck, cv = cache.k, cache.v
    if split is not None:
        q = q[:, split.kv, :, split.d]
        ck, cv = ck.to_local(), cv.to_local()
    # compute-dtype operands, float32 products and sums (bf16 upcasts
    # exactly)
    s_log = torch.einsum("bkgd,bskd->bkgs", q.float(),
                         ck.to(cd).float()) * scale
    if split is not None:  # summed over D's split, whole along S
        s_log = split.scores(s_log, (b, kvh, g, s))
    s_log = softcap(s_log, cfg.attn_softcap)
    if not (cross or ring):  # ring: every slot is attendable
        k_pos = torch.arange(s, device=x.device)
        ok = k_pos <= pos
        if window is not None:
            ok &= pos - k_pos < window
        s_log = torch.where(ok, s_log, NEG)
    p = torch.softmax(s_log, dim=-1)
    if split is not None:
        p = p[..., split.s]
    out = torch.einsum("bkgs,bskd->bkgd", p.to(cd).float(),
                       cv.to(cd).float())
    if split is not None:  # summed over S's split, whole heads
        out = split.values(out, (b, kvh, g, hd))
    out = out.reshape(bl, 1, h * hd).to(cd)
    if split is not None:
        out = split.wrap(out, (b, 1, h * hd))
    return dense(params["wo"], out, cd), cache


def _as_pos(pos, device) -> torch.Tensor:
    """`pos` as a 0-d int64 tensor on `device`.  A Python int becomes a
    device fill, not a host-to-device copy (which would wait for the
    device)."""
    if isinstance(pos, torch.Tensor):
        return pos.to(device=device, dtype=torch.int64).reshape(())
    return torch.full((), int(pos), dtype=torch.int64, device=device)
