"""xLSTM blocks (arXiv:2405.04517), as the reference's `models/xlstm.py`:
the chunkwise-parallel mLSTM and the sequential sLSTM.

mLSTM is a matrix-memory linear-attention variant with exponential input
gates and sigmoid forget gates, in the log-space stabilized chunkwise
form: intra-chunk masked-decay matmuls, the inter-chunk state (C (P, P),
n (P), log scale m) carried by a loop over chunks.  Decode is one
stabilized recurrence step.  sLSTM keeps per-head scalar memories with
a hidden-state recurrence (R h_{t-1}), a loop over time.

bfloat16 operands are upcast and their products summed in float32 where
the reference asks for `preferred_element_type=jnp.float32`.  The
intra-chunk scores are masked before `exp`, where the reference masks
after it: the forward is the same, and the gradients too wherever the
reference's stay finite (an exp over the masked half that overflows
turns all of its gradients NaN; `models/ssm.py`, ROADMAP.md queue 3).
Decode caches are float32 and written in place.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.nn import functional as F

from repro_torch.models.layers import (Params, dense, dense_init, param,
                                       rmsnorm, rmsnorm_init)
from repro_torch.models.ssm import CONV_W, causal_conv
from repro_torch.sharding.hints import elementwise

__all__ = ["MLSTMCache", "mlstm_dims", "mlstm_init", "mlstm_forward",
           "mlstm_cache_init", "mlstm_decode_step", "SLSTMCache",
           "slstm_init", "slstm_forward", "slstm_cache_init",
           "slstm_decode_step"]

M0 = -1e30  # the log scale of an empty memory


# ============================================================== mLSTM ====
class MLSTMCache(NamedTuple):
    c: torch.Tensor      # (B, H, P, P) stabilized matrix memory
    n: torch.Tensor      # (B, H, P) stabilized normalizer
    m: torch.Tensor      # (B, H) log scale
    conv: torch.Tensor   # (B, CONV_W-1, d_in)


def mlstm_dims(cfg, d=None):
    d = d or cfg.d_model
    d_in = int(cfg.mlstm_proj_factor * d)
    h = cfg.n_heads
    return d, d_in, h, d_in // h


def mlstm_init(gen, cfg, d=None, device=None) -> Params:
    d, d_in, h, p = mlstm_dims(cfg, d)
    pd = cfg.pdtype
    ps = Params()
    ps.wup = dense_init(gen, d, 2 * d_in, False, pd, device=device)
    ps.conv = param((CONV_W, d_in), pd, device, gen, scale=0.1)
    ps.wq = dense_init(gen, d_in, d_in, False, pd, device=device)
    ps.wk = dense_init(gen, d_in, d_in, False, pd,
                       scale=(d_in ** -0.5) * (p ** -0.25), device=device)
    ps.wv = dense_init(gen, d_in, d_in, False, pd, device=device)
    ps.wif = dense_init(gen, d_in, 2 * h, True, pd, device=device)
    ps.norm = rmsnorm_init(d_in, pd, device)
    ps.wdown = dense_init(gen, d_in, d, False, pd, scale=d_in ** -0.5,
                          device=device)
    return ps


def _mlstm_proj(params, x, cfg, d):
    d, d_in, h, p = mlstm_dims(cfg, d)
    up = dense(params["wup"], x, cfg.cdtype)
    return up[..., :d_in], up[..., d_in:], (d_in, h, p)


def mlstm_forward(params, x, cfg, d=None):
    """Chunkwise-parallel training path.  x (B, T, d) -> (B, T, d); the
    chunk (min(ssm_chunk, T)) must divide T."""
    b, t, _ = x.shape
    cd = cfg.cdtype
    xm, z, (d_in, h, p) = _mlstm_proj(params, x, cfg, d)
    xc, _ = causal_conv(params["conv"].to(cd), xm)

    q = dense(params["wq"], xc, cd).reshape(b, t, h, p)
    k = dense(params["wk"], xc, cd).reshape(b, t, h, p)
    v = dense(params["wv"], xm, cd).reshape(b, t, h, p)
    gates = dense(params["wif"], xc, cd).float()
    li = gates[..., :h]                  # log input gate (exp gate)
    lf = elementwise(F.logsigmoid, gates[..., h:])  # log forget gate

    qch = min(cfg.ssm_chunk, t)
    if t % qch:
        raise ValueError(f"sequence length {t} does not divide into "
                         f"chunks of {qch}")
    nc = t // qch

    def chunks(a):  # (B, T, ...) -> (B, nc, q, ...)
        return a.reshape(b, nc, qch, *a.shape[2:])

    qc, kc, vc, lic, lfc = (chunks(a) for a in (q, k, v, li, lf))
    tri = torch.tril(torch.ones((qch, qch), dtype=torch.bool,
                                device=x.device))
    ct = x.new_zeros((b, h, p, p), dtype=torch.float32)
    nt = x.new_zeros((b, h, p), dtype=torch.float32)
    mc = x.new_full((b, h), M0, dtype=torch.float32)
    ys = []
    for c in range(nc):
        qi, ki, vi, lii, lfi = (a[:, c] for a in (qc, kc, vc, lic, lfc))
        qf, kf, vf = qi.float(), ki.float(), vi.float()
        cum = torch.cumsum(lfi, dim=1)           # (b, q, h)
        g = lii - cum                            # g_s = li_s - cum_s
        m_row = torch.cummax(g, dim=1).values    # (b, q, h)
        stab = torch.maximum(m_row, mc[:, None])  # per-row stabilizer
        # intra-chunk scores
        # masked before exp, as in `ssm.py` (ROADMAP.md queue 3)
        sc = torch.exp(torch.where(tri[None, :, :, None],
                                   g[:, None] - stab[:, :, None],
                                   -torch.inf))  # (b, t, s, h)
        w_ts = sc * torch.einsum("bthp,bshp->btsh", qf, kf)
        num = torch.einsum("btsh,bshp->bthp", w_ts.to(cd).float(), vf)
        den = w_ts.sum(dim=2)  # (b, t, h)
        # inter-chunk (the carried state, scale mc)
        lam = torch.exp(mc[:, None] - stab)  # (b, q, h)
        num = num + lam[..., None] * torch.einsum("bthp,bhpr->bthr", qf, ct)
        den = den + lam * torch.einsum("bthp,bhp->bth", qf, nt)
        hmax = torch.maximum(den.abs(), torch.exp(-(cum + stab)))
        ys.append(num / hmax[..., None])
        # ---- state update ------------------------------------------------
        cum_last = cum[:, -1]  # (b, h)
        m_new = cum_last + torch.maximum(mc, m_row[:, -1])
        scale_old = torch.exp(mc + cum_last - m_new)  # (b, h)
        w_s = torch.exp(cum_last[:, None] + g - m_new[:, None])  # (b, q, h)
        ct = (ct * scale_old[..., None, None]
              + torch.einsum("bsh,bshp,bshr->bhpr", w_s, kf, vf))
        nt = (nt * scale_old[..., None]
              + torch.einsum("bsh,bshp->bhp", w_s, kf))
        mc = m_new
    y = torch.cat(ys, dim=1).reshape(b, t, d_in).to(cd)
    y = rmsnorm(params["norm"], y, cfg.norm_eps)
    y = y * F.silu(z)
    return dense(params["wdown"], y, cd)


def mlstm_cache_init(cfg, batch, d=None, dtype=torch.float32,
                     device=None) -> MLSTMCache:
    d, d_in, h, p = mlstm_dims(cfg, d)
    return MLSTMCache(
        c=torch.zeros((batch, h, p, p), dtype=dtype, device=device),
        n=torch.zeros((batch, h, p), dtype=dtype, device=device),
        m=torch.full((batch, h), M0, dtype=dtype, device=device),
        conv=torch.zeros((batch, CONV_W - 1, d_in), dtype=dtype,
                         device=device))


def mlstm_decode_step(params, x, cache: MLSTMCache, cfg, d=None):
    """The stabilized single-step recurrence.  x (B, 1, d) -> ((B, 1, d),
    cache), the cache written in place."""
    b = x.shape[0]
    cd = cfg.cdtype
    xm, z, (d_in, h, p) = _mlstm_proj(params, x, cfg, d)
    xc, conv_new = causal_conv(params["conv"].to(cd), xm, cache.conv)

    q = dense(params["wq"], xc, cd).reshape(b, h, p).float()
    k = dense(params["wk"], xc, cd).reshape(b, h, p).float()
    v = dense(params["wv"], xm, cd).reshape(b, h, p).float()
    gates = dense(params["wif"], xc, cd).float()[:, 0]
    li, lf = gates[..., :h], elementwise(F.logsigmoid, gates[..., h:])

    m_new = torch.maximum(lf + cache.m, li)
    a = torch.exp(lf + cache.m - m_new)
    bgt = torch.exp(li - m_new)
    c_new = (cache.c * a[..., None, None]
             + bgt[..., None, None] * torch.einsum("bhp,bhr->bhpr", k, v))
    n_new = cache.n * a[..., None] + bgt[..., None] * k
    num = torch.einsum("bhp,bhpr->bhr", q, c_new)
    den = torch.maximum(torch.einsum("bhp,bhp->bh", q, n_new).abs(),
                        torch.exp(-m_new))
    y = (num / den[..., None]).reshape(b, 1, d_in).to(cd)
    y = rmsnorm(params["norm"], y, cfg.norm_eps) * F.silu(z)
    for dst, src in zip(cache, (c_new, n_new, m_new, conv_new)):
        dst.copy_(src)
    return dense(params["wdown"], y, cd), cache


# ============================================================== sLSTM ====
class SLSTMCache(NamedTuple):
    c: torch.Tensor  # (B, d)
    n: torch.Tensor  # (B, d)
    h: torch.Tensor  # (B, d)
    m: torch.Tensor  # (B, d)


def slstm_init(gen, cfg, d=None, device=None) -> Params:
    d = d or cfg.d_model
    h = cfg.n_heads
    ph = d // h
    pd = cfg.pdtype
    ps = Params()
    ps.wx = dense_init(gen, d, 4 * d, True, pd, device=device)  # z i f o
    ps.r = param((4, h, ph, ph), pd, device, gen, scale=ph ** -0.5)
    ps.norm = rmsnorm_init(d, pd, device)
    ps.wdown = dense_init(gen, d, d, False, pd, device=device)
    return ps


def _slstm_cell(params, xw, state: SLSTMCache, cfg, d) -> SLSTMCache:
    """One step.  xw: the precomputed Wx x + b, (B, 4d)."""
    heads = cfg.n_heads
    ph = d // heads
    hprev = state.h.reshape(-1, heads, ph)
    rh = torch.einsum("ghpr,bhp->gbhr", params["r"].float(),
                      hprev.float()).reshape(4, -1, d)
    pre = xw.float().reshape(-1, 4, d).transpose(0, 1) + rh
    zt = torch.tanh(pre[0])
    li = pre[1]                      # exp input gate (log space)
    lf = elementwise(F.logsigmoid, pre[2])  # sigmoid forget in log space
    ot = torch.sigmoid(pre[3])
    m_new = torch.maximum(lf + state.m, li)
    a = torch.exp(lf + state.m - m_new)
    bg = torch.exp(li - m_new)
    c_new = a * state.c + bg * zt
    n_new = torch.maximum(a * state.n + bg, torch.exp(-m_new))
    return SLSTMCache(c=c_new, n=n_new, h=ot * c_new / n_new, m=m_new)


def slstm_cache_init(cfg, batch, d=None, dtype=torch.float32,
                     device=None) -> SLSTMCache:
    d = d or cfg.d_model
    z = torch.zeros((batch, d), dtype=dtype, device=device)
    return SLSTMCache(c=z, n=z + 1e-6, h=z.clone(),
                      m=torch.full((batch, d), M0, dtype=dtype,
                                   device=device))


def slstm_forward(params, x, cfg, d=None):
    """The recurrence over T, one step at a time.  x (B, T, d)."""
    d = d or cfg.d_model
    b, t, _ = x.shape
    cd = cfg.cdtype
    xw = dense(params["wx"], x, cd)  # (B, T, 4d)
    state = slstm_cache_init(cfg, b, d, device=x.device)
    hs = []
    for i in range(t):
        state = _slstm_cell(params, xw[:, i], state, cfg, d)
        hs.append(state.h)
    y = torch.stack(hs, dim=1).to(cd)  # (B, T, d)
    y = rmsnorm(params["norm"], y, cfg.norm_eps)
    return dense(params["wdown"], y, cd)


def slstm_decode_step(params, x, cache: SLSTMCache, cfg, d=None):
    """x (B, 1, d) -> ((B, 1, d), cache), the cache written in place."""
    cd = cfg.cdtype
    d = d or cfg.d_model
    xw = dense(params["wx"], x, cd)[:, 0]
    new = _slstm_cell(params, xw, cache, cfg, d)
    y = rmsnorm(params["norm"], new.h[:, None].to(cd), cfg.norm_eps)
    for dst, src in zip(cache, new):
        dst.copy_(src)
    return dense(params["wdown"], y, cd), cache
