"""Mamba2 (SSD) block: the chunked-parallel training path and the O(1)
decode step, as the reference's `models/ssm.py`.

The recurrence S_t = a_t S_{t-1} + dt_t x_t (x) B_t, y_t = C_t . S_t +
D x_t runs chunk by chunk: the intra-chunk terms as a masked-decay
matmul, the state carried from chunk to chunk by a loop.  bfloat16
operands are upcast and their products summed in float32 wherever the
reference asks for `preferred_element_type=jnp.float32`.

Two differences on purpose (ROADMAP.md queue 3):

* The reference reshapes the per-step decays (B, T, H) straight into
  chunk-major order while it transposes every other input, so with B >
  1 and more than one chunk a sequence's decays come from its batch
  neighbours.  The port transposes them as the other inputs, which is
  what the reference's own decode recurrence and its forward run one
  sequence at a time compute.
* The reference takes `exp` over the whole (t, s) square and masks
  after it.  Once a chunk's decays sum past ~88, exp(cl_t - cl_s) for s
  > t overflows to inf: the forward is unharmed (the mask zeroes it),
  but the backward multiplies that inf by the mask's zero gradient and
  every gradient turns NaN.  The port masks first (exp(-inf) = 0): the
  forward is the same bit for bit, and so is every gradient the
  reference keeps finite.

Decode keeps (conv buffer (B, CONV_W - 1, ch), SSM state (B, H, P, N))
in float32 and writes both in place.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.nn import functional as F

from repro_torch.models.layers import (Params, dense, dense_init, param,
                                       rmsnorm, rmsnorm_init)

__all__ = ["CONV_W", "SSMCache", "ssm_dims", "ssm_init", "ssm_forward",
           "ssm_cache_init", "ssm_decode_step"]

CONV_W = 4  # depthwise causal conv width (mamba2 default)


class SSMCache(NamedTuple):
    conv: torch.Tensor   # (B, CONV_W-1, conv_ch)
    state: torch.Tensor  # (B, H, P, N)


def ssm_dims(cfg, d=None):
    d = d or cfg.d_model
    d_in = cfg.ssm_expand * d
    p = cfg.ssm_head_dim
    return d, d_in, d_in // p, p, cfg.ssm_state


def ssm_init(gen, cfg, d=None, device=None) -> Params:
    d, d_in, h, p, n = ssm_dims(cfg, d)
    conv_ch = d_in + 2 * n
    pd = cfg.pdtype
    ps = Params()
    # in_proj -> [z, x, B, C, dt]
    ps.win = dense_init(gen, d, 2 * d_in + 2 * n + h, False, pd,
                        device=device)
    ps.conv = param((CONV_W, conv_ch), pd, device, gen, scale=0.1)
    ps.a_log = param((h,), torch.float32, device, None, fill=0.0)
    ps.dt_bias = param((h,), torch.float32, device, None, fill=-2.0)
    ps.d_skip = param((h,), torch.float32, device, None, fill=1.0)
    ps.norm = rmsnorm_init(d_in, pd, device)
    ps.wout = dense_init(gen, d_in, d, False, pd, scale=d_in ** -0.5,
                         device=device)
    return ps


def _split(u, cfg, d):
    _, d_in, h, _, n = ssm_dims(cfg, d)
    return u[..., :d_in], u[..., d_in:2 * d_in + 2 * n], u[..., -h:]


def causal_conv(w, seq, cache=None):
    """Depthwise causal conv and SiLU.  seq (B, T, ch), w (W, ch); the
    W - 1 steps before seq come from `cache` (zeros without one).
    Returns (out, the last W - 1 steps, in seq's dtype)."""
    if cache is None:
        pad = seq.new_zeros((seq.shape[0], CONV_W - 1, seq.shape[2]))
    else:
        pad = cache.to(seq.dtype)
    full = torch.cat([pad, seq], dim=1)  # (B, T+W-1, ch)
    out = full[:, 0:seq.shape[1]] * w[0]
    for i in range(1, CONV_W):
        out = out + full[:, i:i + seq.shape[1]] * w[i]
    return F.silu(out), full[:, -(CONV_W - 1):]


def ssm_forward(params, x, cfg, d=None):
    """Training/prefill path.  x (B, T, d) -> (B, T, d); the chunk
    (min(ssm_chunk, T)) must divide T."""
    d, d_in, h, p, n = ssm_dims(cfg, d)
    b, t, _ = x.shape
    q = min(cfg.ssm_chunk, t)
    if t % q:
        raise ValueError(f"sequence length {t} does not divide into "
                         f"chunks of {q}")
    nc = t // q
    cd = cfg.cdtype

    u = dense(params["win"], x, cd)
    z, xbc, dt = _split(u, cfg, d)
    xbc, _ = causal_conv(params["conv"].to(cd), xbc)
    xs = xbc[..., :d_in].reshape(b, t, h, p)
    bs = xbc[..., d_in:d_in + n]  # (B, T, N)
    cs = xbc[..., d_in + n:]      # (B, T, N)
    dt = F.softplus(dt.float() + params["dt_bias"])  # (B, T, H)
    a = -torch.exp(params["a_log"])  # (H,) negative decay rates

    def chunks(v):  # (B, T, ...) -> (B, nc, q, ...)
        return v.reshape(b, nc, q, *v.shape[2:])

    # the decays take the same (B, nc, q) order as every other input
    la_c, xs_c, bs_c, cs_c, dt_c = (chunks(v) for v in (dt * a, xs, bs,
                                                        cs, dt))
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    s_prev = x.new_zeros((b, h, p, n), dtype=torch.float32)
    ys = []
    for c in range(nc):
        la, xc, bc, cc, dc = (v[:, c] for v in (la_c, xs_c, bs_c, cs_c,
                                                dt_c))
        cl = torch.cumsum(la, dim=1)  # (b, q, h)
        # intra: y[t] = sum_{s<=t} exp(cl_t - cl_s) dt_s (C_t.B_s) x_s
        # masked before exp: exp(-inf) = 0 where the reference's
        # exp(cl_t - cl_s), s > t, overflows to inf (ROADMAP.md queue 3)
        decay = torch.exp(torch.where(tri[None, :, :, None],
                                      cl[:, :, None] - cl[:, None],
                                      -torch.inf))  # (b, t, s, h)
        cb = torch.einsum("btn,bsn->bts", cc.float(), bc.float())
        w_ts = cb[..., None] * decay * dc[:, None]  # (b, t, s, h)
        y = torch.einsum("btsh,bshp->bthp", w_ts.to(cd).float(),
                         xc.float())
        # inter: the carried state's contribution
        y = y + torch.einsum("bth,btn,bhpn->bthp", torch.exp(cl),
                             cc.float(), s_prev)
        # the state handed to the next chunk
        tail = torch.exp(cl[:, -1:] - cl)  # (b, q, h)
        zb = torch.einsum("bth,bthp,btn->bhpn", (tail * dc).to(cd).float(),
                          xc.float(), bc.float())
        s_prev = s_prev * torch.exp(cl[:, -1])[..., None, None] + zb
        ys.append(y)
    y = torch.cat(ys, dim=1)  # (b, t, h, p)
    y = y + params["d_skip"][None, None, :, None] * xs.float()
    y = y.reshape(b, t, d_in).to(cd)
    y = rmsnorm(params["norm"], y * F.silu(z), cfg.norm_eps)
    return dense(params["wout"], y, cd)


def ssm_cache_init(cfg, batch: int, d=None, dtype=torch.float32,
                   device=None) -> SSMCache:
    d, d_in, h, p, n = ssm_dims(cfg, d)
    return SSMCache(
        conv=torch.zeros((batch, CONV_W - 1, d_in + 2 * n), dtype=dtype,
                         device=device),
        state=torch.zeros((batch, h, p, n), dtype=dtype, device=device))


def ssm_decode_step(params, x, cache: SSMCache, cfg, d=None):
    """x (B, 1, d) -> ((B, 1, d), cache): the O(1) state update, written
    into `cache` in place."""
    d, d_in, h, p, n = ssm_dims(cfg, d)
    b = x.shape[0]
    cd = cfg.cdtype

    u = dense(params["win"], x, cd)
    z, xbc, dt = _split(u, cfg, d)
    xbc, new_conv = causal_conv(params["conv"].to(cd), xbc, cache.conv)
    xs = xbc[:, 0, :d_in].reshape(b, h, p).float()
    bs = xbc[:, 0, d_in:d_in + n].float()
    cs = xbc[:, 0, d_in + n:].float()
    dt = F.softplus(dt[:, 0].float() + params["dt_bias"])
    a = -torch.exp(params["a_log"])

    dec = torch.exp(dt * a)  # (B, H)
    s_new = (cache.state * dec[..., None, None]
             + torch.einsum("bh,bhp,bn->bhpn", dt, xs, bs))
    y = torch.einsum("bn,bhpn->bhp", cs, s_new)
    y = y + params["d_skip"][None, :, None] * xs
    y = y.reshape(b, 1, d_in).to(cd)
    y = rmsnorm(params["norm"], y * F.silu(z), cfg.norm_eps)
    cache.conv.copy_(new_conv)
    cache.state.copy_(s_new)
    return dense(params["wout"], y, cd), cache
