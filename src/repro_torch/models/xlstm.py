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

On a mesh (DTensor inputs) both recurrences run on plain local tensors,
split over "model" by (batch row, head) units
(`sharding/hints.py::UnitSplit`): the heads alone do not split there,
and no unit's recurrence reads another's.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch
from torch.nn import functional as F
from torch.utils.flop_counter import flop_registry, register_flop_formula

from repro_torch.models.layers import (Params, dense, dense_init, param,
                                       rmsnorm, rmsnorm_init)
from repro_torch.models.ssm import CONV_W, causal_conv
from repro_torch.sharding.hints import unit_split_of

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
    chunk (min(ssm_chunk, T)) must divide T.  On a DTensor x the chunk
    loop runs on plain local tensors, split over "model" by (batch row,
    head) units (`sharding/hints.py::UnitSplit`)."""
    b, t, _ = x.shape
    cd = cfg.cdtype
    xm, z, (d_in, h, p) = _mlstm_proj(params, x, cfg, d)
    xc, _ = causal_conv(params["conv"].to(cd), xm)

    q = dense(params["wq"], xc, cd)
    k = dense(params["wk"], xc, cd)
    v = dense(params["wv"], xm, cd)
    gates = dense(params["wif"], xc, cd).float()
    split = unit_split_of(q, h)
    if split:
        q, k, v, gates = map(split.gather, (q, k, v, gates))
        rows, heads = split.rows, split.heads
        bl = q.shape[0]
        q, k, v = (a.reshape(bl, t, h, p)[rows, :, heads][:, :, None]
                   for a in (q, k, v))  # (units, T, 1, P)
        li = gates[..., :h][rows, :, heads][..., None]
        lf = F.logsigmoid(gates[..., h:][rows, :, heads])[..., None]
    else:
        q, k, v = (a.reshape(b, t, h, p) for a in (q, k, v))
        li = gates[..., :h]                  # log input gate (exp gate)
        lf = F.logsigmoid(gates[..., h:])    # log forget gate
    y = _mlstm_chunks(q, k, v, li, lf, cfg)
    if split:
        full = y.new_zeros((bl, t, h, p))
        full[rows, :, heads] = y[:, :, 0]
        y = split.wrap(full.reshape(bl, t, d_in).to(cd), (b, t, d_in))
        y = y.redistribute(z.device_mesh, z.placements)
    else:
        y = y.reshape(b, t, d_in).to(cd)
    y = rmsnorm(params["norm"], y, cfg.norm_eps)
    y = y * F.silu(z)
    return dense(params["wdown"], y, cd)


def _mlstm_chunks(q, k, v, li, lf, cfg):
    """The chunk loop: q, k, v (b, T, h, P) in the compute dtype, the log
    gates li, lf (b, T, h) float32 -> (b, T, h, P) float32."""
    b, t, h, p = q.shape
    cd = cfg.cdtype
    qch = min(cfg.ssm_chunk, t)
    if t % qch:
        raise ValueError(f"sequence length {t} does not divide into "
                         f"chunks of {qch}")
    nc = t // qch

    def chunks(a):  # (B, T, ...) -> (B, nc, q, ...)
        return a.reshape(b, nc, qch, *a.shape[2:])

    qc, kc, vc, lic, lfc = (chunks(a) for a in (q, k, v, li, lf))
    tri = torch.tril(torch.ones((qch, qch), dtype=torch.bool,
                                device=q.device))
    ct = q.new_zeros((b, h, p, p), dtype=torch.float32)
    nt = q.new_zeros((b, h, p), dtype=torch.float32)
    mc = q.new_full((b, h), M0, dtype=torch.float32)
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
    return torch.cat(ys, dim=1)


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
    cache), the cache written in place (DTensors: by units, as
    `mlstm_forward`)."""
    b = x.shape[0]
    cd = cfg.cdtype
    xm, z, (d_in, h, p) = _mlstm_proj(params, x, cfg, d)
    xc, conv_new = causal_conv(params["conv"].to(cd), xm, cache.conv)

    q, k, v = (dense(params[n], a, cd)[:, 0]
               for n, a in (("wq", xc), ("wk", xc), ("wv", xm)))
    gates = dense(params["wif"], xc, cd).float()[:, 0]
    state = cache[:3]
    split = unit_split_of(q, h)
    if split:
        rows, heads = split.rows, split.heads
        q, k, v, gates = map(split.gather, (q, k, v, gates))
        bl = q.shape[0]
        q, k, v = (a.reshape(bl, h, p)[rows, heads][:, None].float()
                   for a in (q, k, v))  # (units, 1, P)
        li = gates[..., :h][rows, heads][:, None]
        lf = F.logsigmoid(gates[..., h:][rows, heads])[:, None]
        state = [split.gather(t)[rows, heads][:, None] for t in state]
    else:
        q, k, v = (a.reshape(b, h, p).float() for a in (q, k, v))
        li, lf = gates[..., :h], F.logsigmoid(gates[..., h:])
    c, n, m = state

    m_new = torch.maximum(lf + m, li)
    a = torch.exp(lf + m - m_new)
    bgt = torch.exp(li - m_new)
    c_new = (c * a[..., None, None]
             + bgt[..., None, None] * torch.einsum("bhp,bhr->bhpr", k, v))
    n_new = n * a[..., None] + bgt[..., None] * k
    num = torch.einsum("bhp,bhpr->bhr", q, c_new)
    den = torch.maximum(torch.einsum("bhp,bhp->bh", q, n_new).abs(),
                        torch.exp(-m_new))
    y = num / den[..., None]
    new = (c_new, n_new, m_new)
    if split:
        def whole(t, shape):  # this rank's units in a (B_l, ...) of zeros
            out = t.new_zeros((bl,) + tuple(shape))
            out[rows, heads] = t[:, 0]
            return out
        y = split.wrap(whole(y, (h, p)).reshape(bl, 1, d_in).to(cd),
                       (b, 1, d_in))
        y = y.redistribute(z.device_mesh, z.placements)
        for dst, src in zip(cache[:3], new):
            split.write(dst, whole(src, dst.shape[1:]))
    else:
        y = y.reshape(b, 1, d_in).to(cd)
        for dst, src in zip(cache[:3], new):
            dst.copy_(src)
    cache.conv.copy_(conv_new)
    y = rmsnorm(params["norm"], y, cfg.norm_eps) * F.silu(z)
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


def _slstm_pre(r, xw, h, heads: int):
    """The gates' pre-activations (4, B, d) float32: Wx x + b (xw, (B,
    4d), z i f o) plus R h_{t-1} per head."""
    d = h.shape[-1]
    hprev = h.reshape(-1, heads, d // heads)
    rh = torch.einsum("ghpr,bhp->gbhr", r.float(),
                      hprev.float()).reshape(4, -1, d)
    return xw.float().reshape(-1, 4, d).transpose(0, 1) + rh


def _slstm_gates(pre, c, n, m):
    """The new (c, n, h, m) from the pre-activations and the old state."""
    zt = torch.tanh(pre[0])
    li = pre[1]                      # exp input gate (log space)
    lf = F.logsigmoid(pre[2])        # sigmoid forget in log space
    ot = torch.sigmoid(pre[3])
    m_new = torch.maximum(lf + m, li)
    a = torch.exp(lf + m - m_new)
    bg = torch.exp(li - m_new)
    c_new = a * c + bg * zt
    n_new = torch.maximum(a * n + bg, torch.exp(-m_new))
    return c_new, n_new, ot * c_new / n_new, m_new


# One sLSTM step is one registered op (and its backward another), so
# that a trace on the meta device dispatches two ops per step where the
# composite takes ~280 (the dry run's 4,096-step loops); their flops are
# those of the composite, traced once per shape (`_step_flops`).
_STEP = ("(Tensor r, Tensor xw, Tensor c, Tensor n, Tensor h, Tensor m, "
         "int heads) -> (Tensor, Tensor, Tensor, Tensor, Tensor)")
_STEP_BWD = ("(Tensor r, Tensor xw, Tensor h, Tensor pre, Tensor c, Tensor n, "
             "Tensor m, Tensor gc, Tensor gn, Tensor gh, Tensor gm, "
             "Tensor gpre, int heads) -> (Tensor, Tensor, Tensor, Tensor, "
             "Tensor, Tensor)")


def _step(r, xw, c, n, h, m, heads):
    """One step: the new (c, n, h, m) and the pre-activations."""
    pre = _slstm_pre(r, xw, h, heads)
    return (*_slstm_gates(pre, c, n, m), pre)


slstm_step = torch.library.custom_op("repro_torch::slstm_step",
                                     mutates_args=(), schema=_STEP)(_step)


@slstm_step.register_fake
def _(r, xw, c, n, h, m, heads):
    state = [torch.empty(c.shape, dtype=torch.float32, device=c.device)
             for _ in range(4)]
    return (*state, torch.empty((4,) + tuple(c.shape), dtype=torch.float32,
                                device=c.device))


def _max_grads(x, y, g):
    """The gradients of torch.maximum(x, y) for g: a tie splits g."""
    half = torch.where(x == y, g / 2, g)
    zero = torch.zeros_like(half)
    return torch.where(x < y, zero, half), torch.where(x > y, zero, half)


def _gates_backward(pre, c, n, m, gc, gn, gh, gm):
    """The gradients of `_slstm_gates` with respect to (pre, c, n, m)
    for those of its outputs, by autograd's derivative rules."""
    zt, li, ot = torch.tanh(pre[0]), pre[1], torch.sigmoid(pre[3])
    w = F.logsigmoid(pre[2]) + m
    m_new = torch.maximum(w, li)
    a = torch.exp(w - m_new)
    bg = torch.exp(li - m_new)
    c_new = a * c + bg * zt
    u, v = a * n + bg, torch.exp(-m_new)
    n_new = torch.maximum(u, v)
    g_oc = gh / n_new                                  # h = ot c_new / n_new
    gn = gn - gh * (ot * c_new) / (n_new * n_new)
    gc = gc + g_oc * ot
    gu, gv = _max_grads(u, v, gn)
    ga = gu * n + gc * c                               # a, bg: c_new, n_new
    gbg = gu + gc * zt
    gm_new = gm - gv * v - gbg * bg - ga * a           # v, bg, a
    gw, gli = _max_grads(w, li, gm_new)
    gw = gw + ga * a
    gli = gli + gbg * bg
    dpre = torch.stack([gc * bg * (1 - zt * zt), gli,
                        gw * torch.sigmoid(-pre[2]),
                        g_oc * c_new * ot * (1 - ot)])
    return dpre, gc * a, gu * a, gw


def _step_bwd(r, xw, h, pre, c, n, m, gc, gn, gh, gm, gpre, heads):
    """The gradients of (r, xw, c, n, h, m): the gates' (recomputed
    from `pre`), then the recurrent product's."""
    dpre, dc, dn, dm = _gates_backward(pre, c, n, m, gc, gn, gh, gm)
    dpre = dpre + gpre
    d = h.shape[-1]
    hprev = h.reshape(-1, heads, d // heads).float()
    g = dpre.reshape(4, -1, heads, d // heads)  # (4, B, H, P)
    dr = torch.einsum("gbhr,bhp->ghpr", g, hprev).to(r.dtype)
    dh = torch.einsum("ghpr,gbhr->bhp", r.float(), g).reshape(-1, d)
    dxw = dpre.transpose(0, 1).reshape(-1, 4 * d).to(xw.dtype)
    return dr, dxw, dc, dn, dh.to(h.dtype), dm


slstm_step_backward = torch.library.custom_op(
    "repro_torch::slstm_step_backward", mutates_args=(),
    schema=_STEP_BWD)(_step_bwd)


@slstm_step_backward.register_fake
def _(r, xw, h, pre, c, n, m, gc, gn, gh, gm, gpre, heads):
    return tuple(torch.empty_like(t) for t in (r, xw, c, n, h, m))


def _step_setup(ctx, inputs, output):
    r, xw, c, n, h, m, ctx.heads = inputs
    ctx.save_for_backward(r, xw, h, output[4], c, n, m)


def _step_backward(ctx, gc, gn, gh, gm, gpre):
    saved = ctx.saved_tensors
    pre, state = saved[3], saved[4:]
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(list(state[:2]) + [state[0], state[2], pre],
                             (gc, gn, gh, gm, gpre))]
    dr, dxw, dc, dn, dh, dm = slstm_step_backward(*saved, *grads, ctx.heads)
    return dr, dxw, dc, dn, dh, dm, None


slstm_step.register_autograd(_step_backward, setup_context=_step_setup)


@functools.lru_cache(maxsize=None)
def _step_flops(backward: bool, shapes) -> int:
    """The composite step's flops (`launch/cost_analysis.py`'s rule) at
    these argument shapes and dtypes, traced once on the meta device."""
    from repro_torch.launch.cost_analysis import OpCounter

    args = [torch.empty(s, dtype=dt, device="meta") if s is not None else dt
            for s, dt in shapes]
    with OpCounter() as ops:
        (_step_bwd if backward else _step)(*args)
    return ops.flops


def _flop_formula(backward: bool):
    def count(*args, out_val=None, **kwargs):
        return _step_flops(backward, tuple(
            (tuple(a.shape), a.dtype) if isinstance(a, torch.Tensor)
            else (None, a) for a in args))
    return count


for _op, _bwd in ((torch.ops.repro_torch.slstm_step, False),
                  (torch.ops.repro_torch.slstm_step_backward, True)):
    if _op not in flop_registry:
        register_flop_formula(_op, get_raw=True)(_flop_formula(_bwd))


def _slstm_cell(r, xw, state: SLSTMCache, heads: int) -> SLSTMCache:
    """One step.  r: the recurrent weight (4, H, P, P); xw: the
    precomputed Wx x + b, (B, 4d)."""
    return SLSTMCache(*slstm_step(r, xw, *state, heads)[:4])


def slstm_cache_init(cfg, batch, d=None, dtype=torch.float32,
                     device=None) -> SLSTMCache:
    d = d or cfg.d_model
    z = torch.zeros((batch, d), dtype=dtype, device=device)
    return SLSTMCache(c=z, n=z + 1e-6, h=z.clone(),
                      m=torch.full((batch, d), M0, dtype=dtype,
                                   device=device))


def slstm_forward(params, x, cfg, d=None):
    """The recurrence over T, one step at a time.  x (B, T, d).  On a
    DTensor x the steps run on plain local tensors, split over "model"
    by (batch row, head) units (`sharding/hints.py::UnitSplit`): Wx x
    and r gathered once per layer, nothing exchanged inside the loop."""
    d = d or cfg.d_model
    b, t, _ = x.shape
    cd = cfg.cdtype
    heads = cfg.n_heads
    ph = d // heads
    xw = dense(params["wx"], x, cd)  # (B, T, 4d)
    r = params["r"]
    split = unit_split_of(xw, heads)
    if split:
        # each unit a head of a batch of one: (1, T, 4 x units x P)
        xw = split.gather(xw)
        bl = xw.shape[0]
        xw = xw.reshape(bl, t, 4, heads, ph)[split.rows, :, :, split.heads]
        heads = xw.shape[0]
        xw = xw.permute(1, 2, 0, 3).reshape(1, t, 4 * heads * ph)
        r = split.weight(r)[:, split.heads]
    state = slstm_cache_init(cfg, xw.shape[0], heads * ph, device=xw.device)
    hs = []
    for xt in xw.unbind(1):  # one gradient op for all steps, not one each
        state = _slstm_cell(r, xt, state, heads)
        hs.append(state.h)
    y = torch.stack(hs, dim=1).to(cd)  # (B, T, d)
    if split:
        whole = y.new_zeros((bl, t, cfg.n_heads, ph))
        whole[split.rows, :, split.heads] = y.reshape(t, heads, ph).transpose(
            0, 1)
        y = _columns(split.wrap(whole.reshape(bl, t, d), (b, t, d)))
    y = rmsnorm(params["norm"], y, cfg.norm_eps)
    return dense(params["wdown"], y, cd)


def _columns(y):
    """A DTensor's pending sum over "model" reduced onto a split of its
    last dim there (the row-parallel read-out's input)."""
    from torch.distributed.tensor import Shard

    return y.redistribute(y.device_mesh, [
        Shard(y.ndim - 1) if p.is_partial() else p for p in y.placements])


def slstm_decode_step(params, x, cache: SLSTMCache, cfg, d=None):
    """x (B, 1, d) -> ((B, 1, d), cache), the cache written in place
    (DTensors: by units, as `slstm_forward`)."""
    cd = cfg.cdtype
    d = d or cfg.d_model
    heads = cfg.n_heads
    ph = d // heads
    xw = dense(params["wx"], x, cd)[:, 0]
    r = params["r"]
    split = unit_split_of(xw, heads)
    state = cache
    if split:
        rows, hs = split.rows, split.heads
        xw = split.gather(xw)
        bl = xw.shape[0]
        xw = xw.reshape(bl, 4, heads, ph)[rows, :, hs]  # (units, 4, P)
        heads = xw.shape[0]
        xw = xw.transpose(0, 1).reshape(1, 4 * heads * ph)
        r = split.weight(r)[:, hs]
        state = SLSTMCache(*(split.gather(t).reshape(bl, -1, ph)[rows, hs]
                             .reshape(1, -1) for t in cache))
    new = _slstm_cell(r, xw, state, heads)
    if split:
        def whole(t):  # this rank's units in a (B_l, d) of zeros
            out = t.new_zeros((bl, cfg.n_heads, ph))
            out[rows, hs] = t.reshape(-1, ph)
            return out.reshape(bl, d)
        new = SLSTMCache(*map(whole, new))
        h = _columns(split.wrap(new.h[:, None].to(cd), (x.shape[0], 1, d)))
        for dst, src in zip(cache, new):
            split.write(dst, src)
    else:
        h = new.h[:, None].to(cd)
        for dst, src in zip(cache, new):
            dst.copy_(src)
    y = rmsnorm(params["norm"], h, cfg.norm_eps)
    return dense(params["wdown"], y, cd), cache
