"""Mixture-of-Experts layer: top-k routing with sort-based capacity
dispatch, as the reference's `models/moe.py`.

Token -> expert assignments are sorted by expert (stably), truncated to
a capacity of cap = max(8, min(ceil(T * top_k * capacity_factor / E),
T)) per expert, gathered into an (E, cap, d) buffer, run through the
batched expert MLPs (expert weights are (E, d_in, d_out) tensors, no
per-expert modules) and combined back weighted by the renormalized
router probability.  Dropped assignments pass through the residual
untouched.

Three choices keep the port equal to the reference on the CPU and
deterministic on the card, with no value read back to the host:

* Top-k is a stable descending sort: ties go to the lower expert index,
  as in `lax.top_k` (`torch.topk` promises no order).
* The buffer is a gather (slot c of expert e reads the sorted assignment
  at e's start + c), not a scatter with duplicate indices, whose order
  CUDA leaves undefined.  The reference scatters every dropped
  assignment into slot cap - 1 with value 0, and XLA on the CPU applies
  those writes after the kept token's: an expert that overflows has its
  slot cap - 1 zeroed, so its last kept token gets nothing from that
  expert and no gradient through it.  The port zeroes that slot on
  purpose (ROADMAP.md queue 3).
* The combine gathers each token's k contributions and adds them in
  ascending expert order, the order of the reference's serial
  scatter-add on the CPU, with no float atomics.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.nn import functional as F

from repro_torch.models.layers import Params, dense_init, param
from repro_torch.sharding.hints import placed_as, rows_reshape

__all__ = ["Route", "moe_init", "moe"]


class Route(NamedTuple):
    """One token block's routing.  Per token: `gate`, `choice` (T, k),
    in descending probability.  Per assignment, sorted by expert:
    `order` (its index in the flat (T * k) layout), `stok` (token),
    `pos` (slot in its expert's run), `keep` (pos < cap).  Per expert:
    `counts` (E,)."""
    logits: torch.Tensor
    probs: torch.Tensor
    gate: torch.Tensor
    choice: torch.Tensor
    order: torch.Tensor
    stok: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    counts: torch.Tensor
    cap: int


def moe_init(gen, cfg, d=None, device=None) -> Params:
    d = d or cfg.d_model
    e, ff = cfg.n_experts, cfg.d_ff
    p = Params()
    p.router = dense_init(gen, d, e, False, cfg.pdtype, device=device)
    p.wi = param((e, d, ff), cfg.pdtype, device, gen, scale=d ** -0.5)
    p.wg = param((e, d, ff), cfg.pdtype, device, gen, scale=d ** -0.5)
    p.wo = param((e, ff, d), cfg.pdtype, device, gen, scale=ff ** -0.5)
    return p


def moe(p, x, cfg):
    """x (B, S, d) -> ((B, S, d) in the compute dtype, aux dict).

    Above `cfg.moe_chunk` tokens (when it divides them) dispatch runs
    block by block, and each aux value is the mean over the blocks."""
    b, s, d = x.shape
    t = b * s
    chunk = cfg.moe_chunk
    if chunk and t > chunk and t % chunk == 0:
        ys, auxs = [], []
        for xi in x.reshape(t // chunk, chunk, d):
            yi, ai = _moe_tokens(p, xi, cfg)
            ys.append(yi)
            auxs.append(ai)
        aux = {k: torch.stack([a[k] for a in auxs]).mean() for k in auxs[0]}
        return torch.cat(ys).reshape(b, s, d).to(cfg.cdtype), aux
    # a batch-split DTensor's tokens stay split on the local shards, and
    # its output comes back on that layout
    xt = rows_reshape(x, (t, d))
    y, aux = _moe_tokens(p, xt, cfg)
    return rows_reshape(placed_as(y, xt), (b, s, d)).to(cfg.cdtype), aux


def _route(xf, w_router, cfg) -> Route:
    """Router logits in float32, top-k, renormalize, sort by expert."""
    t = xf.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    cap = int(t * k * cfg.capacity_factor / e + 0.999)
    cap = max(8, min(cap, t))
    dev = xf.device
    logits = xf.float() @ w_router.float()  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, choice = top[:, :k], idx[:, :k]
    gate = gate / gate.sum(dim=-1, keepdim=True)  # renormalize
    order = torch.argsort(choice.reshape(-1), stable=True)
    se = choice.reshape(-1)[order]
    stok = order // k  # assignment i belongs to token i // k
    counts = (se[:, None] == torch.arange(e, device=dev)).sum(dim=0)
    starts = torch.cumsum(counts, dim=0) - counts
    pos = torch.arange(t * k, device=dev) - starts[se]
    return Route(logits, probs, gate, choice, order, stok, pos, pos < cap,
                 counts, cap)


def _moe_tokens(p, xf, cfg):
    """Dispatch and combine for a flat token block xf (T, d)."""
    t, d = xf.shape
    e, k = cfg.n_experts, cfg.top_k
    cd = cfg.cdtype
    r = _route(xf, p["router"]["w"], cfg)
    cap, dev = r.cap, xf.device

    # ---- gather into (E, cap, d) ----------------------------------------
    slot = torch.arange(cap, device=dev)
    src = (r.counts.cumsum(0) - r.counts)[:, None] + slot  # sorted index
    live = slot < r.counts.clamp(max=cap)[:, None]
    # the reference's zeroed slot cap - 1 of every overflowing expert
    live &= ~((slot == cap - 1) & (r.counts[:, None] > cap))
    tok = r.stok[src.clamp(max=t * k - 1)]  # (E, cap)
    buf = torch.where(live[..., None], xf.to(cd)[tok], 0.0)

    # ---- batched expert MLP ---------------------------------------------
    hi = torch.bmm(buf, p["wi"].to(cd))
    hg = torch.bmm(buf, p["wg"].to(cd))
    ho = torch.bmm(hi * F.silu(hg), p["wo"].to(cd))  # (E, cap, d)

    # ---- weighted combine, ascending expert order per token -------------
    pos = torch.empty_like(r.pos).scatter_(0, r.order, r.pos).reshape(t, k)
    experts, j = torch.sort(r.choice, dim=-1)  # distinct experts: no ties
    pos = pos.gather(1, j)
    weight = r.gate.gather(1, j) * (pos < cap).float()
    slots = torch.where(pos < cap, pos, cap - 1)
    out = None
    for i in range(k):
        contrib = ho[experts[:, i], slots[:, i]].float() * weight[:, i, None]
        out = contrib if out is None else out + contrib

    # ---- aux: load-balancing loss (Switch) + router z-loss --------------
    me = r.probs.mean(dim=0)  # mean router prob per expert
    chosen = (r.choice[..., None] == torch.arange(e, device=dev)).any(1)
    aux = {
        "load_balance": e * torch.sum(me * chosen.float().mean(dim=0)),
        "router_z": torch.mean(torch.logsumexp(r.logits, dim=-1) ** 2),
        "dropped_frac": 1.0 - r.keep.float().mean(),
    }
    return out.to(cd), aux
