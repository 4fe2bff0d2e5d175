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

On a mesh (DTensor tokens) the same routing, expert MLP and combine run
on local shards (`sharding/hints.py::ExpertSplit`): each block's routes
over all of its tokens, each rank a share of the capacity slots of its
experts (E or d_ff split over "model", as the rules split the expert
weights), the output the ranks' contributions summed onto the tokens'
own split.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.nn import functional as F

from repro_torch.models.layers import Params, dense_init, param
from repro_torch.sharding.hints import (ExpertSplit, batch_split, matmul,
                                        rows_reshape, summed)

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
    block by block, and each aux value is the mean over the blocks.  A
    DTensor x runs on local shards (`_moe_sharded`)."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return _moe_sharded(p, x, cfg)
    b, s, d = x.shape
    t = b * s
    block = _block(t, cfg)
    ys, auxs = [], []
    for xi in x.reshape(t // block, block, d):
        yi, ai = _moe_tokens(p, xi, cfg)
        ys.append(yi)
        auxs.append(ai)
    aux = {k: torch.stack([a[k] for a in auxs]).mean() for k in auxs[0]}
    return torch.cat(ys).reshape(b, s, d).to(cfg.cdtype), aux


def _block(t: int, cfg) -> int:
    """The tokens routed together: `cfg.moe_chunk` where it divides t
    into more than one block, else all t."""
    chunk = cfg.moe_chunk
    return chunk if chunk and t > chunk and t % chunk == 0 else t


def _route(xf, w_router, cfg) -> Route:
    """Router logits of xf (T, d) in float32, then `_route_logits`."""
    return _route_logits(xf.float() @ w_router.float(), cfg)


def _route_logits(logits, cfg) -> Route:
    """Top-k of the (T, E) logits, renormalize, sort by expert."""
    t = logits.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    cap = int(t * k * cfg.capacity_factor / e + 0.999)
    cap = max(8, min(cap, t))
    dev = logits.device
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


def _experts(xf, r: Route, w, experts: slice, slots: slice):
    """The expert MLP over the buffer slots `slots` (possibly running
    past the capacity: padding, zero) of the experts `experts`: xf (T,
    d) in the compute dtype, w the (wi, wg, wo) of those experts in it.
    Returns (len(experts), len(slots), d)."""
    dev = xf.device
    tk = r.stok.shape[0]
    slot = torch.arange(slots.start, slots.stop, device=dev)
    counts = r.counts[experts]
    src = (r.counts.cumsum(0) - r.counts)[experts][:, None] + slot
    live = slot < counts.clamp(max=r.cap)[:, None]
    # the reference's zeroed slot cap - 1 of every overflowing expert
    live &= ~((slot == r.cap - 1) & (counts[:, None] > r.cap))
    tok = r.stok[src.clamp(max=tk - 1)]  # (E, cap)
    buf = torch.where(live[..., None], xf[tok], 0.0)
    wi, wg, wo = w
    hi = torch.bmm(buf, wi)
    hg = torch.bmm(buf, wg)
    return torch.bmm(hi * F.silu(hg), wo)


def _combine(ho, r: Route, experts: slice, slots: slice):
    """Each token's weighted sum (T, d) float32 of its kept assignments
    that fall in `experts` x `slots` (ho's rows), added in ascending
    expert order."""
    t, k = r.choice.shape
    pos = torch.empty_like(r.pos).scatter_(0, r.order, r.pos).reshape(t, k)
    chosen, j = torch.sort(r.choice, dim=-1)  # distinct: no ties
    pos = pos.gather(1, j)
    here = ((pos < r.cap) & (chosen >= experts.start)
            & (chosen < experts.stop) & (pos >= slots.start)
            & (pos < slots.stop))
    weight = r.gate.gather(1, j) * here.float()
    rows = (chosen - experts.start).clamp(0, ho.shape[0] - 1)
    cols = (pos - slots.start).clamp(0, ho.shape[1] - 1)
    out = ho[rows[:, 0], cols[:, 0]].float() * weight[:, 0, None]
    for i in range(1, k):
        out += ho[rows[:, i], cols[:, i]].float() * weight[:, i, None]
    return out


def _aux(r: Route, e: int):
    """Load-balancing loss (Switch), router z-loss, dropped share."""
    me = r.probs.mean(dim=0)  # mean router prob per expert
    chosen = (r.choice[..., None]
              == torch.arange(e, device=r.choice.device)).any(1)
    return {
        "load_balance": e * torch.sum(me * chosen.float().mean(dim=0)),
        "router_z": torch.mean(torch.logsumexp(r.logits, dim=-1) ** 2),
        "dropped_frac": 1.0 - r.keep.float().mean(),
    }


def _moe_tokens(p, xf, cfg):
    """Dispatch and combine for a flat token block xf (T, d)."""
    e, cd = cfg.n_experts, cfg.cdtype
    r = _route(xf, p["router"]["w"], cfg)
    every, slots = slice(0, e), slice(0, r.cap)
    w = [p[n].to(cd) for n in ("wi", "wg", "wo")]
    ho = _experts(xf.to(cd), r, w, every, slots)  # (E, cap, d)
    return _combine(ho, r, every, slots).to(cd), _aux(r, e)


def _moe_sharded(p, x, cfg):
    """`moe` of a DTensor x on local shards (`sharding/hints.py::
    ExpertSplit`): the routes of each block global over its tokens, the
    expert products on the rule's split, the output a sum of the ranks'
    contributions reduced onto x's own split."""
    b, s, d = x.shape
    t = b * s
    e, cd = cfg.n_experts, cfg.cdtype
    block = _block(t, cfg)
    xf = rows_reshape(batch_split(x), (t, d))
    sp = ExpertSplit(xf, p["wi"], block, e)
    logits = sp.rows(summed(matmul(xf.float(), p["router"]["w"].float())))
    xs = sp.rows(xf.to(cd))
    w = [sp.weight(p[n].to(cd)) for n in ("wi", "wg", "wo")]
    outs, parts = [], []
    for i in range(sp.n_blocks):
        rows = slice(i * block, (i + 1) * block)
        r = _route_logits(logits[rows], cfg)
        slots = sp.slots(r.cap)
        ho = _experts(xs[rows], r, w, sp.experts, slots)
        outs.append(_combine(ho, r, sp.experts, slots))
        parts.append(_aux(r, e))
    y = sp.output(torch.cat(outs), (t, d)).to(cd)
    aux = {k: sp.mean(torch.stack([a[k] for a in parts]),
                      same=(k == "dropped_frac")) for k in parts[0]}
    return rows_reshape(y, (b, s, d)).redistribute(
        x.device_mesh, x.placements), aux
