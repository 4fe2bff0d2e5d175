"""AdamW with global-norm clipping, LR schedule, and TEDA-guard masking.

Plain functions on tensors, not `torch.optim.AdamW`: the order of the
weight decay and the bias corrections, the schedule and the masked skip
are the reference's.  Optimizer state is a tree congruent with the
params (a dict of tensors keyed like `dict(model.named_parameters())`).
`update` writes params, m and v in place, one leaf at a time, so that a
full-width model never holds a second copy of any of them; its `skip`
flag is the TEDAGuard verdict, a device bool: a skipped step is a no-op
on params AND state (count included), applied as a device-side select
with no host readback, which is what makes guard-skipping equivalent to
never having seen the batch.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map

__all__ = ["AdamWConfig", "OptState", "init", "schedule", "global_norm",
           "update"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    grad_dtype: str = "float32"  # bfloat16 => compressed grad accumulation
    m_dtype: str = "float32"     # bfloat16 => halve first-moment storage
    v_dtype: str = "float32"     # bfloat16 => halve second-moment storage


class OptState(NamedTuple):
    m: Any
    v: Any
    count: torch.Tensor


def init(params, cfg: "AdamWConfig | None" = None) -> OptState:
    md = getattr(torch, cfg.m_dtype) if cfg else torch.float32
    vd = getattr(torch, cfg.v_dtype) if cfg else torch.float32
    count_dev = tree_leaves(params)[0].device
    return OptState(
        m=tree_map(lambda p: torch.zeros_like(p, dtype=md,
                                              requires_grad=False), params),
        v=tree_map(lambda p: torch.zeros_like(p, dtype=vd,
                                              requires_grad=False), params),
        count=torch.zeros((), dtype=torch.int32, device=count_dev))


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_frac."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(g.float() ** 2)
                          for g in tree_leaves(tree)))


@torch.no_grad()
def update(grads, state: OptState, params, cfg: AdamWConfig,
           skip: "torch.Tensor | bool" = False
           ) -> Tuple[Any, OptState, dict]:
    """Returns (params, new_state, metrics); params, m and v are the
    caller's tensors, written in place."""
    gnorm = global_norm(grads)
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    else:
        scale = None

    count = state.count + 1
    cf = count.float()
    b1c = 1 - torch.pow(cfg.b1, cf)
    b2c = 1 - torch.pow(cfg.b2, cf)
    lr = schedule(cfg, count)
    skip = torch.as_tensor(skip, device=count.device)

    md, vd = getattr(torch, cfg.m_dtype), getattr(torch, cfg.v_dtype)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state.m), tree_leaves(state.v)):
        g = g.float() if scale is None else g.float() * scale
        new_m = (cfg.b1 * m.float() + (1 - cfg.b1) * g).to(md)
        new_v = (cfg.b2 * v.float() + (1 - cfg.b2) * g * g).to(vd)
        del g
        upd = (new_m.float() / b1c) / (
            torch.sqrt(new_v.float() / b2c) + cfg.eps)
        upd = upd + cfg.weight_decay * p.float()
        new_p = (p.float() - lr * upd).to(p.dtype)
        del upd
        # TEDA-guard masking: skipped step == unseen batch
        p.copy_(torch.where(skip, p, new_p))
        m.copy_(torch.where(skip, m, new_m))
        v.copy_(torch.where(skip, v, new_v))
    new_count = torch.where(skip, state.count, count)

    metrics = {"grad_norm": gnorm, "lr": lr, "skipped": skip.float()}
    return params, OptState(m=state.m, v=state.v, count=new_count), metrics
