"""Gated MLP (SwiGLU / GeGLU) and the classic 2-matrix MLP."""
from __future__ import annotations

import torch
from torch.nn import functional as F

from repro_torch.models.layers import Params, dense, dense_init


def mlp_init(gen, d: int, ff: int, dtype=torch.float32, gated: bool = True,
             device=None) -> Params:
    p = Params()
    p.wi = dense_init(gen, d, ff, False, dtype, device=device)
    if gated:
        p.wg = dense_init(gen, d, ff, False, dtype, device=device)
    p.wo = dense_init(gen, ff, d, False, dtype, scale=ff ** -0.5,
                      device=device)
    return p


def _act(name: str):
    if name == "silu":
        return F.silu
    # jax.nn.gelu defaults to the tanh approximation
    return lambda h: F.gelu(h, approximate="tanh")


def mlp(p, x, cd, act: str = "silu"):
    h = dense(p["wi"], x, cd)
    actf = _act(act)
    if "wg" in p:  # gated (SwiGLU/GeGLU)
        return dense(p["wo"], h * actf(dense(p["wg"], x, cd)), cd)
    return dense(p["wo"], actf(h), cd)  # classic 2-matrix MLP
