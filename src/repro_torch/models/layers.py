"""Primitive layers shared by every architecture.

Parameters live in small `Params` modules that read like the reference's
parameter dicts (`p["w"]`, `"b" in p`), so each function below takes
either a `Params` module or a plain dict of tensors.  Dense weights are
stored `(d_in, d_out)` and applied as `y = x @ w`, as in the reference;
`models/convert.py` carries trees across without transposing anything.
Initialisers draw float32 normals on the CPU from the caller's
`torch.Generator`, so that one seed gives the same weights on any
device; without a generator they only allocate (for a tree that is
about to be loaded).  Compute runs in `cfg.compute_dtype` with float32
reductions.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

__all__ = ["Params", "param", "rmsnorm_init", "rmsnorm", "layernorm_init",
           "layernorm", "dense_init", "dense", "embedding_init", "embed",
           "unembed", "rope", "softcap"]


class Params(nn.Module):
    """A module of named tensors that indexes like a dict."""

    def __getitem__(self, name: str) -> torch.Tensor:
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return self._parameters.get(name) is not None \
            or name in self._modules


def param(shape, dtype, device, gen: Optional[torch.Generator],
           fill: Optional[float] = None, scale: float = 1.0):
    """One parameter: `fill` everywhere, or N(0, 1) * scale drawn in
    float32 from `gen`, or (neither) uninitialised memory."""
    if fill is not None:
        t = torch.full(shape, fill, dtype=dtype, device=device)
    elif gen is not None:
        t = (torch.randn(shape, generator=gen, dtype=torch.float32)
             * scale).to(device=device, dtype=dtype)
    else:
        t = torch.empty(shape, dtype=dtype, device=device)
    return nn.Parameter(t)


# ----------------------------------------------------------------- norms

def rmsnorm_init(d: int, dtype=torch.float32, device=None) -> Params:
    p = Params()
    p.scale = param((d,), dtype, device, None, fill=0.0)  # (1 + scale)
    return p


def rmsnorm(p, x, eps: float = 1e-6):
    """Gemma-style RMSNorm: y * (1 + scale), statistics in float32."""
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + p["scale"].float())).to(dt)


def layernorm_init(d: int, dtype=torch.float32, device=None) -> Params:
    p = Params()
    p.scale = param((d,), dtype, device, None, fill=1.0)
    p.bias = param((d,), dtype, device, None, fill=0.0)
    return p


def layernorm(p, x, eps: float = 1e-6):
    dt = x.dtype
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(dt)


# ---------------------------------------------------------------- linear

def dense_init(gen, d_in: int, d_out: int, bias: bool = False,
               dtype=torch.float32, scale: Optional[float] = None,
               device=None) -> Params:
    if scale is None:
        scale = d_in ** -0.5
    p = Params()
    p.w = param((d_in, d_out), dtype, device, gen, scale=scale)
    if bias:
        p.b = param((d_out,), dtype, device, None, fill=0.0)
    return p


def dense(p, x, compute_dtype=None):
    """y = x @ w (+ b): W and x cast to the compute dtype, the bias to
    the product's.  Without a compute dtype both take their promoted
    dtype, as JAX's `@` does.  A DTensor product runs on its shards
    (`sharding/hints.py::matmul`, after the cast), a row-parallel
    product's partial sums reduced in the product's dtype (`summed`)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.sharding.hints import matmul, summed

    w = p["w"]
    dt = compute_dtype or torch.promote_types(x.dtype, w.dtype)
    x, w = x.to(dt), w.to(dt)
    if isinstance(x, DTensor) or isinstance(w, DTensor):
        y = summed(matmul(x, w))
    else:
        y = x @ w
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


# ------------------------------------------------------------- embedding

def embedding_init(gen, vocab: int, d: int, dtype=torch.float32,
                   device=None) -> Params:
    """`vocab` = padded table rows."""
    p = Params()
    p.table = param((vocab, d), dtype, device, gen, scale=d ** -0.5)
    return p


def embed(p, ids, compute_dtype):
    """Rows of the table for `ids`, in `compute_dtype` (a DTensor table
    goes through `sharding/hints.py::lookup`)."""
    from repro_torch.sharding.hints import lookup
    return lookup(p["table"], ids, compute_dtype)


def unembed(p, x, n_real: Optional[int] = None):
    """Tied read-out: (..., d) @ (d, vocab) in float32 for a stable
    softmax; rows at or past `n_real` (the padding) read -1e30.  A
    DTensor table keeps its vocab split in the logits
    (`sharding/hints.py::matmul`)."""
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)

    from repro_torch.sharding.hints import matmul, summed

    table = p["table"]
    if isinstance(table, DTensor):
        logits = summed(matmul(x.float(), table.float().T))
    else:
        logits = x.float() @ table.float().T
    v = table.shape[0]
    if n_real is not None and n_real < v:
        live = torch.arange(v, device=logits.device) < n_real
        if isinstance(logits, DTensor):  # split as the logits' vocab
            live = distribute_tensor(live, logits.device_mesh, [
                Shard(0) if p.is_shard(logits.ndim - 1) else Replicate()
                for p in logits.placements], src_data_rank=None)
        logits = torch.where(live, logits, torch.full(
            (), -1e30, dtype=logits.dtype, device=logits.device))
    return logits


# ------------------------------------------------------------------ rope

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Rotary embedding, half-split (not interleaved).  x: (..., S, H, D)
    or (..., S, D); positions (..., S).  Angles in float32, the result
    cast back to x's dtype."""
    d = x.shape[-1]
    half = d // 2
    expo = -torch.arange(0, half, dtype=torch.float32,
                         device=x.device) / half
    # a Python base: a device tensor made from it would be a blocking
    # host-to-device copy on every call
    freq = torch.pow(float(theta), expo)
    ang = positions[..., None].float() * freq  # (..., S, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    if x.ndim == cos.ndim + 1:  # broadcast over a heads axis
        cos, sin = cos[..., None, :], sin[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: Optional[float]):
    """Gemma-2 logit soft-capping: cap * tanh(x / cap)."""
    if cap is None:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)
