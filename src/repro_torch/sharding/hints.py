"""Activation-sharding hints (Megatron-style sequence parallelism).

The port's counterpart of the JAX package's `sharding/hints.py`.  DTensor
propagates the parameters' placements through the step the way GSPMD
propagates shardings, and the residual stream (B, S, D) can end up
batch-only sharded, replicated across the `model` axis.  The hint is a
redistribution of the residual between blocks (`DTensor.redistribute`
where the reference calls `with_sharding_constraint`): batch over the
data-parallel axes, and with sequence parallelism the sequence over
"model".

Model code stays mesh-agnostic: it calls `maybe_shard(x, "residual")`,
a no-op unless the caller installed a context with
`activation_hints(mesh, sp=...)` (a contextvar) and x is a DTensor.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.sharding.rules import Spec, dp_axes, placements

__all__ = ["activation_hints", "sp_enabled", "residual_spec", "maybe_shard",
           "lookup", "write_slot", "ViewResharding"]

_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "activation_hints", default=None)


class _Hints:
    def __init__(self, mesh, sp: bool):
        self.mesh, self.sp = mesh, sp


@contextlib.contextmanager
def activation_hints(mesh, sp: bool = True):
    """Install residual hints for `mesh` (a `launch/mesh.py::Mesh`)."""
    tok = _CTX.set(_Hints(mesh, sp))
    try:
        yield
    finally:
        _CTX.reset(tok)


def sp_enabled() -> bool:
    h = _CTX.get()
    return bool(h and h.sp)


def residual_spec(mesh, shape, sp: bool) -> Spec:
    """The reference's residual spec for a (B, S, D) activation: batch
    over the dp axes when they divide it (else over "data", else
    replicated); with `sp`, the sequence over "model" when it divides
    into more than one piece."""
    b, s, _ = shape
    sizes = dict(mesh.shape)
    msz = sizes.get("model", 1)
    dp = dp_axes(mesh)
    dp_total = 1
    for a in dp:
        dp_total *= sizes[a]
    if dp_total > 1 and b % dp_total == 0:
        bspec = dp[0] if len(dp) == 1 else dp
    elif b % sizes.get("data", 1) == 0 and sizes.get("data", 1) > 1:
        bspec = "data"
    else:
        bspec = None
    if sp and s % msz == 0 and s > msz:
        return (bspec, "model", None)
    return (bspec, None, None)


def maybe_shard(x, kind: str = "residual"):
    """Redistribute x to the spec for `kind` when hints are active and x
    is a DTensor; otherwise return x as it is."""
    from torch.distributed.tensor import DTensor

    h: Optional[_Hints] = _CTX.get()
    if h is None or not isinstance(x, DTensor):
        return x
    if kind == "residual" and x.ndim == 3:
        spec = residual_spec(h.mesh, tuple(x.shape), h.sp)
        return x.redistribute(x.device_mesh, placements(h.mesh, spec))
    return x


def lookup(table, ids):
    """`F.embedding(ids, table)`; a DTensor table is first gathered
    along its rows (the vocab), its columns kept as they are split.
    Over vocab-split rows DTensor's lookup leaves a masked partial sum
    whose mask follows the ids as they come (a second reader finds it
    released, ids split over an axis the table is also split on give it
    the wrong shape) and whose backward DTensor cannot redistribute."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.nn import functional as F

    if isinstance(table, DTensor):
        table = table.redistribute(table.device_mesh, [
            Replicate() if p.is_shard(0) else p for p in table.placements])
    return F.embedding(ids, table)


_VIEWS = {torch.ops.aten.view.default, torch.ops.aten._unsafe_view.default,
          torch.ops.aten.reshape.default}


def _touched(old, new) -> range:
    """The dims of shape `old` that a view to `new` splits or merges:
    those between the longest common prefix and suffix."""
    lo = 0
    while lo < min(len(old), len(new)) and old[lo] == new[lo]:
        lo += 1
    hi = 0
    while (hi < min(len(old), len(new)) - lo
           and old[len(old) - 1 - hi] == new[len(new) - 1 - hi]):
        hi += 1
    return range(lo, len(old) - hi)


def write_slot(cache, slot, value):
    """`cache[:, slot] = value` in place: `cache` (B, S, ...), `slot` a
    1-element index tensor, `value` (B, 1, ...).  A DTensor cache is
    written shard by shard (DTensor has no sharding rule for
    `index_copy_` in every torch release): `value` is placed as the
    cache is, and a cache split along S writes the slot in the shard
    that holds it (a select over its positions, no host sync)."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    if not isinstance(cache, DTensor):
        cache.index_copy_(1, slot, value)
        return
    place = [Replicate() if p.is_shard(1) else p for p in cache.placements]
    if not isinstance(value, DTensor):
        value = DTensor.from_local(value, cache.device_mesh,
                                   [Replicate()] * len(place),
                                   run_check=False)
    v = value.redistribute(cache.device_mesh, place).to_local()
    local = cache.to_local()
    if not any(p.is_shard(1) for p in cache.placements):
        local.index_copy_(1, slot, v)
        return
    _, offset = compute_local_shape_and_global_offset(
        cache.shape, cache.device_mesh, cache.placements)
    where = torch.arange(local.shape[1], device=local.device) + offset[1]
    hit = (where == slot).reshape((1, -1) + (1,) * (local.ndim - 2))
    local.copy_(torch.where(hit, v, local))


# DTensor's refusals of a view its shards cannot follow ("Cannot
# unflatten unevenly sharded tensor", "Attempted to flatten multiple
# dimensions ... without redistribution", "Attempted to split the
# sharded dimension ...": the wording differs between torch releases)
_VIEW_REFUSALS = ("unevenly sharded", "without redistribution",
                  "redistribute the tensor")


def _refused(e: RuntimeError) -> bool:
    return any(m in str(e) for m in _VIEW_REFUSALS)


def _replicated(x, dims=None):
    """x with its shards on `dims` (every dim when None), and then its
    pending sums, replicated."""
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh, [
        Replicate() if (p.is_shard() and (dims is None or p.dim in dims))
        or (dims is None and p.is_partial()) else p for p in x.placements])


class ViewResharding(TorchDispatchMode):
    """Views of a DTensor that its shards cannot follow (the reference's
    GSPMD reshards them; DTensor refuses: "Cannot unflatten unevenly
    sharded tensor", e.g. 8 KV heads x 64 split from a dim of 512 over
    16 shards, or a flatten across a sharded dim) are retried with the
    split or merged dims replicated.  A composite op whose
    decomposition meets such a view inside DTensor (an einsum's
    reshapes) is decomposed here, so that its views are retried the
    same way (without a decomposition its DTensor arguments are
    replicated).  A
    dispatch mode, so that it also holds in the backward's
    recomputation of a checkpointed block."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if not any(issubclass(t, DTensor) for t in types):
            return func(*args, **kwargs)
        try:
            return func(*args, **kwargs)
        except RuntimeError as e:
            if not _refused(e):
                raise
        if func in _VIEWS and isinstance(args[0], DTensor):
            x = args[0]
            new = torch.empty(x.shape, device="meta").view(args[1]).shape
            dims = _touched(tuple(x.shape), tuple(new))
            return func(_replicated(x, dims), *args[1:], **kwargs)
        # a composite op: its decomposition's views pass through a mode
        # of their own; without one, its arguments are replicated
        with ViewResharding():
            out = func.decompose(*args, **kwargs)
        if out is not NotImplemented:
            return out
        args = [_replicated(a) if isinstance(a, DTensor) else a
                for a in args]
        return func(*args, **kwargs)
