"""Collective traffic, operation and byte counts, and roofline terms.

The port's counterpart of the JAX package's `launch/hlo_analysis.py`.
The reference parses XLA's optimized HLO for its collectives and asks
the compiled program for flops and bytes.  Here:

- the axes of `sharding/collectives.py` log each collective as it runs,
  and so does `LocalOpCounter` for DTensor's functional collectives
  (`_c10d_functional.*`, the traffic of a redistribution);
  `collective_stats` sums a log with the reference's ring model (n =
  the group's size, the bytes those of one shard's result):

      all-gather         (n-1)/n  * result_bytes
      reduce-scatter     (n-1)    * result_bytes
      all-reduce         2(n-1)/n * result_bytes
      all-to-all         (n-1)/n  * result_bytes
      collective-permute 1.0      * result_bytes

  The reference counts the ops in a compiled program (an op inside a
  loop once); the log counts the calls that ran.  A redistribution
  from Shard(i) to Shard(j) is one all-to-all of the local result's
  bytes, as a card runs it, also where a CPU device mesh sends it as an
  all-gather and a chunk (`LocalOpCounter` logs the all-to-all in place
  of that all-gather).
- `OpCounter` counts the aten operations of a traced run by this
  module's own rule: 2 per multiply-add of a matrix product (mm, bmm,
  addmm, baddbmm, convolutions and attention, by the formulas of
  `torch.utils.flop_counter`), one operation per output element of a
  pointwise op or a scan (cumsum, cumprod), one per input element of a
  reduction, none for views, copies and fills; bytes are each op's
  tensor inputs plus its outputs, none for views.  XLA counts fused
  programs, so the two counts are not comparable.
- `LocalOpCounter` counts one device's share of a DTensor program: the
  local ops each rank runs on its shards, not the DTensor-level op at
  global shape, and not the op DTensor's sharding propagation runs on
  fake tensors to learn the output's global shape.  It also keeps the
  high-water mark of the bytes the local ops' outputs hold alive.

Hardware constants, one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the 700 W power limit): 989e12 bf16 FLOP/s, 3.35e12 B/s of
HBM3, NVLink 4 with 18 links of 25 GB/s per direction.
"""
from __future__ import annotations

import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["PEAK_FLOPS", "HBM_BW", "NVLINK_BW", "OpCounter",
           "LocalOpCounter", "collective_stats", "roofline_terms"]

PEAK_FLOPS = 989e12  # bf16 / card, dense
HBM_BW = 3.35e12  # bytes/s / card (chip_smoke.py's HBM_BYTES_PER_S)
NVLINK_BW = 25e9  # bytes/s / link, one direction

_RING_FACTOR = {
    "all-gather": lambda n: (n - 1) / n,
    "reduce-scatter": lambda n: float(n - 1),
    "all-reduce": lambda n: 2 * (n - 1) / n,
    "all-to-all": lambda n: (n - 1) / n,
    "collective-permute": lambda n: 1.0,
}


def collective_stats(axis) -> Dict[str, float]:
    """Per-kind ring-model bytes and op counts of the collectives `axis`
    logged (an axis of `sharding/collectives.py` or a `LocalOpCounter`:
    anything with a `log` of (kind, n, result bytes)), under the
    reference's keys ("all-gather", "all-gather_count",
    "collective-permute", ..., "total_bytes")."""
    stats: Dict[str, float] = {}
    counts: Dict[str, int] = {}
    for kind, n, size in axis.log:
        stats[kind] = stats.get(kind, 0.0) + size * _RING_FACTOR[kind](n)
        counts[kind + "_count"] = counts.get(kind + "_count", 0) + 1
    stats["total_bytes"] = sum(stats.values())
    stats.update(counts)
    return stats


def roofline_terms(flops_per_device: float, bytes_per_device: float,
                   collective_bytes_per_device: float,
                   links_per_chip: float = 18.0) -> Dict[str, float]:
    """The three roofline terms in seconds/card + dominant bottleneck."""
    compute_s = flops_per_device / PEAK_FLOPS
    memory_s = bytes_per_device / HBM_BW
    collective_s = collective_bytes_per_device / (NVLINK_BW * links_per_chip)
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dom = max(terms, key=terms.get)
    bound = max(terms.values())
    terms["bottleneck"] = dom.replace("_s", "")
    terms["step_time_lower_bound_s"] = bound
    # roofline fraction: how much of the bound is the compute term
    terms["roofline_fraction"] = (compute_s / bound) if bound > 0 else 0.0
    return terms


_SCANS = {torch.ops.aten.cumsum.default, torch.ops.aten.cumprod.default}


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _bytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


class OpCounter(TorchDispatchMode):
    """Counts `flops` and `bytes` of the aten ops run inside it, by the
    rule of this module's docstring (works on meta tensors)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0

    def _count(self, func, args, kwargs, out):
        if func.is_view:
            return
        ins = list(_tensors(list(args) + list(kwargs.values())))
        outs = list(_tensors(out))
        self.bytes += _bytes(ins) + _bytes(outs)
        from torch.utils.flop_counter import flop_registry

        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        elif torch.Tag.reduction in func.tags and ins:
            self.flops += ins[0].numel()
        elif torch.Tag.pointwise in func.tags or func in _SCANS:
            self.flops += sum(t.numel() for t in outs)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out


# DTensor's functional collectives, by the reference's kind names
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
}


def _group_size(group_name: str) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(group_name).size()


class LocalOpCounter(OpCounter):
    """One device's `flops`, `bytes`, collective `log` (kind, group
    size, result bytes) and `peak_bytes` of a DTensor program run inside
    it.  DTensor-level ops are handed back (`NotImplemented`) so that
    the DTensor subclass runs them and this mode sees the local ops they
    become.  DTensor's sharding propagation runs ops at global shape to
    learn an output's shape (on fake tensors, or on meta tensors when it
    derives a strategy from an op's decomposition); those are not
    counted: ops under a fake mode are skipped, and while the counter
    is active the decomposition-based strategy (the private
    `DecompShardingStrategy.propagate_strategy`, in torch releases that
    have it) is marked.  A Shard(i) to Shard(j) redistribution is
    logged as one all-to-all of its local result (DTensor's
    `shard_dim_alltoall`, patched while the counter is active).
    `peak_bytes` is the most bytes that the outputs of counted non-view
    ops held alive at once, each released when its tensor is freed (a
    finalizer on the tensor): the local trace's live-bytes high-water
    mark, arguments not included."""

    def __init__(self):
        super().__init__()
        self.log = []
        self.live_bytes = 0
        self.peak_bytes = 0
        self._propagating = 0
        self._patched = []

    def _patch(self, owner, name, wrap):
        plain = getattr(owner, name)
        self._patched.append((owner, name, plain))
        setattr(owner, name, wrap(plain))

    def __enter__(self):
        from torch.distributed.tensor import placement_types

        def marked(plain):
            def propagate(this, *args, **kwargs):
                self._propagating += 1
                try:
                    return plain(this, *args, **kwargs)
                finally:
                    self._propagating -= 1
            return propagate

        def all_to_all(plain):
            def shard_to_shard(x, gather_dim, shard_dim, mesh, mesh_dim):
                mark = len(self.log)
                out = plain(x, gather_dim, shard_dim, mesh, mesh_dim)
                del self.log[mark:]  # a CPU mesh's all-gather standing in
                self.log.append(("all-to-all", mesh.size(mesh_dim),
                                 out.numel() * out.element_size()))
                return out
            return shard_to_shard

        try:
            from torch.distributed.tensor._decompositions import (
                DecompShardingStrategy)
            self._patch(DecompShardingStrategy, "propagate_strategy", marked)
        except ImportError:  # a release without decomposition strategies
            pass
        if hasattr(placement_types, "shard_dim_alltoall"):
            self._patch(placement_types, "shard_dim_alltoall", all_to_all)
        return super().__enter__()

    def __exit__(self, *exc):
        while self._patched:
            owner, name, plain = self._patched.pop()
            setattr(owner, name, plain)
        return super().__exit__(*exc)

    def _release(self, n: int):
        self.live_bytes -= n

    def _hold(self, out):
        for t in _tensors(out):
            n = t.numel() * t.element_size()
            self.live_bytes += n
            weakref.finalize(t, self._release, n)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._propagating or torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is not None:
            return out
        if func.namespace == "_c10d_functional":
            # the collective's traffic goes to the log; its wait and
            # autograd wrap hand the same tensor on
            kind = _COLLECTIVES.get(func._opname)
            if kind is not None:
                n = _group_size(args[-1])
                for t in _tensors(out):
                    self.log.append((kind, n, t.numel() * t.element_size()))
                self._hold(out)
            return out
        self._count(func, args, kwargs, out)
        if not func.is_view:
            self._hold(out)
        return out
