"""Collective traffic, operation and byte counts, and roofline terms.

The port's counterpart of the JAX package's `launch/hlo_analysis.py`.
The reference parses XLA's optimized HLO for its collectives and asks
the compiled program for flops and bytes.  Here:

- the axes of `sharding/collectives.py` log each collective as it runs,
  and `collective_stats` sums the log with the reference's ring model
  (n = the axis's size, the bytes those of one shard's result):

      all-gather         (n-1)/n * result_bytes
      collective-permute 1.0     * result_bytes

  The reference counts the ops in a compiled program (an op inside a
  loop once); the log counts the calls that ran.
- `OpCounter` counts the aten operations of a traced run by this
  module's own rule: one operation per output element of a pointwise
  op or a scan (cumsum, cumprod), one per input element of a reduction,
  none for views, copies and fills; bytes are each op's tensor inputs
  plus its outputs, none for views.  XLA counts fused programs, so the
  two counts are not comparable.

Hardware constants, one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the 700 W power limit): 989e12 bf16 FLOP/s, 3.35e12 B/s of
HBM3, NVLink 4 with 18 links of 25 GB/s per direction.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["PEAK_FLOPS", "HBM_BW", "NVLINK_BW", "OpCounter",
           "collective_stats", "roofline_terms"]

PEAK_FLOPS = 989e12  # bf16 / card, dense
HBM_BW = 3.35e12  # bytes/s / card (chip_smoke.py's HBM_BYTES_PER_S)
NVLINK_BW = 25e9  # bytes/s / link, one direction

_RING_FACTOR = {
    "all-gather": lambda n: (n - 1) / n,
    "collective-permute": lambda n: 1.0,
}


def collective_stats(axis) -> Dict[str, float]:
    """Per-kind ring-model bytes and op counts of the collectives `axis`
    logged, under the reference's keys ("all-gather",
    "all-gather_count", "collective-permute", ..., "total_bytes")."""
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

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view:
            return out
        ins = list(_tensors(list(args) + list((kwargs or {}).values())))
        outs = list(_tensors(out))
        self.bytes += _bytes(ins) + _bytes(outs)
        if torch.Tag.reduction in func.tags and ins:
            self.flops += ins[0].numel()
        elif torch.Tag.pointwise in func.tags or func in _SCANS:
            self.flops += sum(t.numel() for t in outs)
        return out
