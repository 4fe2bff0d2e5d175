"""One mesh axis of shards and the collectives across it.

The JAX package runs a per-shard body under `shard_map` and exchanges
values with `jax.lax.all_gather` and `ppermute` along a named mesh axis,
the shard's place on it being `jax.lax.axis_index`.  Here an axis is an
object the per-shard code calls, in three forms:

- `DeviceAxis(devices)`: one process holds all D shards, shard i on
  `devices[i]`.  A device may repeat (the convention of
  `rules.make_channel_fanout`): `["cuda:0"] * 4` is four shards on one
  card, run one after another, and `["cpu"] * 8` eight on the CPU.
- `GroupAxis(group)`: one shard per process of a `torch.distributed`
  group, the shard's index being the process's rank.
- `TraceAxis(size)`: one shard of a group of `size`, traced alone (on
  the meta device for a dry run); its gathers return zeros of the
  gathered shape, so shapes and counts are right and values are not.

Code written against an axis holds a list of blocks, one per shard that
this process holds (`axis.shards`), and passes the list to each
collective, which returns one result per held shard.

Every axis records the collectives it runs in `axis.log` as
(kind, group size, result bytes per shard), the quantities from which
`launch/cost_analysis.py::collective_stats` applies the ring model, as
the reference's `launch/hlo_analysis.py` does to the ops it finds in
XLA's compiled program.  The log counts each collective once per call,
however many shards one process holds.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.sharding.rules import _on

__all__ = ["DeviceAxis", "GroupAxis", "TraceAxis"]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Axis:
    """What the three forms share: `size` (D), the held shard indices
    `shards`, and the log of collectives."""

    size: int
    shards: List[int]

    def __init__(self):
        self.log: List[Tuple[str, int, int]] = []

    def reset(self):
        """Forget the collectives logged so far."""
        self.log.clear()

    def on(self, i: int):
        """The context shard i's work runs in: none here, since the
        process's current device already is the shard's."""
        del i
        return contextlib.nullcontext()

    def _record(self, kind: str, result_bytes: int):
        self.log.append((kind, self.size, result_bytes))


class DeviceAxis(_Axis):
    """D shards driven by one process, shard i on `devices[i]`."""

    def __init__(self, devices: Sequence):
        super().__init__()
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("an axis needs at least one device")
        self.size = len(self.devices)
        self.shards = list(range(self.size))

    def on(self, i: int):
        """The context that makes shard i's device current (the caller's
        comes back on exit)."""
        return _on(self.devices[i])

    def all_gather(self, parts: Sequence[torch.Tensor]
                   ) -> List[torch.Tensor]:
        """`jax.lax.all_gather`: every shard gets the (D, ...) stack of
        all D parts, on its own device."""
        if len(parts) != self.size:
            raise ValueError(f"{len(parts)} parts for {self.size} shards")
        self._record("all-gather", self.size * _nbytes(parts[0]))
        return [torch.stack([p.to(dev) for p in parts])
                for dev in self.devices]

    def ppermute(self, parts: Sequence[Optional[torch.Tensor]],
                 perm: Sequence[Tuple[int, int]]
                 ) -> List[Optional[torch.Tensor]]:
        """`jax.lax.ppermute`: shard dst gets shard src's part, copied
        to its device, for each (src, dst) in `perm` whose part is not
        None; the other shards get None (where `ppermute` gives zeros)."""
        out: List[Optional[torch.Tensor]] = [None] * self.size
        moved = 0
        for src, dst in perm:
            if parts[src] is not None:
                out[dst] = parts[src].to(self.devices[dst])
                moved = max(moved, _nbytes(parts[src]))
        self._record("collective-permute", moved)
        return out


class GroupAxis(_Axis):
    """One shard per process of the `torch.distributed` group `group`
    (the default group when None); the shard's index is the rank."""

    def __init__(self, group=None):
        super().__init__()
        self.group = group
        self.size = dist.get_world_size(group)
        self.shards = [dist.get_rank(group)]

    def all_gather(self, parts: Sequence[torch.Tensor]
                   ) -> List[torch.Tensor]:
        (part,) = parts
        self._record("all-gather", self.size * _nbytes(part))
        flat = part.reshape(-1).contiguous()  # a 0-d part travels as (1,)
        got = [torch.empty_like(flat) for _ in range(self.size)]
        # the list form: gloo has no all_gather_into_tensor
        dist.all_gather(got, flat, group=self.group)
        return [torch.stack(got).reshape((self.size,) + tuple(part.shape))]


class TraceAxis(_Axis):
    """The last shard of a group of `size` (it composes the most
    carries), traced alone: gathers return (size, ...) zeros on the
    part's device."""

    def __init__(self, size: int):
        super().__init__()
        self.size = int(size)
        self.shards = [self.size - 1]

    def all_gather(self, parts: Sequence[torch.Tensor]
                   ) -> List[torch.Tensor]:
        (part,) = parts
        self._record("all-gather", self.size * _nbytes(part))
        return [part.new_zeros((self.size,) + tuple(part.shape))]
