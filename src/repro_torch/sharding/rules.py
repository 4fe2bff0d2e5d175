"""The channel fan-out: one stream-processor call split over devices.

The JAX package fans `StreamEngine`'s chunk processing out over a mesh
axis with `shard_map` (`sharding/rules.py::make_channel_fanout` there).
Channels are independent TEDA modules (the paper's replicated-module
scaling), so the split needs no collectives: each device runs the same
function on its contiguous slice of channels.  Here the mesh becomes a
plain list of torch devices, and each group's call runs on its device's
current stream under `torch.cuda.device(d)`.

A device may appear more than once in the list.  That is how a split is
exercised where fewer devices exist than groups: the CPU tests run
`["cpu", "cpu"]` (torch has no counterpart of XLA's virtual host
devices, `--xla_force_host_platform_device_count`, which the reference's
tests use), and a one-card machine runs `["cuda:0", "cuda:0"]`.
"""
from __future__ import annotations

import contextlib
from typing import Callable, List, Sequence

import numpy as np
import torch

__all__ = ["group_size", "make_channel_fanout"]


def group_size(capacity: int, n_groups: int) -> int:
    """Channels per group of an even split; raises when `capacity` does
    not divide into `n_groups` groups."""
    if n_groups < 1:
        raise ValueError(f"need at least one device, got {n_groups}")
    if capacity % n_groups:
        raise ValueError(
            f"capacity {capacity} not divisible by the device split "
            f"({n_groups} shards)")
    return capacity // n_groups


def _on(dev: torch.device):
    """The context that makes `dev` the current CUDA device (a no-op for
    other devices); it restores the caller's device on exit."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def _part(v, g: int, lo: int, hi: int, c: int, dev: torch.device):
    """Group g's share of one argument: lists are already split (entry
    g, on its device); arrays whose last axis has `c` entries are sliced
    to [lo, hi) on that axis and moved to `dev`; anything else (None,
    scalars, 0-d values) passes unchanged."""
    if isinstance(v, (list, tuple)):
        return v[g]
    if isinstance(v, np.ndarray) and v.ndim and v.shape[-1] == c:
        return torch.as_tensor(np.ascontiguousarray(v[..., lo:hi]),
                               device=dev)
    if isinstance(v, torch.Tensor) and v.ndim and v.shape[-1] == c:
        return v[..., lo:hi].to(dev)
    return v


def make_channel_fanout(fn: Callable, devices: Sequence) -> Callable:
    """Split `fn` over contiguous channel groups, one per device.

    `fn(*args) -> (carry, out)`: the first argument is the (T, C) chunk
    with C independent channels on its last axis; the others are (C,)
    rows (state, valid lengths, per-channel m), per-group lists, or
    values every group shares.  Each group g of C / D channels calls
    `fn` on its slices, moved to `devices[g]`.  The fanned function
    returns `(carries, out)`: `carries` lists the groups' carries (each
    left on its own device) and `out`, a dict of arrays with the channel
    axis last, holds each entry concatenated over the groups on
    `devices[0]`.  C must divide by D (`group_size`).
    """
    devs: List[torch.device] = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("make_channel_fanout needs at least one device")

    def fanned(x, *rows):
        c = x.shape[-1]
        per = group_size(c, len(devs))
        carries, outs = [], []
        for g, dev in enumerate(devs):
            lo, hi = g * per, (g + 1) * per
            with _on(dev):
                carry, out = fn(*(_part(v, g, lo, hi, c, dev)
                                  for v in (x,) + rows))
            carries.append(carry)
            outs.append(out)
        home = devs[0]
        gathered = {key: torch.cat([o[key].to(home) for o in outs], dim=-1)
                    for key in outs[0]}
        return carries, gathered

    return fanned
