"""GPipe-style pipeline parallelism over a list of devices.

The port of the JAX package's `sharding/pipeline.py`.  Stage s holds
1/S of the layer stack on `devices[s]`; microbatches stream through the
stages and the schedule runs M + S - 1 ticks (fill + drain bubble).  At
each tick every stage with a microbatch in hand applies `stage_fn`,
then each output is copied to the next stage's device: the reference's
`ppermute` handoff (the last stage's output wraps to stage 0, where it
is the finished microbatch), counted by the `DeviceAxis` as a
collective-permute.  The reference's SPMD stages also compute in the
bubble, on inputs that are thrown away; here a stage without a
microbatch does nothing.  Devices may repeat (`["cuda:0"] * 4` runs
the four stages on one card).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from repro_torch.sharding.collectives import DeviceAxis

__all__ = ["Pipelined", "make_pipelined", "pipeline_forward"]


def pipeline_forward(stage_fn: Callable, n_stages: int, axis: DeviceAxis):
    """The pipelined forward over `axis` (one shard per stage).

    stage_fn(stage_params, x) -> x is applied by stage s, with its own
    `stage_params[s]` (placed on `axis.devices[s]` by the caller), to
    each microbatch passing through.  Input x: (M, mb, ...) microbatched
    on the leading axis.  Returns the (M, mb, ...) outputs on the first
    device.
    """
    if axis.size != n_stages:
        raise ValueError(f"{n_stages} stages over {axis.size} devices")
    devs = axis.devices
    wrap = [(s, (s + 1) % n_stages) for s in range(n_stages)]

    def run(stage_params: Sequence, x: torch.Tensor) -> torch.Tensor:
        m = x.shape[0]
        x = x.to(devs[0])
        outs = torch.zeros_like(x)
        inbox: List[Optional[torch.Tensor]] = [None] * n_stages
        for t in range(m + n_stages - 1):
            inbox[0] = x[t] if t < m else None  # stage 0 ingests mb t
            ys: List[Optional[torch.Tensor]] = [None] * n_stages
            for s in range(n_stages):
                if inbox[s] is not None:
                    with axis.on(s):
                        ys[s] = stage_fn(stage_params[s], inbox[s])
            inbox = axis.ppermute(ys, wrap)
            # what wraps to stage 0 is microbatch t - (S - 1), finished
            if t >= n_stages - 1:
                outs[t - (n_stages - 1)] = inbox[0]
        return outs

    return run


class Pipelined:
    """`make_pipelined`'s callable: `self(stage_params, x)`, where
    `stage_params` is a tensor stacked (S, ...), whose row s is stage
    s's (the reference's `shard_map` hands a stage its (1, ...) block),
    or a sequence of S per-stage parameters; tensors among them are
    moved to their stage's device, anything else (a module list, say)
    is used as given.  `axis.log` counts the handoffs, one permute per
    tick."""

    def __init__(self, devices: Sequence, stage_fn: Callable, n_stages: int):
        self.axis = DeviceAxis(devices)
        self._run = pipeline_forward(stage_fn, n_stages, self.axis)

    def __call__(self, stage_params, x: torch.Tensor) -> torch.Tensor:
        if len(stage_params) != self.axis.size:
            raise ValueError(f"{len(stage_params)} stage parameters for "
                             f"{self.axis.size} stages")
        placed = [p.to(dev) if isinstance(p, torch.Tensor) else p
                  for p, dev in zip(stage_params, self.axis.devices)]
        return self._run(placed, x)


def make_pipelined(mesh_or_devices, stage_fn: Callable, n_stages: int,
                   axis: str = "pipe") -> Pipelined:
    """The pipeline over `mesh_or_devices`: a `launch/mesh.py` mesh (its
    `axis` devices) or a device list, one device per stage."""
    if hasattr(mesh_or_devices, "axis_devices"):
        devices = mesh_or_devices.axis_devices(axis)
    else:
        devices = list(mesh_or_devices)
    return Pipelined(devices, stage_fn, n_stages)
