"""Meshes: named axes over a grid of devices (importing touches none).

The port's counterpart of the JAX package's `launch/mesh.py` and of
`jax.sharding.Mesh`.  A `Mesh` names its axes and may hold no devices:
the production meshes describe machines this process does not have,
for the dry runs (`launch/teda_dryrun.py`, `launch/dryrun.py`);
`make_host_mesh` lays one over the cards present, or over a list of CPU
entries when the caller asks for one (a repeated device, as in
`sharding/collectives.py`).

`Mesh.device_mesh` turns a mesh into a `torch.distributed` `DeviceMesh`
over the default process group, one rank per mesh entry, for DTensor
placements (`sharding/rules.py::placements`).  The process group comes
from the caller: `one_rank_group` for a one-device mesh, `fake_group`
for a production mesh this process only describes (PyTorch's fake
process group: 256 or 512 ranks whose collectives move nothing, the
counterpart of XLA's virtual host devices), or a launcher's
`init_process_group`.
"""
from __future__ import annotations

import contextlib
import math
import socket
from typing import List, Optional, Sequence

import numpy as np
import torch

__all__ = ["Mesh", "make_host_mesh", "make_production_mesh", "fake_group",
           "one_rank_group"]


class Mesh:
    """Axis sizes `shape` under `axis_names`, and optionally the devices
    laid out on that grid (row-major)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 devices: Optional[Sequence] = None):
        if len(shape) != len(axis_names):
            raise ValueError(f"{len(shape)} sizes for {len(axis_names)} axes")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.devices = None
        if devices is not None:
            devs = [torch.device(d) for d in devices]
            if len(devs) != self.size:
                raise ValueError(f"{len(devs)} devices for a mesh of "
                                 f"{self.size}")
            grid = np.empty(len(devs), dtype=object)
            grid[:] = devs
            self.devices = grid.reshape(tuple(self.shape.values()))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def _names(self, names) -> tuple:
        names = (names,) if isinstance(names, str) else tuple(names)
        unknown = [n for n in names if n not in self.shape]
        if unknown:
            raise ValueError(f"no axis {unknown} in {self.axis_names}")
        return names

    def axis_size(self, names) -> int:
        """The number of shards along an axis name or a tuple of names."""
        return math.prod(self.shape[n] for n in self._names(names))

    def axis_devices(self, names) -> List[torch.device]:
        """The devices along `names` (the first name outermost, as a
        `PartitionSpec` of a tuple of axes splits), the other axes at
        their index 0: the shards a `(names, None)` split of x uses."""
        names = self._names(names)
        if self.devices is None:
            raise ValueError("this mesh describes devices; it holds none")
        index = tuple(slice(None) if n in names else 0
                      for n in self.axis_names)
        kept = [n for n in self.axis_names if n in names]
        grid = np.transpose(self.devices[index],
                            [kept.index(n) for n in names])
        return list(grid.reshape(-1))

    def device_mesh(self, device_type: str = "cuda"):
        """The `DeviceMesh` of this mesh's shape and axis names over the
        default process group, whose world size must be the mesh's
        size (rank r is entry r of the row-major grid)."""
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh

        if not dist.is_initialized():
            raise RuntimeError("Mesh.device_mesh needs a default process "
                               "group (one_rank_group, fake_group or "
                               "init_process_group)")
        if dist.get_world_size() != self.size:
            raise ValueError(f"a mesh of {self.size} needs a world of "
                             f"{self.size}, not {dist.get_world_size()}")
        return init_device_mesh(device_type, tuple(self.shape.values()),
                                mesh_dim_names=self.axis_names)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16 x 16 ("data", "model") or 2 x 16 x 16 ("pod", "data",
    "model"): 256 or 512 GPUs, 32 or 64 nodes of eight H100s, described
    without devices (the reference's 256- and 512-chip TPU meshes)."""
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"))
    return Mesh((16, 16), ("data", "model"))


def make_host_mesh(data: int = 1, model: int = 1, device=None) -> Mesh:
    """A small ("data", "model") mesh over the cards present, clipped to
    their number as the reference clips to its devices; with
    `device="cpu"`, over data * model CPU entries.  Raises when no card
    is present and the caller did not name the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return Mesh((data, model), ("data", "model"),
                    [dev] * (data * model))
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(
            f"make_host_mesh: no CUDA device for {dev}; pass device='cpu' "
            "for a mesh of CPU entries")
    n = torch.cuda.device_count()
    data = min(data, n)
    model = max(1, min(model, n // data))
    return Mesh((data, model), ("data", "model"),
                [torch.device("cuda", i) for i in range(data * model)])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def one_rank_group(device_type: str = "cuda"):
    """A default process group of one rank (NCCL for "cuda", gloo for
    the CPU) on a free localhost port, for a one-device mesh; it is
    destroyed on exit.  Yields False and does nothing when a default
    group already exists."""
    import torch.distributed as dist

    if dist.is_initialized():
        yield False
        return
    backend = "nccl" if device_type == "cuda" else "gloo"
    dist.init_process_group(backend,
                            init_method=f"tcp://127.0.0.1:{_free_port()}",
                            rank=0, world_size=1)
    try:
        yield True
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def fake_group(world_size: int, rank: int = 0):
    """PyTorch's fake process group as the default group: `world_size`
    ranks, this process being `rank`, whose collectives return at once
    with the right shapes and move nothing.  DTensor code then runs one
    rank's share of a production mesh (on meta tensors for a dry run,
    or on the card, where the local shapes are real and the values mean
    nothing).  Its store lives under `torch.testing._internal`, a
    private path: this is the one place that imports it."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_group: a default process group exists")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
