"""Meshes: named axes over a grid of devices (importing touches none).

The port's counterpart of the JAX package's `launch/mesh.py` and of
`jax.sharding.Mesh`.  A `Mesh` names its axes and may hold no devices:
the production meshes describe machines this process does not have,
for the dry run (`launch/teda_dryrun.py`); `make_host_mesh` lays one
over the cards present, or over a list of CPU entries when the caller
asks for one (a repeated device, as in `sharding/collectives.py`).
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch

__all__ = ["Mesh", "make_host_mesh", "make_production_mesh"]


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
