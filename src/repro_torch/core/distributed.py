"""Multi-device TEDA: one logical stream scanned across shards.

The port of the JAX package's `core/distributed.py`.  The time axis of
one stream x (T, N) is cut into D contiguous blocks, one per shard;
each shard runs the parallel scan of `core/scan.py` on its block and
fixes it up to the *global* prefix statistics from tiny O(N) carries
exchanged with three `all_gather`s of O(D * N) in all, independent of
T (block-parallel TEDA, ref [15] of the paper).  It re-scores a long
recorded monitor stream in one sharded pass.

The reference runs one body per device under `shard_map`.  Here the
body is cut at its three gathers into three stage functions, and an
axis of `sharding/collectives.py` carries the gathers between them:

- `make_distributed_teda` / `distributed_teda`: one process drives the
  D shards on a list of devices (`DeviceAxis`; a device may repeat, so
  `["cuda:0"] * 4` runs four shards one after another on one card);
- `distributed_teda_group`: one shard per process of a
  `torch.distributed` group (`GroupAxis`);
- `shard_scan`: the stages over whichever shards an axis holds, which
  both forms and the dry run (`launch/teda_dryrun.py`) call.

The final state is reduced on every shard from all D gathered carries
in device order, so every shard's copy is the same bit for bit.  The
scan starts from a fresh stream, as the reference's does.
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import torch

from repro_torch.core.scan import affine_scan
from repro_torch.core.teda import TedaOutput, TedaState, teda_threshold
from repro_torch.sharding.collectives import DeviceAxis, GroupAxis

__all__ = ["DistributedTeda", "distributed_teda", "distributed_teda_group",
           "make_distributed_teda", "shard_scan"]


class _Block(NamedTuple):
    """What stage 2 leaves for stage 3, per row of one shard's block."""

    k: torch.Tensor  # global sample index, float32 (T_local,)
    d2: torch.Tensor  # ||x_k - mu_k||^2, 0 on the stream's first row
    first_row: torch.Tensor  # k <= 1
    a_scan: torch.Tensor  # the block's inclusive composed variance maps
    b_scan: torch.Tensor


def _sums_stage(x: torch.Tensor) -> torch.Tensor:
    """Stage 1: the block's sum over time, (N,)."""
    return x.sum(0)


def _map_stage(x: torch.Tensor, all_sums: torch.Tensor, idx: int
               ) -> _Block:
    """Stage 2: mean and distance terms at the global k, from the
    exclusive prefix of the gathered sums, and the block's variance
    maps var_k = a_k var_{k-1} + b_k composed by an affine scan."""
    t_local = x.shape[0]
    s_prev = all_sums[:idx].sum(0)  # exclusive prefix over devices
    k_prev = idx * t_local
    k = torch.arange(k_prev + 1, k_prev + t_local + 1,
                     device=x.device).to(x.dtype)
    s = s_prev[None] + torch.cumsum(x, 0)
    mean = s / k[:, None]
    first_row = k <= 1.0
    d2 = torch.where(first_row, 0.0, ((x - mean) ** 2).sum(-1))
    # across a block the composed map's A telescopes to k_prev / k_last
    # (0 on shard 0); B is the block-local scan's last value
    a = torch.where(first_row, 0.0, (k - 1.0) / k)
    b = torch.where(first_row, 0.0, d2 / k)
    a_scan, b_scan = affine_scan(a, b)
    return _Block(k, d2, first_row, a_scan, b_scan)


def _compose(all_a: torch.Tensor, all_b: torch.Tensor, n: int
             ) -> torch.Tensor:
    """The B of the gathered block maps 0..n-1 composed in device order,
    applied to var_0 = 0 (a fresh stream)."""
    bv = torch.zeros((), dtype=all_b.dtype, device=all_b.device)
    for i in range(n):
        bv = bv * all_a[i] + all_b[i]
    return bv


def _verdict_stage(blk: _Block, all_sums: torch.Tensor,
                   all_a: torch.Tensor, all_b: torch.Tensor, idx: int, m
                   ) -> Tuple[TedaState, TedaOutput]:
    """Stage 3: the variance fixed up to the global prefix, the
    replicated final state and the verdicts of eqs (1), (4)-(6)."""
    ndev = all_sums.shape[0]
    k, d2 = blk.k, blk.d2
    var_in = _compose(all_a, all_b, idx)
    var = torch.where(blk.first_row, 0.0, blk.a_scan * var_in + blk.b_scan)

    # every shard reduces the same gathered carries in the same order
    k_total = float(ndev * k.shape[0])
    final = TedaState(
        k=torch.full((), k_total, dtype=k.dtype, device=k.device),
        mean=all_sums.sum(0) / k_total,
        var=_compose(all_a, all_b, ndev))

    safe = var > 0.0
    ecc = 1.0 / k + torch.where(
        safe, d2 / (k * torch.where(safe, var, 1.0)), 0.0)
    zeta = ecc / 2.0
    thr = teda_threshold(k, m)
    outlier = (zeta > thr) & (k >= 2.0)
    out = TedaOutput(ecc=ecc, typ=1.0 - ecc, zeta=zeta, threshold=thr,
                     outlier=outlier, k=k)
    return final, out


def shard_scan(blocks: Sequence[torch.Tensor], m, axis
               ) -> List[Tuple[TedaState, TedaOutput]]:
    """The three stages over the shards `axis` holds: `blocks[j]` is
    shard `axis.shards[j]`'s (T_local, N) block, on its device, and
    every block has the same T_local.  Returns each held shard's
    (final, out)."""
    idxs = axis.shards
    if len(blocks) != len(idxs):
        raise ValueError(f"{len(blocks)} blocks for {len(idxs)} shards")
    xs = [b.to(torch.float32) for b in blocks]
    held = list(enumerate(idxs))  # (position in `blocks`, shard index)

    sums = []
    for j, i in held:
        with axis.on(i):
            sums.append(_sums_stage(xs[j]))
    all_sums = axis.all_gather(sums)
    maps = []
    for j, i in held:
        with axis.on(i):
            maps.append(_map_stage(xs[j], all_sums[j], i))
    all_a = axis.all_gather([blk.a_scan[-1] for blk in maps])
    all_b = axis.all_gather([blk.b_scan[-1] for blk in maps])
    res = []
    for j, i in held:
        with axis.on(i):
            res.append(_verdict_stage(maps[j], all_sums[j], all_a[j],
                                      all_b[j], i, m))
    return res


class DistributedTeda:
    """The sharded scan over a list of devices, shard i on `devices[i]`
    (`make_distributed_teda` builds it).  Calling it on x (T, N) and m
    returns (final, out): shard 0's final state and the six (T,) fields
    of `TedaOutput` on the first device.  `finals` keeps every shard's
    final state of the last call (the reference's replicated output),
    `axis.log` the collectives run."""

    def __init__(self, devices: Sequence):
        self.axis = DeviceAxis(devices)
        self.finals: List[TedaState] = []

    def __call__(self, x, m=3.0) -> Tuple[TedaState, TedaOutput]:
        x = torch.as_tensor(x)
        d = self.axis.size
        if x.ndim != 2 or x.shape[0] % d:
            raise ValueError(
                f"x {tuple(x.shape)}: need (T, N) with T divisible by the "
                f"{d} shards")
        t = x.shape[0] // d
        devs = self.axis.devices
        blocks = [x[i * t:(i + 1) * t].to(devs[i]) for i in range(d)]
        res = shard_scan(blocks, m, self.axis)
        self.finals = [fin for fin, _ in res]
        out = TedaOutput(*(torch.cat([o[f].to(devs[0]) for _, o in res])
                           for f in range(len(TedaOutput._fields))))
        return res[0][0], out


def _axis_devices(mesh, axis_name) -> List[torch.device]:
    """The devices along `axis_name` of a `launch/mesh.py` mesh, or a
    plain device list as it is."""
    if hasattr(mesh, "axis_devices"):
        return mesh.axis_devices(axis_name)
    return [torch.device(d) for d in mesh]


def make_distributed_teda(mesh, axis_name="data") -> DistributedTeda:
    """The sharded scan over `mesh`'s `axis_name` devices (a name or a
    tuple of names; other axes replicate x), or over a device list."""
    return DistributedTeda(_axis_devices(mesh, axis_name))


def distributed_teda(x, m, mesh, axis_name="data"
                     ) -> Tuple[TedaState, TedaOutput]:
    """One-shot convenience wrapper around make_distributed_teda."""
    return make_distributed_teda(mesh, axis_name)(x, m)


def distributed_teda_group(x_local: torch.Tensor, m, group=None
                           ) -> Tuple[TedaState, TedaOutput]:
    """This process's shard of the sharded scan over a `torch.distributed`
    group: `x_local` is the rank's (T / D, N) block (rank r holds rows
    r * T / D onwards; every rank's block has the same length), on the
    device the group's backend works on.  Returns the rank's final
    state (the same on every rank) and its block's outputs."""
    return shard_scan([torch.as_tensor(x_local)], m, GroupAxis(group))[0]
