"""Dry run of the paper's technique itself on the production meshes.

The port of the JAX package's `launch/teda_dryrun.py`.  The reference
compiles the distributed TEDA scan (`core/distributed.py`) for the
256- and 512-device meshes and reads per-device flops, bytes, temporary
memory and collective traffic from XLA.  Here one shard's three stages
(`core/distributed.py::shard_scan`) are traced on the meta device with
a `TraceAxis` of the gather group's size, "data" (16) or "pod" x "data"
(32); the "model" axis replicates x, as in the reference.  The shard
traced is the group's last (`TraceAxis`).  Counts:

- `collectives`: the axis's log under the reference's ring model; it
  equals the reference's;
- `flops_per_device`, `bytes_per_device`: `OpCounter`'s rule
  (`launch/cost_analysis.py`), not XLA's fused count;
- `temp_bytes`: None, meta tensors hold no memory (`chip_smoke.py`
  phase 11 (d) measures one shard's peak on the card);
- `t_per_device`: t_total over all devices, as the reference reports
  it, though a shard holds t_total over the gather group's size.

  PYTHONPATH=src python -m repro_torch.launch.teda_dryrun --t 1048576 \\
      --out /tmp/teda_dryrun.json
"""
from __future__ import annotations

import argparse
import json
import os

import torch

from repro_torch.core.distributed import shard_scan
from repro_torch.launch.cost_analysis import (OpCounter, collective_stats,
                                              roofline_terms)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.sharding.collectives import TraceAxis

__all__ = ["run", "main"]


def run(multi_pod: bool, t_total: int, n_feat: int) -> dict:
    mesh = make_production_mesh(multi_pod=multi_pod)
    n_dev = mesh.size
    axes = ("pod", "data") if multi_pod else ("data",)
    group = mesh.axis_size(axes)
    if t_total % group:
        raise ValueError(f"t_total {t_total} is not divisible by the "
                         f"{group} shards of {axes}")
    axis = TraceAxis(group)
    x = torch.empty((t_total // group, n_feat), dtype=torch.float32,
                    device="meta")
    with OpCounter() as ops:
        shard_scan([x], 3.0, axis)
    coll = collective_stats(axis)
    terms = roofline_terms(float(ops.flops), float(ops.bytes),
                           coll.get("total_bytes", 0.0))
    return {
        "mesh": "multi" if multi_pod else "single",
        "devices": n_dev,
        "t_total": t_total, "n_feat": n_feat,
        "t_per_device": t_total // n_dev,
        "flops_per_device": float(ops.flops),
        "bytes_per_device": float(ops.bytes),
        "collectives": coll,
        "temp_bytes": None,
        "roofline": terms,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--t", type=int, default=1 << 24)  # 16.7M samples
    ap.add_argument("--feat", type=int, default=4)
    ap.add_argument("--out", default="experiments/teda_dryrun.json")
    args = ap.parse_args(argv)
    results = []
    for multi in (False, True):
        r = run(multi, args.t, args.feat)
        results.append(r)
        print(f"[{r['mesh']}] devices={r['devices']} "
              f"T/dev={r['t_per_device']} "
              f"coll_bytes={r['collectives'].get('total_bytes', 0):.0f} "
              f"({r['collectives']}) temp=not measured (meta)")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
