"""End-to-end training loop with TEDA guard + fault tolerance.

Runs on the card (the default) or, when asked, on the CPU.  Integrates:

  * TEDAGuard inside the train step (loss/grad-norm anomaly -> masked
    update, decided on the device),
  * host-side StragglerDetector on per-step wall time,
  * CheckpointManager (atomic, async, keep-K, auto-resume),
  * TokenStream data pipeline,
  * crash-and-resume: `--steps N --resume` continues from the latest
    checkpoint with the same data order.

With a mesh (`train(..., mesh=)`) the step runs on DTensors over the
mesh's `DeviceMesh`: the batch placed by `sharding/rules.py::batch_spec`,
the parameters and the optimizer and guard states replicated, as the
reference's `train` places them.  `--production-mesh` trains on the
16 x 16 production mesh: launched as 256 ranks (torchrun's WORLD_SIZE,
RANK, LOCAL_RANK, MASTER_ADDR and MASTER_PORT), one card each; any
other world size is refused.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
      --scale tiny --steps 30 --batch 8 --seq 128 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --scale full \
      --steps 24                              # on the card
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.registry import get_config
from repro_torch.core.guard import StragglerDetector, guard_init
from repro_torch.data import TokenStream
from repro_torch.engine.engine import resolve_device
from repro_torch.launch.mesh import make_production_mesh, one_rank_group
from repro_torch.launch.specs import (GUARD_CFG, Placer, distribute_model,
                                      make_train_step, on_dtensors)
from repro_torch.models import init_encdec_params, init_lm_params
from repro_torch.optim import adamw
from repro_torch.sharding.rules import batch_spec
from repro_torch.tree import tree_map

__all__ = ["build_state", "train", "scaled_config", "main"]


def build_state(cfg, seed: int = 0, device=None, guard_cfg=None):
    """(model, optimizer state, guard state) on `device`: an `EncDec`
    for the encoder-decoder family, else an `LM`."""
    init = init_encdec_params if cfg.family == "encdec" else init_lm_params
    model = init(seed, cfg, device)
    params = dict(model.named_parameters())
    return model, adamw.init(params), guard_init(guard_cfg or GUARD_CFG,
                                                 device)


def _local(t):
    """A replicated DTensor's full local tensor (its storage); any other
    value as it is."""
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def _state_tree(model, opt_state, guard_state):
    return tree_map(_local, (dict(model.named_parameters()), opt_state,
                             guard_state))


def _full(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _on_mesh(mesh, dev, model, opt_state):
    """The parameters and moments as DTensors replicated over `mesh`'s
    `DeviceMesh` (the counts and the guard state stay plain tensors,
    which the step reads as replicated); returns the placer and the
    optimizer state."""
    place = Placer(mesh, mesh.device_mesh(dev.type))
    distribute_model(model, place,
                     {n: () for n, _ in model.named_parameters()})
    opt_state = opt_state._replace(**{
        f: {n: place(t, ()) for n, t in getattr(opt_state, f).items()}
        for f in ("m", "v")})
    return place, opt_state


def train(cfg, steps: int, batch: int, seq: int, ckpt_dir: str | None,
          resume: bool = False, device=None, corrupt_prob: float = 0.0,
          log_every: int = 10, opt_cfg: adamw.AdamWConfig | None = None,
          save_every: int = 200, guard_cfg=None, corrupt_every: int = 0,
          mesh=None):
    """Train for `steps` steps (from the latest checkpoint when
    `resume`).  Returns (model, history, summary): one dict of host
    floats per step run, and the guard's and the straggler detector's
    totals with each step's seconds as the straggler detector timed
    them (`step_s`).  An encoder-decoder config fails at its first step
    with a KeyError, as the reference's `train` does: `TokenStream`
    yields no `src_emb` (ROADMAP.md queue 3).

    `mesh` (a `launch/mesh.py::Mesh`) runs the step on DTensors (the
    module docstring); the default process group must have one rank
    per mesh entry, and a one-device mesh without a group gets a
    one-rank group for the run (NCCL on the card, gloo on the CPU).
    The returned model holds plain parameters again (the replicated
    DTensors' local tensors)."""
    dev = resolve_device(device)
    group = (one_rank_group(dev.type) if mesh is not None and mesh.size == 1
             else contextlib.nullcontext())
    with group:
        return _train(cfg, steps, batch, seq, ckpt_dir, resume, dev,
                      corrupt_prob, log_every, opt_cfg, save_every,
                      guard_cfg, corrupt_every, mesh)


def _train(cfg, steps, batch, seq, ckpt_dir, resume, dev, corrupt_prob,
           log_every, opt_cfg, save_every, guard_cfg, corrupt_every, mesh):
    opt_cfg = opt_cfg or adamw.AdamWConfig(
        warmup_steps=min(100, steps // 4 + 1), total_steps=steps)
    guard_cfg = guard_cfg or GUARD_CFG
    step_fn = make_train_step(cfg, opt_cfg, guard_cfg=guard_cfg)

    model, opt_state, guard_state = build_state(cfg, 0, dev, guard_cfg)
    start_step = 0
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    if mgr and resume and mgr.latest_step() is not None:
        (params, opt_state, guard_state), meta = mgr.restore(
            _state_tree(model, opt_state, guard_state))
        with torch.no_grad():
            for p, saved in zip(model.parameters(), params.values()):
                p.copy_(saved)
        del params
        start_step = meta["step"]
        print(f"[train] resumed from step {start_step}")
    if mesh is not None:
        place, opt_state = _on_mesh(mesh, dev, model, opt_state)
        b_spec = batch_spec(mesh, batch)
        step_fn = on_dtensors(step_fn)

    stream = TokenStream(cfg.vocab, batch, seq, corrupt_prob=corrupt_prob,
                         corrupt_every=corrupt_every)
    straggler = StragglerDetector(m=4.0, warmup=10)
    history, step_s = [], []
    for step in range(start_step, steps):
        data = stream.batch_at(step)
        batch_dev = {k: torch.from_numpy(v).to(dev)
                     for k, v in data.items()}
        if mesh is not None:
            batch_dev = {k: place(v, b_spec) for k, v in batch_dev.items()}
        straggler.tick()
        model, opt_state, guard_state, metrics = step_fn(
            model, opt_state, guard_state, batch_dev)
        # read the step's metrics back before tock(): the straggler
        # detector times the step, not its enqueue
        vals = torch.stack([_full(v).float()
                            for v in metrics.values()]).cpu()
        metrics = dict(zip(metrics, vals.tolist()))
        straggled = straggler.tock()
        history.append(metrics)
        step_s.append(straggler.last_s)
        if step % log_every == 0 or step == steps - 1:
            print(f"[train] step={step} loss={metrics['loss']:.4f} "
                  f"gnorm={metrics['grad_norm']:.3f} "
                  f"lr={metrics['lr']:.2e} "
                  f"skipped={int(metrics['skipped'])} "
                  f"straggler={straggled}", flush=True)
        if mgr and (step + 1) % save_every == 0:
            mgr.save(step + 1, _state_tree(model, opt_state, guard_state))
    if mgr:
        mgr.save(steps, _state_tree(model, opt_state, guard_state))
        mgr.wait()
    skipped_total = int(_full(guard_state.skipped))
    if mesh is not None:
        distribute_model(model, None, local=True)
    print(f"[train] done. total guard-skipped steps: {skipped_total}, "
          f"straggler trips: {straggler.trips}")
    return model, history, {"skipped": skipped_total,
                            "straggler_trips": straggler.trips,
                            "step_s": step_s}


def scaled_config(arch: str, scale: str):
    """The CLI's `--scale`: "tiny" (the reduced config), "small"
    (~100M-class: up to 8 layers, d_model 512, vocab 32768) or "full"
    (the published widths)."""
    cfg = get_config(arch)
    if scale == "tiny":
        return cfg.reduced()
    if scale == "small":
        return cfg.reduced(n_layers=max(4, min(cfg.n_layers, 8)),
                           d_model=512, n_heads=8, n_kv=2, head_dim=64,
                           d_ff=1536 if cfg.d_ff else 0, vocab=32768,
                           q_chunk=128, kv_chunk=128)
    return cfg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--scale", default="tiny",
                    choices=["tiny", "small", "full"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--corrupt-prob", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--production-mesh", action="store_true",
                    help="train on the 16 x 16 mesh: 256 ranks, one card "
                    "each (torchrun's environment)")
    args = ap.parse_args(argv)
    cfg = scaled_config(args.arch, args.scale)
    if not args.production_mesh:
        train(cfg, args.steps, args.batch, args.seq, args.ckpt,
              resume=args.resume, device=args.device,
              corrupt_prob=args.corrupt_prob)
        return
    import torch.distributed as dist

    mesh = make_production_mesh()
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != mesh.size:
        sys.exit(f"--production-mesh: the 16 x 16 mesh needs a world of "
                 f"{mesh.size} ranks (torchrun's WORLD_SIZE), one card "
                 f"each; this world has {world}")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    torch.cuda.set_device(local)
    dist.init_process_group("nccl", init_method="env://")
    try:
        train(cfg, args.steps, args.batch, args.seq, args.ckpt,
              resume=args.resume, device=f"cuda:{local}",
              corrupt_prob=args.corrupt_prob, mesh=mesh)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
