"""Multi-pod dry run: trace one device's share of every (arch x shape x
mesh) cell.

The port of the JAX package's `launch/dryrun.py`.  The reference lowers
and compiles each cell for 256 or 512 virtual XLA devices and reads
memory, cost and collective traffic from the compiled program.  Here
the cell (`launch/specs.py::build_cell`) is built on the meta device as
DTensors on the mesh's `DeviceMesh` over PyTorch's fake process group
(`launch/mesh.py::fake_group`, 256 or 512 ranks, this process rank 0),
and its step runs under `launch/cost_analysis.py::LocalOpCounter`,
which counts the local ops and the collectives of rank 0.  Every number
is a count from shapes, reckoned against the H100's peaks
(`roofline_terms`): nothing here is measured on a card.

  PYTHONPATH=src python -m repro_torch.launch.dryrun          # everything
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
      --shape decode_32k --mesh single                        # one cell
  ... --list  /  --force  /  --out experiments/dryrun

Each cell's result (the reference's keys) goes into a JSON file per
cell (resumable: reruns skip cells already written).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.configs.registry import (ALIASES, SHAPES, all_cells,
                                          get_config)
from repro_torch.launch.cost_analysis import (LocalOpCounter,
                                              collective_stats,
                                              roofline_terms)
from repro_torch.launch.mesh import fake_group, make_production_mesh
from repro_torch.launch.specs import build_cell, pick_accum_steps
from repro_torch.models.common import active_param_count, vocab_padded
from repro_torch.models.transformer import block_layout
from repro_torch.optim import adamw
from repro_torch.sharding import rules
from repro_torch.sharding.hints import activation_hints
from repro_torch.tree import tree_leaves

__all__ = ["MESHES", "FIT_OVERRIDES", "analytic_loop_flops", "model_flops",
           "local_bytes", "calibrate_cell", "run_cell", "cell_path", "main"]

MESHES = ("single", "multi")

# Per-cell fit overrides, as the reference's (EXPERIMENTS.md §Perf there):
# dbrx-132b at fp32 Adam carries 12 B/param of optimizer+param state;
# bf16 moments + bf16 grad accumulation bring the train step under its
# HBM budget at production fidelity.
FIT_OVERRIDES = {
    ("dbrx_132b", "train_4k"): {
        "opt_overrides": {"grad_dtype": "bfloat16",
                          "m_dtype": "bfloat16", "v_dtype": "bfloat16"},
    },
    # 132B param+opt state cannot replicate per pod: ZeRO-3 across pods
    ("dbrx_132b", "train_4k", "multi"): {
        "opt_overrides": {"grad_dtype": "bfloat16",
                          "m_dtype": "bfloat16", "v_dtype": "bfloat16"},
        "rule_flags": {"fsdp_over_pod": True},
    },
    # the residual-activation constraint keeps batch sharding
    ("seamless_m4t_medium", "train_4k"): {"hints": True},
    ("qwen2_7b", "prefill_32k"): {"hints": True},
    ("chameleon_34b", "prefill_32k"): {"hints": True},
    ("zamba2_2p7b", "train_4k"): {"hints": True},
    ("zamba2_2p7b", "prefill_32k"): {"hints": True},
    ("xlstm_350m", "train_4k"): {"hints": True},
    ("mixtral_8x7b", "train_4k", "multi"): {
        "opt_overrides": {"grad_dtype": "bfloat16",
                          "m_dtype": "bfloat16", "v_dtype": "bfloat16"},
        "rule_flags": {"fsdp_over_pod": True},
    },
}

_SKIP_REASON = "pure full-attention arch at 500k (DESIGN.md long_500k " \
    "handling)"


def _calibration_cfg(cfg, groups: int):
    """The config cut to `groups` layer-groups, its chunking kept, as
    the reference's (whose compiles are unrolled; the port's stack
    always is)."""
    grp, n_groups = block_layout(cfg)
    per_group = cfg.n_layers // n_groups if n_groups else 1
    over = dict(scan_layers=False, n_layers=per_group * groups)
    if cfg.family == "encdec":
        over["enc_layers"] = groups
        over["dec_layers"] = groups
        over["n_layers"] = 2 * groups
    return dataclasses.replace(cfg, **over), n_groups


def analytic_loop_flops(cfg, sp, n_dev: int) -> float:
    """Per-device flops that live inside chunk loops (attention's
    S-quadratic terms, SSD/mLSTM intra-chunk terms, chunked-MoE expert
    matmuls, the chunked CE read-out, the sLSTM recurrence): the
    reference's arithmetic, which it adds to XLA's count because cost
    analysis counts a loop body once.  Train = fwd + remat recompute +
    backward (2x fwd) [+1 for attention's extra q-chunk checkpoint];
    prefill = fwd; decode = 0."""
    if sp.kind == "decode":
        return 0.0
    train = sp.kind == "train"
    attn_mult = 5.0 if train else 1.0
    other_mult = 4.0 if train else 1.0

    s = sp.seq_len
    b = sp.global_batch
    hd, h = cfg.head_dim, cfg.n_heads
    total = 0.0

    def attn_term(kv_eff, count):
        return 4.0 * b * h * s * kv_eff * hd * count

    if cfg.family == "encdec":
        total += attn_term(s, cfg.enc_layers) * attn_mult        # enc
        total += attn_term(s / 2, cfg.dec_layers) * attn_mult    # dec self
        total += attn_term(s, cfg.dec_layers) * attn_mult        # cross
    else:
        grp, n_groups = block_layout(cfg)
        for bd in grp:
            if bd.kind in ("attn", "moe", "shared"):
                kv_eff = min(bd.window, s) if bd.window else s / 2
                total += attn_term(kv_eff, n_groups) * attn_mult
            if bd.kind == "ssm":
                q = min(cfg.ssm_chunk, s)
                d_in = cfg.ssm_expand * cfg.d_model
                hs = d_in // cfg.ssm_head_dim
                ps = cfg.ssm_head_dim
                n = cfg.ssm_state
                intra = 2.0 * b * s * q * (n + hs * ps)
                inter = 4.0 * b * s * hs * ps * n
                total += (intra + inter) * n_groups * other_mult
            if bd.kind == "mlstm":
                d_in = int(cfg.mlstm_proj_factor * cfg.d_model)
                pm = d_in // cfg.n_heads
                q = min(cfg.ssm_chunk, s)
                intra = 4.0 * b * s * q * d_in
                state = 4.0 * b * s * d_in * pm
                total += (intra + state) * n_groups * other_mult
            if bd.kind == "slstm":
                ph = cfg.d_model // cfg.n_heads
                total += 8.0 * b * s * cfg.d_model * ph \
                    * n_groups * other_mult
        # chunked MoE expert matmuls (loop present when tokens > chunk)
        if cfg.family == "moe" and cfg.moe_chunk and b * s > cfg.moe_chunk:
            c_total = b * s * cfg.top_k * cfg.capacity_factor
            total += (3 * 2.0 * c_total * cfg.d_model * cfg.d_ff
                      * cfg.n_layers) * other_mult

    # chunked CE (train only; loop enters when S > ce_chunk)
    if train and cfg.ce_chunk and s > cfg.ce_chunk:
        total += 2.0 * b * s * cfg.d_model * vocab_padded(cfg) * 4.0

    return total / n_dev


def model_flops(cfg, kind: str, token_count: int) -> float:
    """6ND for a train step, 2ND for prefill and decode (N the active
    parameters, D the cell's tokens), as the reference counts them."""
    return (6 if kind == "train" else 2) * active_param_count(cfg) \
        * token_count


def _leaves(tree):
    """The tensors of a tree, a module standing for its parameters."""
    out = []
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.nn.Module):
            out.extend(leaf.parameters())
        elif isinstance(leaf, torch.Tensor):
            out.append(leaf)
    return out


def local_bytes(*trees) -> int:
    """Bytes this rank holds of the tensors in `trees` (a DTensor's
    local shard; a module's parameters)."""
    from torch.distributed.tensor import DTensor

    total = 0
    for tree in trees:
        for t in _leaves(tree):
            t = t.to_local() if isinstance(t, DTensor) else t
            total += t.numel() * t.element_size()
    return total


def _trace(cell, hint_ctx):
    """One run of the cell's step under `LocalOpCounter`."""
    with hint_ctx, LocalOpCounter() as ops:
        out = cell.fn(*cell.args)
        out_bytes = local_bytes(out)
    coll = collective_stats(ops)
    return {"flops": float(ops.flops), "bytes": float(ops.bytes),
            "coll": coll["total_bytes"], "out": float(out_bytes),
            "temp": float(ops.peak_bytes), "collectives": coll,
            "fallbacks": list(cell.fn.fallbacks)}


def calibrate_cell(arch, sp, mesh, cfg, n_dev, seq_parallel=None,
                   accum_real: int = 1, opt_cfg=None, dmesh=None):
    """Extrapolated per-device flops, bytes, collective bytes, output
    bytes and live-bytes peak, from traces of cut-down cells.

    The reference's measurement model (train): F(G, K) = opt + K*outm
    + K*G*bodym, G = layer-group count, K = microbatch count, outm =
    per-micro work outside the layers (embed, read-out, CE), bodym =
    per-micro per-group work; three traces, (g=1, k=1), (g=2, k=1) and
    (g=1, k=2), identify the coefficients; prefill and decode fix K at 1
    and two suffice.  The reference needs it because XLA counts a loop
    body once; the port's trace counts every op that runs, so the model
    only bounds the trace time on the CPU.  Output bytes and the
    live-bytes peak do not grow with K: they come from the first two
    traces, linear in G.  `view_fallbacks` counts the views of the
    traces that `sharding/hints.py::ViewResharding` had to retry
    (`view_fallback_ops` lists up to 20 distinct ones).  The chunk
    loops are counted as they run, so `loop_flops_addback` (the
    reference's analytic add-back) is reported and not added."""
    is_train = sp.kind == "train"
    micro_b = max(sp.global_batch // accum_real, 1)

    def measure(g, k):
        ccfg, n_groups = _calibration_cfg(cfg, g)
        csp = sp._replace(global_batch=micro_b * k) if is_train else sp
        cell = build_cell(arch, csp, mesh, ccfg,
                          accum_steps=k if is_train else None,
                          unroll_accum=True, opt_cfg=opt_cfg, dmesh=dmesh)
        hint_ctx = (activation_hints(mesh, sp=seq_parallel)
                    if seq_parallel is not None else
                    contextlib.nullcontext())
        return _trace(cell, hint_ctx), n_groups

    out = {}
    f11, n_groups = measure(1, 1)
    f21, _ = measure(2, 1)
    fell = f11.pop("fallbacks") + f21.pop("fallbacks")
    if is_train:
        f12, _ = measure(1, 2)
        fell += f12.pop("fallbacks")
    for key in ("flops", "bytes", "coll"):
        bodym = max(f21[key] - f11[key], 0.0)
        if is_train:
            outm = max(f12[key] - f11[key] - bodym, 0.0)
            opt = max(f11[key] - outm - bodym, 0.0)
            out[key] = (opt + accum_real * outm
                        + accum_real * n_groups * bodym)
        else:
            outside = max(f11[key] - bodym, 0.0)
            out[key] = outside + n_groups * bodym
        if key == "flops":
            out["per_group_flops"] = bodym
            out["outside_flops"] = max(f11[key] - bodym, 0.0)
    for key in ("out", "temp"):
        body = max(f21[key] - f11[key], 0.0)
        out[key] = max(f11[key] - body, 0.0) + n_groups * body
    out["loop_flops_addback"] = analytic_loop_flops(cfg, sp, n_dev)
    out["view_fallbacks"] = len(fell)
    out["view_fallback_ops"] = sorted({repr(f) for f in fell})[:20]
    out["n_groups"] = n_groups
    out["accum_steps"] = accum_real
    out["micro_batch"] = micro_b
    out["one_group_trace"] = f11
    return out


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             cfg_overrides=None, tag: str = "",
             seq_parallel: bool | None = None,
             accum_steps: int | None = None,
             opt_overrides=None, hints: bool = False,
             rule_flags=None) -> dict:
    """The dry run of one cell on the "single" (16 x 16) or "multi" (2 x
    16 x 16) mesh, under a fake process group of its size (none may
    exist already).  Keys as the reference's; the port's counts:

    - `lower_s`: seconds to build the full cell on meta; `compile_s`:
      seconds of the calibration traces;
    - `memory`: `argument_bytes` and `alias_bytes` (the arguments the
      step writes in place) from the full cell's local shards;
      `output_bytes` and `temp_bytes` (the local trace's live-bytes
      peak, `LocalOpCounter.peak_bytes`, arguments not included)
      extrapolated in the group count; `code_bytes` None;
    - `flops_per_device`, `bytes_per_device`,
      `collective_bytes_per_device`: `calibrate_cell`'s (no add-back);
    - `*_raw_scanned`, `collectives_scanned_hlo`: the one-group,
      one-microbatch trace, the counterpart of XLA's count of the
      scanned program (each loop body once)."""
    sp = next(s for s in SHAPES if s.name == shape_name)
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    n_dev = mesh.size
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    if accum_steps is None and sp.kind == "train":
        accum_steps = pick_accum_steps(mesh, sp.global_batch, sp.seq_len,
                                       cfg.d_model)
    accum_steps = accum_steps or 1
    opt_cfg = adamw.AdamWConfig(**(opt_overrides or {}))
    # activation hints are an opt-in experiment knob, as in the reference
    use_hints = hints or bool(seq_parallel)

    saved_flags = dict(rules.RULE_FLAGS)
    rules.RULE_FLAGS.update(rule_flags or {})
    try:
        with fake_group(n_dev):
            dmesh = mesh.device_mesh("cpu")
            t0 = time.time()
            cell = build_cell(arch, sp, mesh, cfg, accum_steps=accum_steps,
                              opt_cfg=opt_cfg, dmesh=dmesh)
            t_lower = time.time() - t0
            arg_bytes = local_bytes(*cell.args)
            alias_bytes = local_bytes(*(cell.args[i]
                                        for i in cell.donate_argnums))
            token_count = cell.token_count
            del cell
            t0 = time.time()
            cal = calibrate_cell(arch, sp, mesh, cfg, n_dev,
                                 seq_parallel=bool(seq_parallel)
                                 if use_hints else None,
                                 accum_real=accum_steps, opt_cfg=opt_cfg,
                                 dmesh=dmesh)
            t_compile = time.time() - t0
    finally:
        rules.RULE_FLAGS.clear()
        rules.RULE_FLAGS.update(saved_flags)

    flops, bytes_acc, coll_bytes = cal["flops"], cal["bytes"], cal["coll"]
    terms = roofline_terms(flops, bytes_acc, coll_bytes)
    n_active = active_param_count(cfg)
    useful = model_flops(cfg, sp.kind, token_count)
    raw = cal["one_group_trace"]
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "rule_flags": rule_flags or {},
        "tag": tag, "devices": n_dev,
        "kind": sp.kind, "seq_len": sp.seq_len,
        "global_batch": sp.global_batch,
        "accum_steps": accum_steps, "seq_parallel": bool(seq_parallel),
        "hints": use_hints, "opt_overrides": opt_overrides or {},
        "lower_s": round(t_lower, 2), "compile_s": round(t_compile, 2),
        "memory": {"argument_bytes": arg_bytes,
                   "output_bytes": cal["out"],
                   "temp_bytes": cal["temp"],
                   "alias_bytes": alias_bytes,
                   "code_bytes": None},
        "flops_per_device": flops,
        "bytes_per_device": bytes_acc,
        "collective_bytes_per_device": coll_bytes,
        "flops_per_device_raw_scanned": raw["flops"],
        "bytes_per_device_raw_scanned": raw["bytes"],
        "collectives_scanned_hlo": raw["collectives"],
        "calibration": cal,
        "roofline": terms,
        "model_flops_6nd": useful,
        "useful_flop_ratio": useful / max(flops * n_dev, 1.0),
        "active_params": n_active,
        "token_count": token_count,
    }


def cell_path(out_dir, arch, shape, mesh_kind, tag=""):
    suffix = f"__{tag}" if tag else ""
    return os.path.join(out_dir, f"{arch}__{shape}__{mesh_kind}{suffix}.json")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi",
                                                       "both"])
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)

    meshes = MESHES if args.mesh == "both" else (args.mesh,)
    todo = []
    for arch, sp, skip in all_cells():
        if args.arch and ALIASES.get(args.arch, args.arch) != arch:
            continue
        if args.shape and sp.name != args.shape:
            continue
        for mk in meshes:
            todo.append((arch, sp.name, mk, skip))

    if args.list:
        for t in todo:
            print(*t)
        return
    os.makedirs(args.out, exist_ok=True)

    n_ok = n_fail = n_skip = 0
    for arch, shape, mk, skip in todo:
        path = cell_path(args.out, arch, shape, mk)
        if skip:
            with open(path, "w") as f:
                json.dump({"arch": arch, "shape": shape, "mesh": mk,
                           "skipped": True, "reason": _SKIP_REASON}, f)
            n_skip += 1
            continue
        if os.path.exists(path) and not args.force:
            print(f"[cached] {arch} {shape} {mk}")
            n_ok += 1
            continue
        print(f"[run] {arch} {shape} {mk} ...", flush=True)
        try:
            over = FIT_OVERRIDES.get((arch, shape, mk),
                                     FIT_OVERRIDES.get((arch, shape), {}))
            res = run_cell(arch, shape, mk, **over)
            with open(path, "w") as f:
                json.dump(res, f, indent=1)
            r = res["roofline"]
            print(f"  ok trace={res['compile_s']:.1f}s "
                  f"bottleneck={r['bottleneck']} "
                  f"compute={r['compute_s']:.4f}s "
                  f"mem={r['memory_s']:.4f}s "
                  f"coll={r['collective_s']:.4f}s", flush=True)
            n_ok += 1
        except Exception:  # a failed cell is recorded; the sweep goes on
            traceback.print_exc()
            with open(path + ".fail", "w") as f:
                f.write(traceback.format_exc())
            n_fail += 1
    print(f"done: ok={n_ok} fail={n_fail} skip={n_skip}")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
