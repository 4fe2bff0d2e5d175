"""Hillclimbing driver: re-run one cell's dry run with a named change and
compare its roofline terms against the baseline.

The port of the JAX package's `launch/hillclimb.py`, over
`launch/dryrun.py::run_cell`.  Each invocation is one
hypothesis -> change -> count iteration; results land in
experiments/hillclimb/ tagged with the change's name, and `--compare`
prints the before/after table (the baseline is the dry run's file in
experiments/dryrun/, when there is one).

  python -m repro_torch.launch.hillclimb --arch llama3.2-1b \\
      --shape train_4k --mesh single --tag accum4 --accum 4
  python -m repro_torch.launch.hillclimb --arch llama3.2-1b \\
      --shape train_4k --mesh single --tag remat_dots \\
      --set remat_policy=dots
  python -m repro_torch.launch.hillclimb --compare llama3_2_1b train_4k \\
      single
"""
from __future__ import annotations

import argparse
import glob
import json
import os

__all__ = ["parse_override", "compare", "main"]


def parse_override(kv: str):
    """"key=value" -> (key, value as an int, a float, a bool or the
    string)."""
    k, v = kv.split("=", 1)
    for cast in (int, float):
        try:
            return k, cast(v)
        except ValueError:
            continue
    if v in ("True", "False"):
        return k, v == "True"
    return k, v


def _gib(n) -> str:
    return "n/a" if n is None else f"{n / 2**30:.2f}"


def compare(out_dir: str, arch: str, shape: str, mesh: str):
    """Print the roofline terms of every result of (arch, shape, mesh)
    in `out_dir`, the dry run's baseline first."""
    rows = []
    for p in sorted(glob.glob(os.path.join(
            out_dir, f"{arch}__{shape}__{mesh}*.json"))):
        with open(p) as f:
            rows.append(json.load(f))
    base_dir = os.path.join(os.path.dirname(out_dir), "dryrun")
    base = os.path.join(base_dir, f"{arch}__{shape}__{mesh}.json")
    if os.path.exists(base):
        with open(base) as f:
            rows.insert(0, json.load(f))
    print(f"{'tag':24s} {'compute_s':>10s} {'memory_s':>10s} "
          f"{'coll_s':>10s} {'bound':>10s} {'temp_GiB':>9s} {'frac':>6s}")
    for r in rows:
        t = r["roofline"]
        tag = r.get("tag") or "baseline"
        print(f"{tag:24s} {t['compute_s']:10.4f} {t['memory_s']:10.4f} "
              f"{t['collective_s']:10.4f} {t['bottleneck']:>10s} "
              f"{_gib(r['memory']['temp_bytes']):>9s} "
              f"{t['roofline_fraction']:6.3f}")


def main(argv=None):
    from repro_torch.configs.registry import ALIASES
    from repro_torch.launch.dryrun import cell_path, run_cell
    from repro_torch.sharding import rules

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--tag", default="exp")
    ap.add_argument("--set", action="append", default=[],
                    help="cfg override key=value (repeatable)")
    ap.add_argument("--accum", type=int, default=None)
    ap.add_argument("--sp", action="store_true",
                    help="enable sequence-parallel activation hints")
    ap.add_argument("--rule-flag", action="append", default=[],
                    help="sharding-rule flag key=True/False (repeatable)")
    ap.add_argument("--opt", action="append", default=[],
                    help="AdamWConfig override key=value (repeatable)")
    ap.add_argument("--hints", action="store_true",
                    help="enable activation-sharding hints (batch mode)")
    ap.add_argument("--out", default="experiments/hillclimb")
    ap.add_argument("--compare", nargs=3, metavar=("ARCH", "SHAPE", "MESH"))
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    if args.compare:
        compare(args.out, *args.compare)
        return

    os.makedirs(args.out, exist_ok=True)
    overrides = dict(parse_override(kv) for kv in args.set)
    flags = {}
    for kv in args.rule_flag:
        k, v = parse_override(kv)
        if k not in rules.RULE_FLAGS:
            raise SystemExit(f"unknown rule flag {k!r}; known: "
                             f"{sorted(rules.RULE_FLAGS)}")
        flags[k] = bool(v)
    arch = ALIASES.get(args.arch, args.arch)
    path = cell_path(args.out, arch, args.shape, args.mesh, args.tag)
    if os.path.exists(path) and not args.force:
        print(f"[cached] {path}")
    else:
        opt_over = dict(parse_override(kv) for kv in args.opt)
        res = run_cell(arch, args.shape, args.mesh,
                       cfg_overrides=overrides or None, tag=args.tag,
                       seq_parallel=args.sp or None,
                       accum_steps=args.accum,
                       opt_overrides=opt_over or None, hints=args.hints,
                       rule_flags=flags or None)
        with open(path, "w") as f:
            json.dump(res, f, indent=1)
        t = res["roofline"]
        print(f"[{args.tag}] bound={t['bottleneck']} "
              f"compute={t['compute_s']:.4f}s mem={t['memory_s']:.4f}s "
              f"coll={t['collective_s']:.4f}s "
              f"temp={_gib(res['memory']['temp_bytes'])}GiB")
    compare(args.out, arch, args.shape, args.mesh)


if __name__ == "__main__":
    main()
