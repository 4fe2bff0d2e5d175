"""Run one cell of the benchmark of the PyTorch and CUDA port.

    python3 tedabench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout that holds BENCHMARK.json, tedabench/
and the port (src/repro_torch).  Each run is one process on one card:
it builds or reuses the kernels (build/repro_torch/ in the checkout),
makes its data on the card from the seed, warms up the cell's shapes,
measures for --seconds, checks what the window produced against the
reference, and prints one JSON line last on standard output: the
cell's end-to-end metrics (--trace 0) or its per-layer metrics and the
trace's breakdown (--trace 1).  The numbers compared, each beside its
limit, end standard error and the line.  Without a card it fails and
prints no result.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def foreign_modules():
    """Top-level names of loaded modules that the port may not load."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    import torch

    from tedabench.harness import cell_spec, run_cell
    cell = cell_spec(bench, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"the cell needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), t_process=T_PROCESS,
                      log=lambda msg: print(msg, file=sys.stderr))
    found = foreign_modules()
    if found:
        print(f"modules of JAX or the JAX package loaded: {found}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
