"""The readings that the limits of `correct` are set from.

    python3 tedabench/control.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--fault-seeds 7,8,9] [--calls N]

For each of --seeds, the program's window (the harness's own loop, at
the cell's shapes and load, for N calls: by default one whole stream,
so that the last call ends a stream, where the state has carried
longest) and the comparison with the reference; for each of
--control-seeds, the same with the reference's control (the
configuration's lower precision, `control_scan` of its reference
module) put in the program's place; for each of --fault-seeds, the
program with each of `FAULTS` planted where it makes its flags.
Prints one JSON line per run: {"role", "seed", "correct", "checks"}.
The benchmark's own runs never run the control or the faults.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


class ControlEngine:
    """The reference's control in the engine's place: `process`,
    `reset` and `state` as `StreamEngine` has them."""

    def __init__(self, ref, config: dict, device):
        self.ref, self.device = ref, device
        self.c = config["channels"]
        self.m = config["engine"].get("m", 3.0)
        fmt = config["engine"].get("fmt")
        self.kw = {} if fmt is None else {"fmt": tuple(fmt)}
        self.reset()

    def reset(self):
        self.st = self.ref.control_state0(self.c, self.device)

    @property
    def state(self):
        k, mean, var = self.ref.control_to_program(self.st)
        return SimpleNamespace(k=k, mean=mean, var=var)

    def process(self, x, valid_lens=None):
        out, self.st = self.ref.control_scan(x, self.st, self.m, valid_lens,
                                             **self.kw)
        return out


class ThresholdFault:
    """The program with its threshold broken where the flags are made:
    "no_plus_one" flags against m^2/(2k) in place of (m^2 + 1)/(2k),
    "k_minus_one" against (m^2 + 1)/(2(k - 1)).  The ecc and the state
    are the program's own; only the flags are made again from them."""

    def __init__(self, eng, fault: str, config: dict):
        if fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        self.eng, self.fault = eng, fault
        self.m = config["engine"].get("m", 3.0)
        fmt = config["engine"].get("fmt")
        self.scale = 1.0 if fmt is None else float(1 << fmt[1])

    def reset(self):
        self.eng.reset()

    @property
    def state(self):
        return self.eng.state

    def process(self, x, valid_lens=None):
        import torch
        f64 = torch.float64
        k0 = self.eng.state.k.to(f64)
        out = dict(self.eng.process(x, valid_lens=valid_lens))
        t_len, c = x.shape
        rows = torch.arange(t_len, device=x.device)[:, None]
        valid = (torch.ones((t_len, c), dtype=torch.bool, device=x.device)
                 if valid_lens is None else rows < valid_lens[None, :])
        k = k0[None, :] + torch.cumsum(valid.to(f64), 0)
        half_ecc = out["ecc"].to(f64) / (2.0 * self.scale)
        if self.fault == "no_plus_one":
            thr = self.m * self.m / (2.0 * k)
        else:
            thr = (self.m * self.m + 1.0) / (2.0 * (k - 1.0).clamp_min(1.0))
        out["outlier"] = valid & (half_ecc > thr) & (k >= 2.0)
        return out


FAULTS = ("no_plus_one", "k_minus_one")


def fault_factory(fault: str):
    def factory(config, device):
        from tedabench.harness import make_engine
        return ThresholdFault(make_engine(config, device), fault, config)
    return factory


def control_factory(config, device):
    from tedabench.harness import load_module
    return ControlEngine(load_module("reference", config["reference"]),
                         config, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--calls", type=int, default=0,
                    help="calls in each window (default: one stream)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    from tedabench.harness import cell_spec, make_engine, run_cell
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = cell_spec(bench, args.workload)
    calls = args.calls or cell.traffic["stream_len"] // cell.traffic["t"]
    dev = torch.device(args.device)
    runs = [("program", s, make_engine) for s in args.seeds.split(",") if s]
    runs += [("control", s, control_factory)
             for s in args.control_seeds.split(",") if s]
    runs += [(f, s, fault_factory(f)) for f in FAULTS
             for s in args.fault_seeds.split(",") if s]
    for role, seed, factory in runs:
        t0 = time.perf_counter()
        res = run_cell(cell, int(seed), 0.0, False, dev,
                       engine_factory=factory, calls=calls,
                       warm=role == "program",
                       log=lambda msg: print(msg, file=sys.stderr))
        print(json.dumps({"role": role, "seed": int(seed),
                          "correct": res["correct"],
                          "seconds": time.perf_counter() - t0,
                          "checks": res["checks"]}), flush=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
