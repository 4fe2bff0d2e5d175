"""The MoE cells' production dry run against the JAX package's, per
device.

mixtral-8x7b's train_4k and prefill_32k and dbrx-132b's train_4k on the
16 x 16 ("single") mesh, through both packages' `run_cell`, as
`tests/test_torch_dryrun_parity.py` holds llama3.2-1b's: the port's
per-device flops at most 1.25 times the reference's, its collective
bytes at most 1.5 times, no `ViewResharding` retry, the same parameter
shares.  mixtral's 8 experts do not split over the 16 "model" ranks
(the rule splits d_ff there: tensor-parallel), dbrx's 16 do (expert
parallel); prefill_32k's 1,048,576 tokens route in blocks of
`moe_chunk`, one per "data" rank.  The reference adds the chunked
experts' flops back analytically over the whole batch
(`analytic_loop_flops`), so its train_4k flops count the expert
products about twice: the port's read about 0.5 whatever its layout.
`bytes_per_device` and `temp_bytes` are printed beside the
reference's and not bounded.  The port's mixtral train_4k also
records the collectives of the optimizer's update: none gathers
anything (the expert weights' gradients come back on their
parameters' placements).

One child interpreter per package and cell, all started together (the
reference's dryrun module sets `XLA_FLAGS` for 512 host devices at
import, so the parent's flags are dropped).
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
CELLS = (("mixtral_8x7b", "train_4k"), ("mixtral_8x7b", "prefill_32k"),
         ("dbrx_132b", "train_4k"))
FLOPS_BOUND = 1.25
COLLECTIVE_BOUND = 1.5

_REF = textwrap.dedent("""
    import json, sys
    from repro.launch.dryrun import run_cell
    print(json.dumps(run_cell(sys.argv[1], sys.argv[2], "single")))
""")

_PORT = textwrap.dedent("""
    import json, sys
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    from repro_torch.launch.cost_analysis import LocalOpCounter
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.optim import adamw

    updates, update = [], adamw.update

    def update_seen(*args, **kw):
        counter = next(m for m in _get_current_dispatch_mode_stack()
                       if isinstance(m, LocalOpCounter))
        mark = len(counter.log)
        out = update(*args, **kw)
        updates.extend(counter.log[mark:])
        return out

    adamw.update = update_seen
    r = run_cell(sys.argv[1], sys.argv[2], "single")
    r["update_collectives"] = sorted(set(updates))
    print(json.dumps(r))
""")


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **extra)
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(scope="module")
def results():
    """{"ref" | "port": {(arch, shape): run_cell's result}}, all
    children started together."""
    procs = {}
    for cell in CELLS:
        procs[("ref", cell)] = subprocess.Popen(
            [sys.executable, "-c", _REF, *cell],
            env=_env(JAX_PLATFORMS="cpu"), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        procs[("port", cell)] = subprocess.Popen(
            [sys.executable, "-c", _PORT, *cell], env=_env(),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {"ref": {}, "port": {}}
    try:
        for (side, cell), p in procs.items():
            text, err = p.communicate(timeout=400)
            assert p.returncode == 0, f"{side} {cell}: {err[-3000:]}"
            out[side][cell] = json.loads(text.strip().splitlines()[-1])
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


@pytest.mark.parametrize("cell", CELLS, ids="/".join)
def test_per_device_counts_within_the_references(results, cell):
    ref, port = results["ref"][cell], results["port"][cell]
    ratios = {k: port[k] / ref[k] for k in (
        "flops_per_device", "collective_bytes_per_device",
        "bytes_per_device")}
    ratios["temp_bytes"] = (port["memory"]["temp_bytes"]
                            / ref["memory"]["temp_bytes"])
    print(cell, {k: round(v, 4) for k, v in ratios.items()})
    assert ratios["flops_per_device"] <= FLOPS_BOUND, ratios
    assert ratios["collective_bytes_per_device"] <= COLLECTIVE_BOUND, \
        ratios


@pytest.mark.parametrize("cell", CELLS, ids="/".join)
def test_no_view_is_resharded(results, cell):
    cal = results["port"][cell]["calibration"]
    assert cal["view_fallbacks"] == 0, cal["view_fallback_ops"]


@pytest.mark.parametrize("cell", CELLS, ids="/".join)
def test_parameter_shares_are_the_references(results, cell):
    ref = results["ref"][cell]["memory"]["argument_bytes"]
    port = results["port"][cell]["memory"]["argument_bytes"]
    assert abs(port - ref) <= 16, (port, ref)


def test_the_update_gathers_no_expert_weight(results):
    got = results["port"][("mixtral_8x7b", "train_4k")]["update_collectives"]
    assert got and not [c for c in got if c[0] != "all-reduce"], got
