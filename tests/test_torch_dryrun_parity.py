"""The port's production dry run against the JAX package's, per device.

llama3.2-1b's train_4k, prefill_32k and decode_32k cells on the 16 x
16 ("single") mesh, through both packages' `run_cell`: the port's
per-device flops may be at most 1.25 times the reference's and its
collective bytes at most 1.5 times, the reference's numbers read live
(JAX on the CPU, 256 virtual devices).  The port's traces must need no
`ViewResharding` retry.  `bytes_per_device` and `temp_bytes` are
printed beside the reference's and not bounded (the port counts every
eager op's reads and writes, XLA a fused schedule).

Each package runs in child interpreters started side by side: the
reference's dryrun module sets `XLA_FLAGS` for 512 host devices at
import, so the parent's flags are dropped.  One child runs the three
reference cells; one child per cell runs the port's.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
CELLS = ("train_4k", "prefill_32k", "decode_32k")
FLOPS_BOUND = 1.25
COLLECTIVE_BOUND = 1.5

_REF = textwrap.dedent("""
    import json
    from repro.launch.dryrun import run_cell
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        print(json.dumps(run_cell("llama3_2_1b", shape, "single")),
              flush=True)
""")

_PORT = textwrap.dedent("""
    import json, sys
    from repro_torch.launch.dryrun import run_cell
    print(json.dumps(run_cell("llama3_2_1b", sys.argv[1], "single")))
""")


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **extra)
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(scope="module")
def results():
    """{"ref" | "port": {shape: run_cell's result}}, all children
    started together."""
    procs = {("ref", None): subprocess.Popen(
        [sys.executable, "-c", _REF], env=_env(JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)}
    for shape in CELLS:
        procs[("port", shape)] = subprocess.Popen(
            [sys.executable, "-c", _PORT, shape], env=_env(),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {"ref": {}, "port": {}}
    try:
        for (side, shape), p in procs.items():
            text, err = p.communicate(timeout=400)
            assert p.returncode == 0, f"{side} {shape}: {err[-3000:]}"
            for line in text.strip().splitlines():
                if line.startswith("{"):
                    r = json.loads(line)
                    out[side][r["shape"]] = r
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert set(out["ref"]) == set(out["port"]) == set(CELLS)
    return out


@pytest.mark.parametrize("shape", CELLS)
def test_per_device_counts_within_the_references(results, shape):
    ref, port = results["ref"][shape], results["port"][shape]
    ratios = {k: port[k] / ref[k] for k in (
        "flops_per_device", "collective_bytes_per_device",
        "bytes_per_device")}
    ratios["temp_bytes"] = (port["memory"]["temp_bytes"]
                            / ref["memory"]["temp_bytes"])
    print(shape, {k: round(v, 4) for k, v in ratios.items()})
    assert ratios["flops_per_device"] <= FLOPS_BOUND, ratios
    assert ratios["collective_bytes_per_device"] <= COLLECTIVE_BOUND, \
        ratios


@pytest.mark.parametrize("shape", CELLS)
def test_no_view_is_resharded(results, shape):
    cal = results["port"][shape]["calibration"]
    assert cal["view_fallbacks"] == 0, cal["view_fallback_ops"]


def test_parameter_shares_are_the_references(results):
    for shape in CELLS:
        ref = results["ref"][shape]["memory"]["argument_bytes"]
        port = results["port"][shape]["memory"]["argument_bytes"]
        assert abs(port - ref) <= 16, (shape, port, ref)
