"""xlstm-350m's train_4k production dry run against the JAX package's,
per device.

The cell on the 16 x 16 ("single") mesh through both packages'
`run_cell`, as `tests/test_torch_dryrun_parity.py` holds llama3.2-1b's:
the port's per-device flops at most 1.25 times the reference's, its
collective bytes at most 1.5 times, no `ViewResharding` retry, the same
parameter shares.  The port traces every one of the sLSTM's 4,096 time
steps (one registered op each way, `models/xlstm.py::slstm_step`), in
three calibration traces, and must finish within 300 s on the CPU; the
mLSTM's chunk loop and the sLSTM's steps run split over "model" by
(batch row, head) units.  `bytes_per_device` and `temp_bytes` are
printed beside the reference's and not bounded.

One child interpreter per package, started together.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
ARCH, SHAPE = "xlstm_350m", "train_4k"
FLOPS_BOUND = 1.25
COLLECTIVE_BOUND = 1.5
PORT_SECONDS = 300

_REF = textwrap.dedent("""
    import json, sys
    from repro.launch.dryrun import run_cell
    print(json.dumps(run_cell(sys.argv[1], sys.argv[2], "single")))
""")

_PORT = textwrap.dedent("""
    import json, sys, time
    t0 = time.perf_counter()
    from repro_torch.launch.dryrun import run_cell
    r = run_cell(sys.argv[1], sys.argv[2], "single")
    r["wall_s"] = time.perf_counter() - t0
    print(json.dumps(r))
""")


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **extra)
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(scope="module")
def results():
    """{"ref" | "port": run_cell's result}, both children started
    together."""
    procs = {"ref": subprocess.Popen(
        [sys.executable, "-c", _REF, ARCH, SHAPE],
        env=_env(JAX_PLATFORMS="cpu"), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True),
        "port": subprocess.Popen(
            [sys.executable, "-c", _PORT, ARCH, SHAPE], env=_env(),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)}
    out = {}
    try:
        for side, p in procs.items():
            text, err = p.communicate(timeout=600)
            assert p.returncode == 0, f"{side}: {err[-3000:]}"
            out[side] = json.loads(text.strip().splitlines()[-1])
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def test_per_device_counts_within_the_references(results):
    ref, port = results["ref"], results["port"]
    ratios = {k: port[k] / ref[k] for k in (
        "flops_per_device", "collective_bytes_per_device",
        "bytes_per_device")}
    ratios["temp_bytes"] = (port["memory"]["temp_bytes"]
                            / ref["memory"]["temp_bytes"])
    print(SHAPE, {k: round(v, 4) for k, v in ratios.items()},
          f"port {port['wall_s']:.1f} s")
    assert ratios["flops_per_device"] <= FLOPS_BOUND, ratios
    assert ratios["collective_bytes_per_device"] <= COLLECTIVE_BOUND, \
        ratios


def test_no_view_is_resharded(results):
    cal = results["port"]["calibration"]
    assert cal["view_fallbacks"] == 0, cal["view_fallback_ops"]


def test_parameter_shares_are_the_references(results):
    ref = results["ref"]["memory"]["argument_bytes"]
    port = results["port"]["memory"]["argument_bytes"]
    assert abs(port - ref) <= 16, (port, ref)


def test_the_port_run_finishes_in_time(results):
    assert results["port"]["wall_s"] <= PORT_SECONDS, results["port"]["wall_s"]
