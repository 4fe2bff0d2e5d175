"""Two more cells of the production dry run against the JAX package's, per
device: seamless-m4t-medium's prefill_32k and llama3.2-1b's prefill_32k
with `seq_parallel=True`, both on the 16 x 16 ("single") mesh, through
both packages' `run_cell`, held as `tests/test_torch_dryrun_parity.py`
holds llama3.2-1b's cells: the port's per-device flops at most 1.25
times the reference's, its collective bytes at most 1.5 times, its
live-bytes peak (`temp_bytes`) at most 2 times, no `ViewResharding`
retry, the same parameter shares.

- seamless: the port extrapolates over its 12 (encoder, decoder) layer
  pairs.  The reference cuts its calibration configs to the same pairs
  but multiplies them by `n_layers`, 24 (its `_calibration_cfg` with
  `block_layout`): a reference-side overcount, pinned here, that puts
  the port's flops near 0.875 of the reference's.
- llama3.2-1b with sequence parallelism: the residual's sequence split
  over "model" is kept through the block (the weights are gathered,
  attention's heads reached by an all-to-all and left by another), so
  the one-group trace all-reduces nothing but the embedding's rows.

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
CELLS = {"seamless_m4t_medium/prefill_32k": (
             "seamless_m4t_medium", "prefill_32k", {}),
         "llama3_2_1b/prefill_32k/seq_parallel": (
             "llama3_2_1b", "prefill_32k", {"seq_parallel": True})}
FLOPS_BOUND = 1.25
COLLECTIVE_BOUND = 1.5
TEMP_BOUND = 2.0

_RUN = textwrap.dedent("""
    import json, sys
    from {pkg}.launch.dryrun import run_cell
    print(json.dumps(run_cell(sys.argv[1], sys.argv[2], "single",
                              **json.loads(sys.argv[3])), default=str))
""")


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **extra)
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(scope="module")
def results():
    """{"ref" | "port": {cell id: run_cell's result}}, all children
    started together."""
    procs = {}
    for cid, (arch, shape, kw) in CELLS.items():
        args = [arch, shape, json.dumps(kw)]
        procs["ref", cid] = subprocess.Popen(
            [sys.executable, "-c", _RUN.format(pkg="repro"), *args],
            env=_env(JAX_PLATFORMS="cpu"), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        procs["port", cid] = subprocess.Popen(
            [sys.executable, "-c", _RUN.format(pkg="repro_torch"), *args],
            env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
    out = {"ref": {}, "port": {}}
    try:
        for (side, cid), p in procs.items():
            text, err = p.communicate(timeout=400)
            assert p.returncode == 0, f"{side} {cid}: {err[-3000:]}"
            out[side][cid] = json.loads(text.strip().splitlines()[-1])
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


@pytest.mark.parametrize("cid", CELLS)
def test_per_device_counts_within_the_references(results, cid):
    ref, port = results["ref"][cid], results["port"][cid]
    ratios = {k: port[k] / ref[k] for k in (
        "flops_per_device", "collective_bytes_per_device",
        "bytes_per_device")}
    ratios["temp_bytes"] = (port["memory"]["temp_bytes"]
                            / ref["memory"]["temp_bytes"])
    print(cid, {k: round(v, 4) for k, v in ratios.items()})
    assert ratios["flops_per_device"] <= FLOPS_BOUND, ratios
    assert ratios["collective_bytes_per_device"] <= COLLECTIVE_BOUND, \
        ratios
    assert ratios["temp_bytes"] <= TEMP_BOUND, ratios


@pytest.mark.parametrize("cid", CELLS)
def test_no_view_is_resharded(results, cid):
    cal = results["port"][cid]["calibration"]
    assert cal["view_fallbacks"] == 0, cal["view_fallback_ops"]


@pytest.mark.parametrize("cid", CELLS)
def test_parameter_shares_are_the_references(results, cid):
    ref = results["ref"][cid]["memory"]["argument_bytes"]
    port = results["port"][cid]["memory"]["argument_bytes"]
    assert abs(port - ref) <= 16, (port, ref)


def test_encoder_decoder_groups_are_layer_pairs(results):
    """The port's 12 pairs; the reference's pinned count of 24."""
    cid = "seamless_m4t_medium/prefill_32k"
    port, ref = results["port"][cid], results["ref"][cid]
    assert port["calibration"]["n_groups"] == 12
    assert ref["calibration"]["n_groups"] == 24
    ratio = port["flops_per_device"] / ref["flops_per_device"]
    assert 0.8 <= ratio <= 0.95, ratio


def test_sequence_parallel_block_reduces_no_activation(results):
    port = results["port"]["llama3_2_1b/prefill_32k/seq_parallel"]
    one = port["collectives_scanned_hlo"]
    assert one["all-reduce_count"] == 1, one  # the embedding's rows
    assert one["all-to-all_count"] == 2, one  # to the heads and back
