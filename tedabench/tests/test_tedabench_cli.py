"""The command: no result without a card; a short run on the card."""
import json
import subprocess
import sys

import pytest
import torch

from tedabench.harness import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def run(cell, seconds="1", trace="0"):
    return subprocess.run(
        [sys.executable, "tedabench/run.py", "--workload", cell, "--seed",
         str(2 ** 40 + 17), "--seconds", seconds, "--trace", trace],
        capture_output=True, text=True, cwd=ROOT, timeout=600)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    out = run("f32-backfill-t4096")
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_short_run_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark runs on the card")
    out = run(cell)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
