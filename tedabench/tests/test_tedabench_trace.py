"""The trace reduction and the last line's schema."""
import copy
import json

import pytest

from tedabench import harness
from tedabench.trace import Trace, union

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())


def test_union_busy_and_gaps():
    ops = [("a", 0, 10, 1), ("b", 5, 20, 2), ("a", 30, 40, 1),
           ("c", 70, 75, 1)]
    spans = [("process", 18, 32), ("wait", 40, 100)]
    tr = Trace(ops, spans, (0, 100))
    assert union(ops) == [[0, 20], [30, 40], [70, 75]]
    assert tr.busy_s() == pytest.approx(35e-9)
    gaps = tr.idle_gaps()
    assert gaps[0] == ["wait", pytest.approx(30e-9)]   # 40-70
    assert ["process", pytest.approx(10e-9)] in gaps   # 20-30
    assert ["wait", pytest.approx(25e-9)] in gaps      # 75-100
    assert tr.device_ops()[0] == ["a", pytest.approx(20e-9)]
    assert tr.calls() == 1


def tiny(name):
    cell = harness.cell_spec(BENCH, name)
    cell.config = copy.deepcopy(cell.config)
    cell.traffic = copy.deepcopy(cell.traffic)
    cell.config["channels"] = 16
    cell.config["faults"]["length"] = [4, 20]
    cell.traffic.update(t=32, ring=2, stream_len=128, sample_channels=6)
    return cell


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_last_line_schema(cell):
    """An untraced run's line: the keys the driver reads, the cell's
    end-to-end metrics with their units, the checks last."""
    spec = tiny(cell)
    res = harness.run_cell(spec, 2 ** 40 + 1, 0.2, False, "cpu",
                           log=lambda m: None)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    want = {m["name"]: m["unit"] for m in spec.end_to_end}
    assert {k: v["unit"] for k, v in res["metrics"].items()} == want
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.dumps(res)


def test_traced_line():
    """A traced run's line: per-layer metrics only (on the CPU no device
    operation, so only the idle share reads), the breakdown, the
    traced window's busy and total seconds."""
    spec = tiny("f32-backfill-t4096")
    res = harness.run_cell(spec, 3, 0.1, True, "cpu", log=lambda m: None)
    assert res["correct"] is True
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(res["breakdown"]["idle_gaps"]) <= 10
    assert res["device"]["window_s"] > 0 and "busy_s" in res["device"]
    assert set(res["metrics"]) == {"device_idle_pct"}
    assert res["breakdown"]["idle_gaps"][0][0] in (
        "make", "process", "summary", "wait", "harness")


def test_live_mix_runs():
    """The measured live mix (traffic/live-t512.json, in no cell of
    BENCHMARK.json yet) still drives a whole run."""
    spec = harness.Cell("live", harness.load_json("configs",
                                                  "damadics-fleet-f32"),
                        harness.load_json("traffic", "live-t512"),
                        BENCH["end_to_end"], [])
    spec.config["channels"] = 16
    spec.config["faults"]["length"] = [4, 20]
    spec.traffic.update(t=16, stream_len=16 * spec.traffic["ring"],
                        sample_channels=4)
    res = harness.run_cell(spec, 5, 0.1, False, "cpu", log=lambda m: None)
    assert res["correct"] is True
    assert set(res["metrics"]) == {"samples_per_s", "setup_s"}


@pytest.mark.parametrize("t_len,c", [(4096, 64), (512, 48), (96, 16),
                                     (37, 24), (64, 13), (1, 8), (0, 8)])
def test_flag_counts(t_len, c):
    """The summary's count per channel equals a plain sum, at every
    shape (the block path and the fallback)."""
    import torch
    g = torch.Generator().manual_seed(t_len * 131 + c)
    flags = torch.rand((t_len, c), generator=g) < 0.7
    flags[:, 0] = True  # a channel flagged on every row
    want = flags.sum(0, dtype=torch.int32)
    got = harness.flag_counts(flags)
    assert got.dtype == torch.int32 and torch.equal(got, want)
