"""BENCHMARK.json against the contract, and every name it uses found as
a file of its own."""
import json
import re
import shutil
import statistics

import pytest

from tedabench import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["tedabench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for word in BENCH["command"]:
        assert ".." not in word and not word.startswith("/")
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_keys():
    seen = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (harness.ROOT / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        allowed = {"name", "unit", "better", "source", "workloads"}
        allowed |= ({"bound"} if m in BENCH["end_to_end"]
                    else {"layer", "moves"})
        assert set(m) <= allowed
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for item in (BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
                 + BENCH["per_layer"]):
        assert NAME.match(item["name"]) and item["name"] not in seen
        seen.add(item["name"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names
    for m in BENCH["per_layer"]:
        assert m["moves"] in names and "\n" not in m["layer"]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cells_resolve(cell):
    """Each cell finds its configuration, traffic, reference and
    metrics by name, reports setup_s, another end-to-end metric and a
    per-layer metric."""
    spec = harness.cell_spec(BENCH, cell)
    assert spec.config["channels"] % 2 == 0
    harness.load_module("reference", spec.config["reference"])
    harness.load_module("roofline", spec.config["kernel"])
    e2e = [m["name"] for m in spec.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.per_layer
    for m in spec.end_to_end + spec.per_layer:
        assert callable(harness.load_module("metrics", m["name"]).read)


def test_a_new_cell_is_only_files(tmp_path, monkeypatch):
    """A configuration and a traffic mix added as files are found by
    name, with no edit to the harness."""
    root = tmp_path / "tedabench"
    shutil.copytree(harness.BENCH, root)
    cfg = json.loads((root / "configs" / "damadics-fleet-f32.json")
                     .read_text())
    cfg.update(name="fleet-small", channels=64)
    (root / "configs" / "fleet-small.json").write_text(json.dumps(cfg))
    tr = json.loads((root / "traffic" / "live-t512.json").read_text())
    tr.update(name="ragged-t64", t=64, ring=2, stream_len=256,
              valid_lens={"low": 0.5, "high": 1.0}, sample_channels=8)
    (root / "traffic" / "ragged-t64.json").write_text(json.dumps(tr))
    monkeypatch.setattr(harness, "BENCH", root)
    bench = dict(BENCH, workloads=[{
        "name": "small-ragged", "config": "fleet-small",
        "traffic": "ragged-t64", "chips": 1, "why": "x"}])
    spec = harness.cell_spec(bench, "small-ragged")
    assert spec.config["channels"] == 64
    res = harness.run_cell(spec, 5, 0.0, False, "cpu", calls=9,
                           log=lambda m: None)
    assert res["correct"] is True
    assert statistics.mean([1]) == 1
