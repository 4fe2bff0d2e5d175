"""The port's TEDA dry run, meshes and cost accounting, on the CPU.

The JAX package's `launch/teda_dryrun.run` compiles the sharded scan for
its 256- and 512-device meshes in a child interpreter (it sets 512
virtual host devices before JAX starts); the port's `run` traces one
shard on the meta device.  Held equal: the keys of the result, the
device count, `t_per_device` (as the reference computes it) and the
collectives, exactly.  Also: `roofline_terms` with the H100's constants
against the reference's formula, `OpCounter`'s rule, the meshes and
the CLI.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch.launch import cost_analysis, mesh, teda_dryrun
from repro_torch.launch.cost_analysis import OpCounter, roofline_terms

ROOT = Path(__file__).resolve().parents[1]
T_TOTAL = 1 << 20

_JAX_CHILD = textwrap.dedent("""
    import json
    from repro.launch.teda_dryrun import run
    print(json.dumps([run(False, %d, 4), run(True, %d, 4)]))
""") % (T_TOTAL, T_TOTAL)


@pytest.fixture(scope="module")
def reference():
    """The JAX package's dry run, single then multi mesh."""
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = str(ROOT / "src")
    res = subprocess.run([sys.executable, "-c", _JAX_CHILD], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    single, multi = json.loads(res.stdout.strip().splitlines()[-1])
    return {False: single, True: multi}


@pytest.mark.parametrize("multi", [False, True])
def test_run_has_the_references_keys_and_counts(reference, multi):
    ref = reference[multi]
    got = teda_dryrun.run(multi, T_TOTAL, 4)
    assert got.keys() == ref.keys()
    assert got["roofline"].keys() == ref["roofline"].keys()
    for key in ("mesh", "devices", "t_total", "n_feat", "t_per_device"):
        assert got[key] == ref[key], key
    assert got["devices"] == (512 if multi else 256)
    # the reference's figure, not the rows a shard holds (16 or 32 shards)
    assert got["t_per_device"] == T_TOTAL // got["devices"]
    assert got["temp_bytes"] is None
    assert got["flops_per_device"] > 0 and got["bytes_per_device"] > 0


@pytest.mark.parametrize("multi,total", [(False, 360.0), (True, 744.0)])
def test_collectives_equal_the_references(reference, multi, total):
    got = teda_dryrun.run(multi, T_TOTAL, 4)["collectives"]
    assert got == reference[multi]["collectives"]
    assert got == {"all-gather": total, "total_bytes": total,
                   "all-gather_count": 3}


def test_collectives_do_not_grow_with_the_stream():
    for multi in (False, True):
        short = teda_dryrun.run(multi, 1 << 14, 4)
        long = teda_dryrun.run(multi, T_TOTAL, 4)
        assert short["collectives"] == long["collectives"]
        assert long["bytes_per_device"] > short["bytes_per_device"]


def test_indivisible_stream_raises():
    with pytest.raises(ValueError, match="divisible"):
        teda_dryrun.run(False, 1000, 4)


@pytest.mark.parametrize("flops,nbytes,coll,links",
                         [(1e12, 1e9, 1e6, 18.0), (1e9, 1e12, 0.0, 18.0),
                          (1e6, 1e3, 1e9, 4.0), (0.0, 0.0, 0.0, 18.0)])
def test_roofline_terms_follow_the_references_formula(flops, nbytes, coll,
                                                      links):
    got = roofline_terms(flops, nbytes, coll, links)
    terms = {"compute_s": flops / 989e12, "memory_s": nbytes / 3.35e12,
             "collective_s": coll / (25e9 * links)}
    bound = max(terms.values())
    for key, want in terms.items():
        assert got[key] == pytest.approx(want, rel=1e-12, abs=0.0), key
    assert got["step_time_lower_bound_s"] == bound
    assert got["bottleneck"] == max(terms, key=terms.get).replace("_s", "")
    assert got["roofline_fraction"] == (terms["compute_s"] / bound
                                        if bound > 0 else 0.0)


def test_roofline_defaults_and_constants_are_the_h100s():
    assert (cost_analysis.PEAK_FLOPS, cost_analysis.HBM_BW,
            cost_analysis.NVLINK_BW) == (989e12, 3.35e12, 25e9)
    assert roofline_terms(0.0, 0.0, 450e9)["collective_s"] == 1.0


def test_op_counter_rule():
    a = torch.ones(3, 4, device="meta")
    with OpCounter() as ops:
        b = a + a  # pointwise: 12 ops, 3 x 48 bytes
        b.view(12)  # a view: nothing
    assert (ops.flops, ops.bytes) == (12, 144)
    with OpCounter() as ops:
        a.sum(0)  # a reduction: one op per input element
    assert (ops.flops, ops.bytes) == (12, 48 + 16)
    with OpCounter() as ops:
        torch.cumsum(a, 0)  # a scan: one op per output element
        torch.zeros(5, device="meta")  # a fill: bytes only
    assert (ops.flops, ops.bytes) == (12, 96 + 20)


def test_production_meshes_are_device_free():
    single = mesh.make_production_mesh()
    multi = mesh.make_production_mesh(multi_pod=True)
    assert single.shape == {"data": 16, "model": 16}
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert (single.size, multi.size) == (256, 512)
    assert multi.axis_size(("pod", "data")) == 32
    assert single.devices is None
    with pytest.raises(ValueError, match="holds none"):
        single.axis_devices("data")


def test_host_mesh(monkeypatch):
    m = mesh.make_host_mesh(data=2, model=3, device="cpu")
    assert m.shape == {"data": 2, "model": 3}
    assert m.axis_devices("data") == [torch.device("cpu")] * 2
    assert m.axis_devices(("data", "model")) == [torch.device("cpu")] * 6
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mesh.make_host_mesh()


def test_axis_devices_order():
    devs = [f"cuda:{i}" for i in range(6)]
    m = mesh.Mesh((2, 3), ("data", "model"), devs)
    as_dev = [torch.device(d) for d in devs]
    assert m.axis_devices("data") == [as_dev[0], as_dev[3]]
    assert m.axis_devices("model") == as_dev[:3]
    assert m.axis_devices(("data", "model")) == as_dev
    assert m.axis_devices(("model", "data")) == [as_dev[i]
                                                 for i in (0, 3, 1, 4, 2, 5)]
    with pytest.raises(ValueError, match="no axis"):
        m.axis_size("pipe")


def test_cli_writes_both_meshes(tmp_path):
    out = tmp_path / "sub" / "teda_dryrun.json"
    teda_dryrun.main(["--t", str(1 << 14), "--out", str(out)])
    rows = json.loads(out.read_text())
    assert [r["mesh"] for r in rows] == ["single", "multi"]
    assert [r["collectives"]["total_bytes"] for r in rows] == [360.0, 744.0]
