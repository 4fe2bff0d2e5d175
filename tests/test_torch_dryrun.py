"""The port's dry run of the model cells and its hillclimb driver, on the
CPU.

- The reference's mini dry run (`tests/test_launch.py`'s
  `test_mini_dryrun_all_kinds`), at its sizes: mixtral, zamba2 and
  gemma2 `reduced()` (and xlstm, whose log-sigmoid DTensor has no rule
  for in every release) on a (4, 2) mesh of a fake 8-rank process group,
  train, prefill and decode cells of batch 8 x 64 traced under
  `LocalOpCounter` on the meta device: flops above 0 and a bottleneck
  among the three.  One child interpreter per arch (the default group is
  global to a process), run side by side.
- One production cell through `run_cell` (llama3.2-1b decode_32k on the
  16 x 16 mesh, a fake 256-rank group): the reference's result keys,
  positive counts, no loop add-back in the flops.
- A sharded matmul's local flops are the global count over the shards;
  redistributions are logged with their group sizes and bytes; a
  Shard(i) -> Shard(j) redistribution is one all-to-all of its local
  result, where the CPU mesh sends it as an all-gather and a chunk.
- The ring factors, `analytic_loop_flops` for every cell on both meshes
  and the 6ND model flops (`active_param_count`) equal the reference's.
- `hillclimb.parse_override` and `compare`; the CLIs' `--list`, the
  long_500k skip record.
"""
import itertools
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro.configs.registry import get_config as jget
from repro.launch.hlo_analysis import _RING_FACTOR as JRING
from repro.models.common import active_param_count as jactive
from repro_torch.configs.registry import SHAPES, all_cells, get_config
from repro_torch.launch import cost_analysis, dryrun, hillclimb
from repro_torch.models.common import active_param_count

ROOT = Path(__file__).resolve().parents[1]

# the reference's result keys (src/repro/launch/dryrun.py:338-361)
REF_KEYS = {"arch", "shape", "mesh", "rule_flags", "tag", "devices", "kind",
            "seq_len", "global_batch", "accum_steps", "seq_parallel",
            "hints", "opt_overrides", "lower_s", "compile_s", "memory",
            "flops_per_device", "bytes_per_device",
            "collective_bytes_per_device", "flops_per_device_raw_scanned",
            "bytes_per_device_raw_scanned", "collectives_scanned_hlo",
            "calibration", "roofline", "model_flops_6nd",
            "useful_flop_ratio", "active_params", "token_count"}
MEM_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
            "code_bytes"}


def _env():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    return env


_MINI = textwrap.dedent("""
    import contextlib, sys
    from repro_torch.configs import get_config
    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.launch.cost_analysis import roofline_terms
    from repro_torch.launch.dryrun import _trace
    from repro_torch.launch.mesh import Mesh, fake_group
    from repro_torch.launch.specs import build_cell
    arch = sys.argv[1]
    mesh = Mesh((4, 2), ("data", "model"))
    with fake_group(8):
        dmesh = mesh.device_mesh("cpu")
        cfg = get_config(arch).reduced()
        for kind, b, s in (("train", 8, 64), ("prefill", 8, 64),
                           ("decode", 8, 64)):
            cell = build_cell(arch, ShapeSpec(f"mini_{kind}", s, b, kind),
                              mesh, cfg, dmesh=dmesh)
            r = _trace(cell, contextlib.nullcontext())
            assert r["flops"] > 0, (arch, kind)
            terms = roofline_terms(1e12, 1e9, r["coll"])
            assert terms["bottleneck"] in ("compute", "memory",
                                           "collective")
            print("OK", arch, kind, r["flops"], r["coll"])
    print("MINI_DRYRUN_OK", arch)
""")

_CELL = textwrap.dedent("""
    import json
    from repro_torch.launch.dryrun import run_cell
    print(json.dumps(run_cell("llama3_2_1b", "decode_32k", "single")))
""")


@pytest.fixture(scope="module")
def children():
    """The mini dry runs (one child per arch) and the production cell,
    started together; {name: stdout}."""
    jobs = {arch: [sys.executable, "-c", _MINI, arch]
            for arch in ("mixtral_8x7b", "zamba2_2p7b", "gemma2_2b",
                         "xlstm_350m")}
    jobs["cell"] = [sys.executable, "-c", _CELL]
    procs = {k: subprocess.Popen(cmd, env=_env(), stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for k, cmd in jobs.items()}
    outs = {}
    try:
        for k, p in procs.items():
            out, err = p.communicate(timeout=400)
            assert p.returncode == 0, f"{k}: {err[-3000:]}"
            outs[k] = out
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


@pytest.mark.parametrize("arch", ["mixtral_8x7b", "zamba2_2p7b",
                                  "gemma2_2b", "xlstm_350m"])
def test_mini_dryrun_all_kinds(children, arch):
    out = children[arch]
    assert f"MINI_DRYRUN_OK {arch}" in out
    assert sum(line.startswith("OK ") for line in out.splitlines()) == 3


def test_run_cell_has_the_references_keys(children):
    r = json.loads(children["cell"].strip().splitlines()[-1])
    assert set(r) == REF_KEYS
    assert set(r["memory"]) == MEM_KEYS
    assert set(r["roofline"]) == {"compute_s", "memory_s", "collective_s",
                                  "bottleneck", "step_time_lower_bound_s",
                                  "roofline_fraction"}
    assert (r["devices"], r["kind"], r["token_count"]) == (256, "decode",
                                                           128)
    cal = r["calibration"]
    assert cal["n_groups"] == 16 and cal["loop_flops_addback"] == 0.0
    # the chunk loops are traced: the add-back is reported, not added
    assert r["flops_per_device"] == cal["flops"] > 0
    assert r["bytes_per_device"] > 0
    assert r["collective_bytes_per_device"] > 0
    mem = r["memory"]
    assert mem["argument_bytes"] >= mem["alias_bytes"] > 0
    assert mem["temp_bytes"] > 0 and mem["code_bytes"] is None
    assert r["model_flops_6nd"] == 2 * r["active_params"] * 128


_LOCAL = textwrap.dedent("""
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.cost_analysis import (LocalOpCounter,
                                                  collective_stats)
    from repro_torch.launch.mesh import fake_group, make_production_mesh
    mesh = make_production_mesh()
    with fake_group(256):
        dm = mesh.device_mesh("cpu")
        x = distribute_tensor(torch.empty(256, 2048, device="meta"), dm,
                              [Shard(0), Replicate()])
        w = distribute_tensor(torch.empty(2048, 8192, device="meta"), dm,
                              [Replicate(), Shard(1)])
        with LocalOpCounter() as ops:
            y = x @ w
        assert ops.flops == 2 * 256 * 2048 * 8192 // 256, ops.flops
        assert ops.log == [] and ops.peak_bytes == 16 * 512 * 4
        assert tuple(y.to_local().shape) == (16, 512)
        with LocalOpCounter() as ops:
            x.redistribute(dm, [Replicate(), Replicate()])
            (x * 1.0).sum().full_tensor()
        kinds = [(k, n) for k, n, _ in ops.log]
        assert ("all-gather", 16) in kinds and ("all-reduce", 16) in kinds
        gather = [b for k, n, b in ops.log if k == "all-gather"]
        assert gather == [256 * 2048 * 4], gather
        stats = collective_stats(ops)
        assert stats["all-gather_count"] == 1
        assert stats["all-gather"] == 256 * 2048 * 4 * 15 / 16
    print("LOCAL_OK")
""")


def test_sharded_matmul_counts_one_shard():
    res = subprocess.run([sys.executable, "-c", _LOCAL], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "LOCAL_OK" in res.stdout


_ALL_TO_ALL = textwrap.dedent("""
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.cost_analysis import (LocalOpCounter,
                                                  collective_stats)
    from repro_torch.launch.mesh import Mesh, fake_group
    mesh = Mesh((4,), ("model",))
    with fake_group(4):
        dm = mesh.device_mesh("cpu")
        x = distribute_tensor(torch.empty(8, 16, device="meta"), dm,
                              [Shard(0)], src_data_rank=None)
        with LocalOpCounter() as ops:
            y = x.redistribute(dm, [Shard(1)])
        assert tuple(y.to_local().shape) == (8, 4)
        assert ops.log == [("all-to-all", 4, 8 * 4 * 4)], ops.log
        assert collective_stats(ops)["all-to-all"] == 8 * 4 * 4 * 3 / 4
        with LocalOpCounter() as ops:
            x.redistribute(dm, [Replicate()])
        assert ops.log == [("all-gather", 4, 8 * 16 * 4)], ops.log
    print("ALL_TO_ALL_OK")
""")


def test_shard_to_shard_is_one_all_to_all():
    res = subprocess.run([sys.executable, "-c", _ALL_TO_ALL], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "ALL_TO_ALL_OK" in res.stdout


def test_ring_factors_are_the_references():
    assert set(cost_analysis._RING_FACTOR) == set(JRING)
    for kind, n in itertools.product(JRING, range(2, 600)):
        assert cost_analysis._RING_FACTOR[kind](n) == JRING[kind](n), \
            (kind, n)


@pytest.fixture(scope="module")
def jdryrun():
    """The reference's dryrun module (its import sets XLA_FLAGS for a
    512-device JAX; this process's JAX is already up, and the variable
    is put back so that later child interpreters do not inherit it)."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as mod
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return mod


def test_analytic_loop_flops_are_the_references(jdryrun):
    for (arch, sp, _), n_dev in itertools.product(all_cells(), (256, 512)):
        assert dryrun.analytic_loop_flops(get_config(arch), sp, n_dev) == \
            jdryrun.analytic_loop_flops(jget(arch), sp, n_dev), \
            (arch, sp.name, n_dev)
    assert dryrun.MESHES == jdryrun.MESHES
    assert dryrun.FIT_OVERRIDES == jdryrun.FIT_OVERRIDES
    assert dryrun.cell_path("o", "a", "s", "single", "t") == \
        jdryrun.cell_path("o", "a", "s", "single", "t")


def test_model_flops_are_the_references():
    for arch, sp, _ in all_cells():
        cfg = get_config(arch)
        assert active_param_count(cfg) == jactive(jget(arch)), arch
        tokens = sp.global_batch * (1 if sp.kind == "decode"
                                    else sp.seq_len)
        assert dryrun.model_flops(cfg, sp.kind, tokens) == \
            (6 if sp.kind == "train" else 2) * jactive(jget(arch)) * tokens


def test_parse_override():
    assert hillclimb.parse_override("accum=4") == ("accum", 4)
    assert hillclimb.parse_override("lr=3e-4") == ("lr", 3e-4)
    assert hillclimb.parse_override("remat=False") == ("remat", False)
    assert hillclimb.parse_override("remat_policy=dots") == (
        "remat_policy", "dots")
    assert hillclimb.parse_override("a=b=c") == ("a", "b=c")


def _result(tag, compute, temp):
    return {"tag": tag, "memory": {"temp_bytes": temp},
            "roofline": {"compute_s": compute, "memory_s": 0.5,
                         "collective_s": 0.25, "bottleneck": "memory",
                         "roofline_fraction": compute / 0.5}}


def test_compare_prints_baseline_then_tags(tmp_path, capsys):
    base = tmp_path / "dryrun"
    climb = tmp_path / "hillclimb"
    base.mkdir()
    climb.mkdir()
    (base / "a__s__single.json").write_text(json.dumps(
        _result("", 0.125, 2 ** 31)))
    (climb / "a__s__single__dots.json").write_text(json.dumps(
        _result("dots", 0.25, None)))
    hillclimb.main(["--out", str(climb), "--compare", "a", "s", "single"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].split()[:2] == ["tag", "compute_s"]
    assert lines[1].split()[:2] == ["baseline", "0.1250"]
    assert "2.00" in lines[1]
    assert lines[2].split()[:2] == ["dots", "0.2500"] and "n/a" in lines[2]


def test_dryrun_cli_lists_and_records_skips(tmp_path):
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           "llama3.2-1b", "--mesh", "single", "--out", str(tmp_path)]
    res = subprocess.run(cmd + ["--list"], env=_env(), capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    rows = [line.split() for line in res.stdout.strip().splitlines()]
    assert [r[1] for r in rows] == [sp.name for sp in SHAPES]
    assert [r[3] for r in rows] == ["False"] * 3 + ["True"]
    res = subprocess.run(cmd + ["--shape", "long_500k"], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    rec = json.loads((tmp_path / "llama3_2_1b__long_500k__single.json")
                     .read_text())
    assert rec["skipped"] is True and "long_500k" in rec["reason"]
    assert "skip=1" in res.stdout
