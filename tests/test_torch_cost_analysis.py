"""`LocalOpCounter`'s live bytes and `calibrate_cell`'s extrapolation,
on the CPU (meta tensors, seconds).

- Live bytes are counted per storage: a view that outlives its base
  keeps the base's bytes; an in-place op's result and a view of an
  argument add nothing; a functional collective's output handed on by
  `wait_tensor` (and by the autograd wrap of a collective's result)
  stays counted until its last holder dies, not when a Python storage
  wrapper does.
- `calibrate_cell`'s extrapolated flops and collective bytes equal one
  direct `LocalOpCounter` trace of the whole cut model within 1%, for
  a cut decoder-only config (llama3.2-1b at 4 layers) and a cut
  encoder-decoder (seamless at 3 + 3 layers, 3 groups of one encoder
  and one decoder layer) at a small prefill shape, at d_model 512 (one
  layer's weights large enough to split as the whole model's) on a (4,
  2) mesh of a fake 8-rank group; so do a training step's flops.
  Without autograd the extrapolated live-bytes peak is the whole
  trace's (up to the groups' 4-byte aux scalars), and a cut llama's
  decode returns exactly the whole trace's output bytes (every layer's
  caches).  Splitting or unbinding an argument adds no bytes.  An
  encoder-decoder whose stacks differ in depth is refused.

The fake process group is global to a process, so the group work runs
in one child interpreter.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch.cost_analysis import LocalOpCounter
from repro_torch.launch.dryrun import _calibration_cfg

ROOT = Path(__file__).resolve().parents[1]
N = 1024  # float32 elements: 4096 B


def test_a_view_that_outlives_its_base_keeps_its_bytes():
    with LocalOpCounter() as ops:
        base = torch.empty(N, device="meta")
        view = base[: N // 4].view(16, 16)
        del base
        assert ops.live_bytes == 4 * N
        del view
        assert ops.live_bytes == 0
    assert ops.peak_bytes == 4 * N


def test_in_place_results_and_views_of_arguments_add_nothing():
    arg = torch.zeros(N, device="meta")
    with LocalOpCounter() as ops:
        view = arg.view(32, 32)
        same = arg.mul_(2.0)
        new = arg + 1.0
        assert ops.live_bytes == 4 * N  # `new` alone
        x = torch.ones(N, device="meta")
        y = x.add_(1.0)
        del x
        assert ops.live_bytes == 8 * N  # y holds x's storage
        del y, new
        assert ops.live_bytes == 0
    del view, same


_COLLECTIVE = textwrap.dedent("""
    import torch
    from repro_torch.launch.cost_analysis import LocalOpCounter
    from repro_torch.launch.mesh import fake_group

    f = torch.ops._c10d_functional
    n = 1024
    with fake_group(4):
        name = torch.distributed.group.WORLD.group_name
        with LocalOpCounter() as ops:
            x = torch.empty(n, device="meta")
            y = f.all_reduce(x, "sum", name)
            del x
            assert ops.live_bytes == 4 * n, ops.live_bytes
            z = f.wait_tensor(y)
            del y
            assert ops.live_bytes == 4 * n, ops.live_bytes
            s = z.untyped_storage()
            del s  # a Python storage wrapper is not a holder
            assert ops.live_bytes == 4 * n, ops.live_bytes
            w = z[: n // 2]
            del z
            assert ops.live_bytes == 4 * n, ops.live_bytes
            del w
            assert ops.live_bytes == 0, ops.live_bytes
            # the autograd wrap of a collective's result, a new storage
            # on the meta device, holds the collective's bytes
            g = f.all_gather_into_tensor(torch.empty(n, device="meta"), 4,
                                         name)
            h = f._wrap_tensor_autograd(g)
            del g
            assert ops.live_bytes == 16 * n, ops.live_bytes
            del h
            assert ops.live_bytes == 0, ops.live_bytes
        assert ops.log == [("all-reduce", 4, 4 * n),
                           ("all-gather", 4, 16 * n)], ops.log
        assert ops.peak_bytes == 20 * n, ops.peak_bytes
    print("COLLECTIVE_OK")
""")

_CALIBRATE = textwrap.dedent("""
    import contextlib, dataclasses, json
    from repro_torch.configs import get_config
    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.launch.dryrun import _trace, calibrate_cell
    from repro_torch.launch.mesh import Mesh, fake_group
    from repro_torch.launch.specs import build_cell

    mesh = Mesh((4, 2), ("data", "model"))
    # widths where one layer's leaves reach the rules' REPLICATE_BELOW,
    # so that the cut configs' weights split as the whole model's do
    wide = dict(d_model=512, n_heads=8, head_dim=64, d_ff=1024)
    cuts = {"llama3_2_1b": dict(wide, n_layers=4, n_kv=2),
            "seamless_m4t_medium": dict(wide, n_layers=6, n_kv=8,
                                        enc_layers=3, dec_layers=3)}
    with fake_group(8):
        dmesh = mesh.device_mesh("cpu")
        for arch, cut in cuts.items():
            cfg = get_config(arch).reduced(**cut)
            kinds = ("prefill", "train") + (
                ("decode",) if arch == "llama3_2_1b" else ())
            for kind in kinds:
                sp = ShapeSpec(f"cut_{kind}", 64, 8, kind)
                cal = calibrate_cell(arch, sp, mesh, cfg, mesh.size,
                                     dmesh=dmesh)
                cell = build_cell(arch, sp, mesh, cfg,
                                  accum_steps=1 if kind == "train" else None,
                                  dmesh=dmesh)
                whole = _trace(cell, contextlib.nullcontext())
                print(json.dumps({
                    "arch": arch, "kind": kind,
                    "n_groups": cal["n_groups"],
                    "cal": [cal["flops"], cal["coll"], cal["temp"],
                            cal["out"]],
                    "whole": [whole["flops"], whole["coll"],
                              whole["temp"], whole["out"]]}), flush=True)
""")


def _env():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    return env


def test_a_collectives_output_stays_counted_through_its_wait():
    res = subprocess.run([sys.executable, "-c", _COLLECTIVE], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "COLLECTIVE_OK" in res.stdout


@pytest.fixture(scope="module")
def calibrated():
    """{(arch, kind): {"n_groups", "cal", "whole"}} from one child."""
    import json

    res = subprocess.run([sys.executable, "-c", _CALIBRATE], env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    rows = [json.loads(ln) for ln in res.stdout.splitlines()
            if ln.startswith("{")]
    return {(r["arch"], r["kind"]): r for r in rows}


ARCHS = ("llama3_2_1b", "seamless_m4t_medium")


def _close(got, want, rel):
    assert want > 0 and abs(got / want - 1) <= rel, (got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_extrapolation_equals_a_trace_of_the_whole_cut_model(
        calibrated, arch):
    r = calibrated[arch, "prefill"]
    assert r["n_groups"] == (4 if arch == "llama3_2_1b" else 3)
    (flops, coll, _, _), (w_flops, w_coll, _, _) = r["cal"], r["whole"]
    _close(flops, w_flops, 0.01)
    _close(coll, w_coll, 0.01)


@pytest.mark.parametrize("arch", ARCHS)
def test_extrapolated_training_flops_equal_the_whole_traces(calibrated,
                                                             arch):
    r = calibrated[arch, "train"]
    assert r["n_groups"] == (4 if arch == "llama3_2_1b" else 3)
    _close(r["cal"][0], r["whole"][0], 0.01)


@pytest.mark.parametrize("arch", ARCHS)
def test_without_autograd_the_peak_is_the_whole_traces(calibrated, arch):
    r = calibrated[arch, "prefill"]
    _close(r["cal"][2], r["whole"][2], 1e-3)


def test_a_decodes_output_bytes_hold_every_layers_caches(calibrated):
    """A decode step returns the logits and every group's caches, so its
    output bytes grow with the group count: the extrapolated figure is
    one trace of the whole cut model's."""
    r = calibrated["llama3_2_1b", "decode"]
    assert r["n_groups"] == 4
    assert r["cal"][3] == r["whole"][3]
    _close(r["cal"][0], r["whole"][0], 0.01)


def test_multi_output_views_of_an_argument_add_nothing():
    arg = torch.empty(4, N // 4, device="meta")
    with LocalOpCounter() as ops:
        rows = arg.unbind(0)
        parts = arg.split(N // 16, dim=1)
        sized = arg.split_with_sizes([N // 8, N // 8], dim=1)
        chunks = torch.chunk(arg, 4, dim=1)
        assert ops.live_bytes == 0
    assert ops.peak_bytes == 0
    del rows, parts, sized, chunks


def test_unequal_encoder_decoder_stacks_are_refused():
    cfg = get_config("seamless_m4t_medium")
    cut, n_groups = _calibration_cfg(cfg, 2)
    assert (cut.enc_layers, cut.dec_layers, cut.n_layers) == (2, 2, 4)
    assert n_groups == cfg.enc_layers == 12
    with pytest.raises(ValueError, match="enc_layers == dec_layers"):
        _calibration_cfg(dataclasses.replace(cfg, dec_layers=10), 1)
