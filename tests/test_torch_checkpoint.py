"""The port's CheckpointManager: the reference's cases on the port, and
its on-disk layout.

Round trip, keep-K with the `latest` pointer, async save (and a write
error raised by the next `wait()`), missing key, shape mismatch and
restore onto a named device (the port's stand-in for the reference's
`shardings=`); a bfloat16 leaf and a bfloat16 optimizer moment come
back bit for bit.  The files are the reference's: a checkpoint the
reference wrote restores in the port, and one the port wrote (float
leaves) restores in the reference.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro_torch.checkpoint import CheckpointManager
from repro_torch.optim import adamw


def test_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    state = {"params": {"w": torch.arange(6.0).reshape(2, 3)},
             "count": torch.tensor(7, dtype=torch.int32)}
    mgr.save(5, state, extra={"note": "x"})
    assert mgr.latest_step() == 5
    restored, meta = mgr.restore(state)
    assert torch.equal(restored["params"]["w"], state["params"]["w"])
    assert restored["count"].dtype == torch.int32 and restored["count"] == 7
    assert meta["step"] == 5 and meta["extra"] == {"note": "x"}
    assert sorted(os.listdir(tmp_path / "step_0000000005")) == [
        "arrays.npz", "meta.json"]


def test_keep_k_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"x": torch.full((3,), float(s))})
    dirs = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert dirs == ["step_0000000003", "step_0000000004"]
    assert (tmp_path / "latest").read_text() == "step_0000000004"
    restored, meta = mgr.restore({"x": torch.zeros(3)})
    assert meta["step"] == 4 and (restored["x"] == 4.0).all()
    old, meta = mgr.restore({"x": torch.zeros(3)}, step=3)
    assert meta["step"] == 3 and (old["x"] == 3.0).all()


def test_async_save_and_error_surfaces(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=True)
    x = torch.ones(4)
    mgr.save(1, {"x": x})
    x.add_(1.0)  # the snapshot was taken at save()
    mgr.wait()
    assert mgr.latest_step() == 1
    assert (mgr.restore({"x": x})[0]["x"] == 1.0).all()
    (tmp_path / "step_0000000002.tmp").write_text("a file, not a dir")
    mgr.save(2, {"x": x})
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()  # the error is raised once


def test_missing_key_and_shape_mismatch(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, {"x": torch.ones((2, 2))})
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore({"x": torch.ones((3, 3))})
    with pytest.raises(KeyError, match="y"):
        mgr.restore({"x": torch.ones((2, 2)), "y": torch.ones(1)})
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore({})


def test_restore_onto_named_device(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    state = {"x": torch.arange(8.0)}
    mgr.save(1, state)
    restored, _ = mgr.restore(state, device=torch.device("cpu"))
    assert restored["x"].device == torch.device("cpu")
    assert torch.equal(restored["x"], state["x"])
    restored, _ = mgr.restore({"x": torch.zeros(8, dtype=torch.float64)})
    assert restored["x"].dtype == torch.float64  # the template's dtype


def test_bf16_leaves_bit_exact(tmp_path):
    gen = torch.Generator().manual_seed(0)
    w = torch.randn(33, 7, generator=gen).bfloat16()
    w.view(torch.int16)[0, :3] = torch.tensor([0x7FC1, -1, 0x0001],
                                              dtype=torch.int16)  # NaN, sub
    params = {"w": torch.randn(33, 7, generator=gen)}
    cfg = adamw.AdamWConfig(m_dtype="bfloat16")
    opt = adamw.init(params, cfg)
    params, opt, _ = adamw.update({"w": torch.randn(33, 7, generator=gen)},
                                  opt, params, cfg)
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(3, (params, opt, {"raw": w}))
    meta = json.loads((tmp_path / "step_0000000003" / "meta.json")
                      .read_text())
    assert meta["dtypes"] == {"1|m|w": "bfloat16", "2|raw": "bfloat16"}
    tmpl = (params, adamw.init(params, cfg), {"raw": torch.zeros_like(w)})
    (p2, opt2, extra), _ = mgr.restore(tmpl)
    assert opt2.m["w"].dtype == torch.bfloat16
    for a, b in ((opt2.m["w"], opt.m["w"]), (extra["raw"], w)):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    assert torch.equal(p2["w"], params["w"]) and opt2.count == 1


def test_files_interchange_with_reference(tmp_path):
    jm = JManager(str(tmp_path / "j"), async_save=False)
    jm.save(4, {"a": {"w": jnp.arange(6.0).reshape(2, 3)},
                "n": jnp.asarray(3, jnp.int32)})
    got, meta = CheckpointManager(str(tmp_path / "j")).restore(
        {"a": {"w": torch.zeros(2, 3)}, "n": torch.zeros((), dtype=torch.int32)})
    assert meta["step"] == 4 and int(got["n"]) == 3
    np.testing.assert_array_equal(got["a"]["w"].numpy(),
                                  np.arange(6.0).reshape(2, 3))
    tm = CheckpointManager(str(tmp_path / "t"), async_save=False)
    tm.save(2, {"a": {"w": torch.full((2, 2), 1.5)}})
    back, _ = JManager(str(tmp_path / "t")).restore(
        {"a": {"w": jnp.zeros((2, 2))}})
    np.testing.assert_array_equal(np.asarray(back["a"]["w"]), 1.5)
