"""The port's training loop against the JAX package's, on the CPU.

`make_train_step` runs 6 steps from one converted parameter tree on the
same token batches on both sides (llama3.2-1b `reduced()`, float32
compute, a corrupt batch at step 4 and a guard sharp enough to flag it
within 6 steps): loss, grad norm, lr and the skip verdict per step agree
at rtol 1e-4, and the final parameters at rtol 1e-3.  `train()` itself
runs 8 finite steps and resumes with 2 of 6 steps left, as the
reference's launcher test checks.
"""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget
from repro.core.guard import GuardConfig as JGuardConfig
from repro.core.guard import guard_init as jguard_init
from repro.data import TokenStream as JTokenStream
from repro.launch.specs import make_train_step as jmake_train_step
from repro.models import init_lm_params as jinit
from repro.optim import adamw as jadamw
from repro_torch.configs import get_config
from repro_torch.core import GuardConfig, guard_init
from repro_torch.launch.specs import make_train_step
from repro_torch.launch.train import scaled_config, train
from repro_torch.models import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.optim import adamw

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
GUARD = dict(m=2.0, warmup_steps=2)
OPT = dict(warmup_steps=2, total_steps=6)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_reference(accum):
    over = dict(compute_dtype="float32")
    jc = jget("llama3.2-1b").reduced(**over)
    tc = get_config("llama3.2-1b").reduced(**over)
    jp = jinit(jax.random.PRNGKey(1), jc)
    model = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tc,
                                 device="cpu")
    jstep = jax.jit(jmake_train_step(jc, jadamw.AdamWConfig(**OPT),
                                     accum_steps=accum,
                                     guard_cfg=JGuardConfig(**GUARD)))
    tstep = make_train_step(tc, adamw.AdamWConfig(**OPT), accum_steps=accum,
                            guard_cfg=GuardConfig(**GUARD))
    jo, jg = jadamw.init(jp), jguard_init(JGuardConfig(**GUARD))
    to = adamw.init(dict(model.named_parameters()))
    tg = guard_init(GuardConfig(**GUARD), device="cpu")
    stream = JTokenStream(tc.vocab, 4, 32, corrupt_every=4)
    skips = []
    for step in range(6):
        toks = stream.batch_at(step)["tokens"]
        jp, jo, jg, jm = jstep(jp, jo, jg, {"tokens": jnp.asarray(toks)})
        model, to, tg, tm = tstep(model, to, tg,
                                  {"tokens": torch.from_numpy(toks)})
        assert float(tm["skipped"]) == float(jm["skipped"]), step
        for k in ("loss", "grad_norm", "lr", "ce", "ppl_proxy"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-4, err_msg=f"{k} @ {step}")
        skips.append(bool(tm["skipped"]))
    assert skips == [False] * 4 + [True, False]  # the corrupt batch
    assert int(to.count) == int(jo.count) == 5
    assert int(tg.skipped) == int(jg.skipped) == 1
    for a, b in zip(jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(np.asarray, jp)),
            jax.tree_util.tree_leaves(lm_params_to_numpy(model))):
        np.testing.assert_allclose(b, a, rtol=1e-3, atol=1e-6)


def test_train_loop_runs_finite():
    cfg = get_config("llama3.2-1b").reduced()
    model, hist, summary = train(cfg, steps=8, batch=4, seq=32,
                                 ckpt_dir=None, device="cpu", log_every=100)
    assert len(hist) == 8
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
               for h in hist)
    assert set(hist[0]) == {"ce", "aux", "ppl_proxy", "loss", "grad_norm",
                            "lr", "skipped"}
    assert summary["skipped"] == 0  # the default guard is still warming up
    assert len(summary["step_s"]) == 8 and min(summary["step_s"]) > 0
    assert next(model.parameters()).device == torch.device("cpu")


def test_train_checkpoint_resume(tmp_path):
    cfg = get_config("llama3.2-1b").reduced()
    opt = adamw.AdamWConfig(warmup_steps=2, total_steps=6)
    train(cfg, steps=4, batch=2, seq=32, ckpt_dir=str(tmp_path),
          save_every=2, device="cpu", opt_cfg=opt)
    _, hist, _ = train(cfg, steps=6, batch=2, seq=32, ckpt_dir=str(tmp_path),
                       resume=True, device="cpu", opt_cfg=opt)
    assert len(hist) == 2  # resumed at step 4 of 6
    _, full, _ = train(cfg, steps=6, batch=2, seq=32, ckpt_dir=None,
                       device="cpu", opt_cfg=opt)
    for a, b in zip(hist, full[4:]):  # the same state, the same batches
        assert a == b


def test_train_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train(get_config("llama3.2-1b").reduced(), 1, 1, 8, None)


def test_cli_scales_and_production_mesh():
    assert scaled_config("llama3.2-1b", "full").d_model == 2048
    small = scaled_config("llama3.2-1b", "small")
    assert (small.n_layers, small.d_model, small.vocab) == (8, 512, 32768)
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    # the 16 x 16 mesh needs 256 ranks: a world of 1 is refused
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          "--production-mesh"], env=env, capture_output=True,
                         text=True, timeout=60)
    assert res.returncode != 0 and "256" in res.stderr \
        and "this world has 1" in res.stderr
