"""The xLSTM's recurrences on local shards (`sharding/hints.py::
UnitSplit`), on the CPU.

xlstm-350m `reduced()` at d 256 (4 heads; the rules split Wx, the
mLSTM projections and the sLSTM's r over "model"), with remat.  Its 4
heads do not split over "model"; the (batch row, head) units do, and
each unit's recurrence is independent of the others'.

- The sLSTM step is one registered op with a hand-written backward
  (`models/xlstm.py::slstm_step`): its gradients equal autograd's of
  the composite step, ties of both `maximum`s included.
- Structure, on a fake 8-rank group, meshes (2, 4) and (4, 2), meta
  tensors: the train, prefill and decode cells need no view fallback;
  each rank runs 4 units of both recurrences (16 or 8 units over 4 or
  2 "model" ranks); inside the sLSTM's time loop, forward and
  backward, no collective runs between two steps (at most one, no
  larger than h's (B_l, d), is the bound held); Wx's, r's and the
  mLSTM projections' gradients come back on their parameters'
  placements.
- Numerics, on a 4-rank gloo group (one child process per rank),
  float32: on a (2, 2) mesh the train, prefill and decode cells equal
  the unsharded port functions in every rank, and rank 0's the JAX
  package's, at `tests/test_torch_heads.py`'s tolerances; on a (1, 4)
  mesh a 2-head config of batch 1 (2 units over 4 ranks, each shared
  by 2 ranks) gives the unsharded blocks' outputs and gradients.
"""
import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget
from repro.core.guard import guard_init as jguard_init
from repro.launch.specs import GUARD_CFG as JGUARD_CFG
from repro.launch.specs import make_train_step as jmake_train_step
from repro.models import init_cache as jinit_cache
from repro.models import lm_decode_step as jdecode
from repro.models import lm_prefill as jprefill
from repro.optim import adamw as jadamw
from repro_torch.configs import get_config
from repro_torch.models import init_lm_params, lm_params_to_numpy
from repro_torch.models import xlstm as tx

ROOT = Path(__file__).resolve().parents[1]
ARCH = "xlstm-350m"
WIDE = dict(d_model=256, ce_chunk=16, remat=True)
F32 = dict(compute_dtype="float32", kv_dtype="float32")
OPT = dict(warmup_steps=1, total_steps=10, eps=1e-3)  # as test_torch_cells


def _env():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    return env


# ------------------------------------------------- the step's backward --
@pytest.mark.parametrize("case", ["random", "empty memory", "ties"])
def test_step_backward_equals_autograd(case):
    gen = torch.Generator().manual_seed(0)
    b, h, p = 3, 2, 4
    d = h * p

    def draw(*shape):
        return torch.randn(shape, generator=gen)

    r, xw, c, n, hp = draw(4, h, p, p), draw(b, 4 * d), *(
        draw(b, d) for _ in range(3))
    m = draw(b, d)
    if case == "empty memory":
        m = torch.full((b, d), tx.M0)
    if case == "ties":  # lf + m == li: the first maximum ties
        lf = torch.nn.functional.logsigmoid(xw[:, 2 * d:3 * d])
        m = xw[:, d:2 * d] - lf
        n = n.abs()
    ins = [t.clone().requires_grad_() for t in (r, xw, c, n, hp, m)]
    out = tx.slstm_step(*ins, h)
    ref = tx._step(*ins, h)
    for a, e in zip(out, ref):
        torch.testing.assert_close(a, e, rtol=0, atol=0)
    cot = [draw(*t.shape) for t in out]
    got = torch.autograd.grad(out, ins, cot)
    want = torch.autograd.grad(ref, ins, cot)
    for name, a, e in zip(("r", "xw", "c", "n", "h", "m"), got, want):
        torch.testing.assert_close(a, e, rtol=1e-5, atol=1e-6, msg=name)


# ----------------------------------------------- structure, fake group --
_STRUCTURE = textwrap.dedent("""
    import json, sys
    import torch
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_config
    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.launch.cost_analysis import LocalOpCounter
    from repro_torch.launch.mesh import Mesh, fake_group
    from repro_torch.launch.specs import build_cell
    from repro_torch.models import xlstm
    from repro_torch.models.transformer import lm_loss

    steps, units = {"fwd": [], "bwd": []}, set()
    fwd, bwd, chunks = (xlstm.slstm_step, xlstm.slstm_step_backward,
                        xlstm._mlstm_chunks)

    def seen(kind, op):
        def run(*args):
            for m in _get_current_dispatch_mode_stack():
                if isinstance(m, LocalOpCounter):
                    steps[kind].append(len(m.log))
            units.add(("slstm", tuple(args[1].shape)))
            return op(*args)
        return run

    def chunks_seen(q, *args):
        units.add(("mlstm", tuple(q.shape)))
        return chunks(q, *args)

    xlstm.slstm_step = seen("fwd", fwd)
    xlstm.slstm_step_backward = seen("bwd", bwd)
    xlstm._mlstm_chunks = chunks_seen
    cfg = get_config("xlstm-350m").reduced(**json.loads(sys.argv[1]))
    out = {}
    for shape in ((2, 4), (4, 2)):
        mesh = Mesh(shape, ("data", "model"))
        with fake_group(8):
            dmesh = mesh.device_mesh("cpu")
            for kind in ("train", "prefill", "decode"):
                for v in steps.values():
                    v.clear()
                units.clear()
                cell = build_cell("xlstm-350m", ShapeSpec(kind, 64, 8, kind),
                                  mesh, cfg, dmesh=dmesh)
                with LocalOpCounter() as ops:
                    cell.fn(*cell.args)
                # the collectives logged between two steps of one loop
                between = []
                for marks in steps.values():
                    for a, b in zip(marks, marks[1:]):
                        between.append(ops.log[a:b])
                out[f"{shape}/{kind}"] = {
                    "fallbacks": [repr(f) for f in cell.fn.fallbacks],
                    "steps": {k: len(v) for k, v in steps.items()},
                    "between": between, "units": sorted(units)}
            cell = build_cell("xlstm-350m", ShapeSpec("g", 64, 8, "train"),
                              mesh, cfg, dmesh=dmesh)
            model, batch = cell.args[0], cell.args[3]
            with implicit_replication():
                loss, _ = lm_loss(model, batch, cfg)
                loss.backward()
            out[f"{shape}/grads"] = {
                n: [str(p.placements), str(p.grad.placements)]
                for n, p in model.named_parameters()
                if n.endswith((".r", ".w")) and "lstm." in n}
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def structure():
    res = subprocess.run(
        [sys.executable, "-c", _STRUCTURE, json.dumps(WIDE)], env=_env(),
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


MESHES = ["(2, 4)", "(4, 2)"]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_no_view_is_resharded(structure, mesh, kind):
    assert structure[f"{mesh}/{kind}"]["fallbacks"] == []


@pytest.mark.parametrize("mesh", MESHES)
def test_each_rank_runs_four_units(structure, mesh):
    """sLSTM: xw (1, 4 gates x 4 units x 64); mLSTM: q (4 units, 64, 1,
    128)."""
    got = structure[f"{mesh}/train"]["units"]
    assert got == [["mlstm", [4, 64, 1, 128]], ["slstm", [1, 1024]]], got


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_the_time_loop_exchanges_nothing(structure, mesh, kind):
    rec = structure[f"{mesh}/{kind}"]
    # one sLSTM layer of 64 steps: forward, recomputed and backward
    want = {"fwd": 128, "bwd": 64} if kind == "train" else \
        {"fwd": 64, "bwd": 0}
    assert rec["steps"] == want
    h_bytes = 8 // int(mesh[1]) * 256 * 4  # h: (B_l, d) float32
    loops = [seg for seg in rec["between"] if len(seg) <= 1]
    # between the last step of a loop and the first of the next one
    # (other layers, the backward) the count is free
    assert len(rec["between"]) - len(loops) <= 1 + (kind == "train")
    for seg in loops:
        assert all(b <= h_bytes for _, _, b in seg), seg
    assert sum(len(seg) for seg in loops) == 0, loops


@pytest.mark.parametrize("mesh", MESHES)
def test_gradients_land_on_the_parameters_placements(structure, mesh):
    grads = structure[f"{mesh}/grads"]
    assert any(n.endswith("slstm.r") for n in grads), sorted(grads)
    for n, (param, grad) in grads.items():
        assert grad == param, (n, param, grad)


# ------------------------------------------------ numerics, 4-rank gloo --
_RANK = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, distribute_tensor
    from repro_torch.configs import get_config
    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.core.guard import guard_init
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.specs import (GUARD_CFG, build_cell,
                                          make_train_step)
    from repro_torch.models import (init_cache, init_lm_params,
                                    lm_decode_step, lm_prefill, xlstm)
    from repro_torch.optim import adamw

    torch.set_num_threads(1)
    rank, world, port, path = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4])
    over, opt_over = json.loads(sys.argv[5]), json.loads(sys.argv[6])
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)

    def full(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    def close(a, b, what, rtol=1e-4, atol=1e-5):
        torch.testing.assert_close(full(a), b, rtol=rtol, atol=atol,
                                   msg=lambda m: f"{what}: {m}")

    def call(cell, *args):
        out = cell.fn(*(args or cell.args))
        assert cell.fn.fallbacks == [], cell.fn.fallbacks
        return out

    def cells(cfg, saved):
        mesh = Mesh((2, 2), ("data", "model"))
        opt = adamw.AdamWConfig(**opt_over)
        cell = build_cell("xlstm-350m", ShapeSpec("t", 64, 8, "train"), mesh,
                          cfg, opt_cfg=opt, device="cpu", seed=3)
        batch = {n: full(v).clone() for n, v in cell.args[3].items()}
        ref = init_lm_params(3, cfg, device="cpu")
        rout = make_train_step(cfg, opt)(
            ref, adamw.init(dict(ref.named_parameters())),
            guard_init(GUARD_CFG, "cpu"), batch)
        out = call(cell)
        for k in ("loss", "grad_norm", "lr", "skipped", "ce"):
            close(out[3][k], rout[3][k], k, atol=0.0)
            saved["metric_" + k] = full(out[3][k]).numpy()
        for (n, p), q in zip(out[0].named_parameters(), ref.parameters()):
            close(p.detach(), q.detach(), n, rtol=1e-3, atol=1e-6)
            saved["param_" + n] = full(p.detach()).numpy()
        saved["tokens"] = batch["tokens"].numpy()
        cell = build_cell("xlstm-350m", ShapeSpec("p", 64, 8, "prefill"),
                          mesh, cfg, device="cpu", seed=5)
        tokens = full(cell.args[1]).clone()
        logits = call(cell)
        close(logits, lm_prefill(init_lm_params(5, cfg, device="cpu"),
                                 tokens, cfg), "prefill")
        saved["prefill_tokens"] = tokens.numpy()
        saved["prefill_logits"] = full(logits).numpy()
        cell = build_cell("xlstm-350m", ShapeSpec("d", 64, 8, "decode"),
                          mesh, cfg, device="cpu", seed=4)
        token = full(cell.args[1]).clone()
        rlog, rcache = lm_decode_step(
            init_lm_params(4, cfg, device="cpu"), token, 0,
            init_cache(cfg, 8, 64, dtype=torch.float32, device="cpu"), cfg)
        logits, caches = call(cell)
        close(logits, rlog.detach(), "decode logits")
        for i, (c, rc) in enumerate(zip(caches, rcache)):
            for f, a, b in zip(c._fields, c, rc):
                close(a, b, f"cache {i} {f}")
        saved["decode_token"] = token.numpy()
        saved["decode_logits"] = full(logits).numpy()

    def shared_units(cfg):
        # 2 heads x batch 1 over 4 "model" ranks: each unit on 2 ranks
        mesh = Mesh((1, 4), ("data", "model"))
        cell = build_cell("xlstm-350m", ShapeSpec("p", 16, 1, "prefill"),
                          mesh, cfg, device="cpu", seed=8)
        ref = init_lm_params(8, cfg, device="cpu")
        gen = torch.Generator().manual_seed(9)
        x = torch.randn((1, 16, cfg.d_model), generator=gen)
        dmesh = cell.args[0].embed.table.device_mesh
        for j, fn in ((0, xlstm.mlstm_forward), (1, xlstm.slstm_forward)):
            kind = ("mlstm", "slstm")[j]
            p, q = cell.args[0].blocks[j][kind], ref.blocks[j][kind]
            xd = distribute_tensor(x, dmesh, [Replicate(), Replicate()],
                                   src_data_rank=None)
            y1, y0 = fn(p, xd, cfg), fn(q, x, cfg)
            close(y1, y0, kind)
            y1.sum().backward()
            y0.sum().backward()
            for n, w in q.named_parameters():
                g = p.get_parameter(n).grad
                if n.endswith(("r", ".w")):  # the products' own layouts
                    assert g.placements == p.get_parameter(n).placements, n
                close(g, w.grad, f"{kind} grad {n}", rtol=1e-3)

    try:
        saved = {}
        cfg = get_config("xlstm-350m").reduced(**over)
        cells(cfg, saved)
        shared_units(get_config("xlstm-350m").reduced(**dict(over,
                                                             n_heads=2)))
        if rank == 0:
            np.savez(path, **saved)
    finally:
        dist.destroy_process_group()
    print("XLSTM_OK", rank)
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def gloo_xlstm(tmp_path_factory):
    """Rank 0's results of `_RANK` (every rank checked itself against
    the unsharded port functions)."""
    path = tmp_path_factory.mktemp("xlstm") / "rank0.npz"
    world, port = 4, str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), str(world), port, str(path),
         json.dumps(dict(WIDE, **F32)), json.dumps(OPT)],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(world)]
    try:
        results = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, (out, err)) in enumerate(zip(procs, results)):
        assert p.returncode == 0, f"rank {r}: {err[-3000:]}"
        assert f"XLSTM_OK {r}" in out
    return dict(np.load(path))


def _configs():
    return (jget(ARCH).reduced(**WIDE, **F32),
            get_config(ARCH).reduced(**WIDE, **F32))


def _jax_params(seed, tc):
    tree = lm_params_to_numpy(init_lm_params(seed, tc, device="cpu"))
    return jax.tree_util.tree_map(jnp.asarray, tree)


def test_train_cell_equals_the_jax_step(gloo_xlstm):
    got = gloo_xlstm
    jc, tc = _configs()
    jp = _jax_params(3, tc)
    jp, _, _, jm = jax.jit(jmake_train_step(jc, jadamw.AdamWConfig(**OPT)))(
        jp, jadamw.init(jp), jguard_init(JGUARD_CFG),
        {"tokens": jnp.asarray(got["tokens"])})
    for k in ("loss", "grad_norm", "lr", "skipped", "ce"):
        np.testing.assert_allclose(got["metric_" + k], float(jm[k]),
                                   rtol=1e-4, err_msg=k)
    model = init_lm_params(3, tc, device="cpu")
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(torch.from_numpy(got["param_" + n]))
    tree = lm_params_to_numpy(model)
    for (path, a), b in zip(
            jax.tree_util.tree_flatten_with_path(
                jax.tree_util.tree_map(np.asarray, jp))[0],
            jax.tree_util.tree_leaves(tree)):
        np.testing.assert_allclose(b, a, rtol=1e-3, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))


def test_prefill_cell_equals_the_jax_prefill(gloo_xlstm):
    jc, tc = _configs()
    logits = jax.jit(lambda p, t: jprefill(p, t, jc))(
        _jax_params(5, tc), jnp.asarray(gloo_xlstm["prefill_tokens"]))
    np.testing.assert_allclose(gloo_xlstm["prefill_logits"],
                               np.asarray(logits), rtol=1e-4, atol=1e-5)


def test_decode_cell_equals_the_jax_step(gloo_xlstm):
    jc, tc = _configs()
    logits, _ = jax.jit(lambda p, t, c: jdecode(p, t, 0, c, jc))(
        _jax_params(4, tc), jnp.asarray(gloo_xlstm["decode_token"]),
        jinit_cache(jc, 8, 64, dtype=jnp.float32))
    np.testing.assert_allclose(gloo_xlstm["decode_logits"],
                               np.asarray(logits), rtol=1e-4, atol=1e-5)
