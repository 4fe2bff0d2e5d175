"""The MoE's dispatch on local shards (`sharding/hints.py::ExpertSplit`),
on the CPU.

Reduced mixtral configs, widened so that the rules split the expert
weights (d 256, d_ff 512, 4 heads): "tp" has 2 experts (3 on the
4-rank mesh), which do not split over "model": the rule splits d_ff
there (tensor-parallel); "ep" has 4 experts, split over "model"
(expert-parallel).  Each also with `moe_chunk` 128, so that 512 tokens
route in blocks.

- Structure, on a fake 8-rank group, mesh (2, 4), meta tensors: the
  train, prefill and decode cells need no view fallback, chunked or
  not; each rank builds only its share of the buffer (tp: every
  expert, half the capacity slots, d_ff / 4; ep: one expert, half the
  slots); the expert weights' gradients come back on the parameters'
  placements; the optimizer's update gathers no expert weight; a
  block that spans 2 of the 4 "data" ranks (mesh (4, 2), blocks of 256
  tokens over ranks of 128) is gathered over that pair alone (a derived
  mesh splits "data" into (2, 2)), with no fallback; a block that lines
  up with no split (blocks of 128 over ranks of 96) is gathered on
  every rank and recorded as a fallback.
- Numerics, on a 4-rank gloo group (one child process per rank),
  float32: one MoE layer on DTensors (its batch split over "data", so
  that each block's routes are gathered) gives the unsharded layer's
  output, aux values and gradients, the same routes block by block and
  the same `dropped_frac`, on a (2, 2) mesh and on a (4, 1) mesh whose
  blocks of 256 tokens span pairs of ranks; on the (2, 2) mesh the
  train, prefill and decode cells equal the unsharded port functions in
  every rank and rank 0's the JAX package's, at
  `tests/test_torch_heads.py`'s tolerances.
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

ROOT = Path(__file__).resolve().parents[1]
ARCH = "mixtral-8x7b"
WIDE = dict(d_model=256, n_heads=4, n_kv=2, head_dim=64, d_ff=512,
            ce_chunk=16, remat=True)
FAKE = {"tp": dict(WIDE, n_experts=2), "ep": dict(WIDE, n_experts=4)}
GLOO = {"tp": dict(WIDE, n_experts=3), "ep": dict(WIDE, n_experts=4),
        "tp-chunked": dict(WIDE, n_experts=3, moe_chunk=128),
        "ep-chunked": dict(WIDE, n_experts=4, moe_chunk=128)}
F32 = dict(compute_dtype="float32", kv_dtype="float32")
OPT = dict(warmup_steps=1, total_steps=10, eps=1e-3)  # as test_torch_cells


def _env():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    return env


# ----------------------------------------------- structure, fake group --
_STRUCTURE = textwrap.dedent("""
    import dataclasses, json, sys
    import torch
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_config
    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.launch import specs
    from repro_torch.launch.cost_analysis import LocalOpCounter
    from repro_torch.launch.mesh import Mesh, fake_group
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.transformer import lm_loss

    seen, updates = [], []
    experts, update = moe_mod._experts, specs.adamw.update

    def experts_seen(xf, r, w, ex, slots):
        seen.append((ex.stop - ex.start, slots.stop - slots.start,
                     list(w[0].shape)))
        return experts(xf, r, w, ex, slots)

    def update_seen(*args, **kw):
        counter = next(m for m in _get_current_dispatch_mode_stack()
                       if isinstance(m, LocalOpCounter))
        mark = len(counter.log)
        out = update(*args, **kw)
        updates.extend(counter.log[mark:])
        return out

    moe_mod._experts = experts_seen
    specs.adamw.update = update_seen
    out = {}
    # (mesh, moe_chunk values, sequence length)
    for shape, chunks, seq in (((2, 4), (0, 128), 64), ((4, 2), (256,), 64),
                               ((4, 2), (128,), 48)):
        mesh = Mesh(shape, ("data", "model"))
        with fake_group(8):
            dmesh = mesh.device_mesh("cpu")
            for name, over in json.loads(sys.argv[1]).items():
                cfg = get_config("mixtral-8x7b").reduced(**over)
                for c in chunks:
                    ccfg = dataclasses.replace(cfg, moe_chunk=c) if c else cfg
                    if seq == 48:
                        ccfg = dataclasses.replace(ccfg, q_chunk=16,
                                                   kv_chunk=16)
                    for kind in ("train", "prefill", "decode"):
                        seen.clear()
                        updates.clear()
                        cell = specs.build_cell(
                            "mixtral-8x7b", ShapeSpec(kind, seq, 8, kind),
                            mesh, ccfg, dmesh=dmesh)
                        with LocalOpCounter():
                            cell.fn(*cell.args)
                        out[f"{shape}/{name}/{c}/{kind}"] = {
                            "fallbacks": [repr(f) for f in cell.fn.fallbacks],
                            "buffers": sorted(set(map(repr, seen))),
                            "update": sorted(set(updates))}
                if shape != (2, 4):
                    continue
                # the expert weights' gradients, from one loss
                cell = specs.build_cell("mixtral-8x7b",
                                        ShapeSpec("g", 64, 8, "train"), mesh,
                                        cfg, dmesh=dmesh)
                model, batch = cell.args[0], cell.args[3]
                with implicit_replication():
                    loss, _ = lm_loss(model, batch, cfg)
                    loss.backward()
                out[f"{shape}/{name}/grads"] = {
                    n: [str(p.placements), str(p.grad.placements)]
                    for n, p in model.named_parameters() if ".moe.w" in n}
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def structure():
    res = subprocess.run(
        [sys.executable, "-c", _STRUCTURE, json.dumps(FAKE)], env=_env(),
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", list(FAKE))
@pytest.mark.parametrize("chunk", [0, 128])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_no_view_falls_back(structure, name, chunk, kind):
    assert structure[f"(2, 4)/{name}/{chunk}/{kind}"]["fallbacks"] == []


# (experts, slots, this rank's wi) of each block's products: top-2,
# capacity factor 1.25, at most the block (512 tokens: cap 512 for 2
# experts, 320 for 4; blocks of 128: 128 and 80); a block of 512 spans
# the 2 "data" ranks, which take half its slots each, a block of 128 lies
# on one; d_ff 512 over the 4 "model" ranks (tp) or one expert each (ep)
BUFFERS = {"tp/0": "(2, 256, [2, 256, 128])",
           "tp/128": "(2, 128, [2, 256, 128])",
           "ep/0": "(1, 160, [1, 256, 512])",
           "ep/128": "(1, 80, [1, 256, 512])"}


@pytest.mark.parametrize("name", list(FAKE))
@pytest.mark.parametrize("chunk", [0, 128])
def test_each_rank_builds_its_share_of_the_buffer(structure, name, chunk):
    got = structure[f"(2, 4)/{name}/{chunk}/train"]["buffers"]
    assert got == [BUFFERS[f"{name}/{chunk}"]], got


@pytest.mark.parametrize("name", list(FAKE))
def test_expert_gradients_land_on_the_parameters_placements(structure, name):
    grads = structure[f"(2, 4)/{name}/grads"]
    assert len(grads) == 3 * 2  # wi, wg, wo of 2 layers
    for n, (param, grad) in grads.items():
        assert grad == param, (n, param, grad)
    split = "Shard(dim=0)" if name == "ep" else "Shard(dim=2)"
    assert split in grads["blocks.0.moe.wi"][0]


@pytest.mark.parametrize("name", list(FAKE))
def test_the_update_gathers_no_weight(structure, name):
    """The update gathers nothing: only the small replicated weights'
    gradients and the gradient norm are summed across ranks."""
    got = structure[f"(2, 4)/{name}/0/train"]["update"]
    assert all(k == "all-reduce" and b <= 1024 for k, _, b in got), got


# blocks of 256 tokens over pairs of the 4 "data" ranks: cap 256 for 2
# experts, 160 for 4, half of it on each rank; 2 "model" ranks split
# both expert counts (expert-parallel)
PAIRS = {"tp": "(1, 128, [1, 256, 512])", "ep": "(2, 80, [2, 256, 512])"}


@pytest.mark.parametrize("name", list(FAKE))
@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_a_block_over_part_of_an_axis_is_gathered_there(structure, name,
                                                        kind):
    rec = structure[f"(4, 2)/{name}/256/{kind}"]
    assert rec["fallbacks"] == []
    assert rec["buffers"] == [PAIRS[name]], rec["buffers"]


@pytest.mark.parametrize("name", list(FAKE))
def test_a_block_that_lines_up_with_no_split_is_recorded(structure, name):
    for kind in ("train", "prefill"):
        fell = structure[f"(4, 2)/{name}/128/{kind}"]["fallbacks"]
        assert fell and all("moe.ExpertSplit" in f for f in fell), fell


# ------------------------------------------------ numerics, 4-rank gloo --
_RANK = textwrap.dedent("""
    import dataclasses, json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)
    from repro_torch.configs import get_config
    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.core.guard import guard_init
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.specs import (GUARD_CFG, build_cell,
                                          make_train_step)
    from repro_torch.models import (init_cache, init_lm_params, lm_decode_step,
                                    lm_prefill, moe as moe_mod)
    from repro_torch.optim import adamw

    torch.set_num_threads(1)
    rank, world, port, path = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4])
    configs, opt_over = json.loads(sys.argv[5]), json.loads(sys.argv[6])
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    mesh = Mesh((2, 2), ("data", "model"))

    def full(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    def close(a, b, what, rtol=1e-4, atol=1e-5):
        torch.testing.assert_close(full(a), b, rtol=rtol, atol=atol,
                                   msg=lambda m: f"{what}: {m}")

    def call(cell, *args):
        out = cell.fn(*(args or cell.args))
        assert cell.fn.fallbacks == [], cell.fn.fallbacks
        return out

    routes = []
    route, route_logits = moe_mod._route, moe_mod._route_logits

    def logged(fn):
        def run(*args):
            r = fn(*args)
            routes.append((r.choice.clone(), r.keep.clone()))
            return r
        return run

    moe_mod._route_logits = logged(route_logits)

    def layer(cfg, mesh):
        # one MoE layer: its DTensor form against the unsharded one
        cell = build_cell("mixtral-8x7b", ShapeSpec("p", 64, 8, "prefill"),
                          mesh, cfg, device="cpu", seed=8)
        p = cell.args[0].blocks[0].moe
        gen = torch.Generator().manual_seed(9)
        x = torch.randn((8, 64, cfg.d_model), generator=gen)
        w = torch.randn((8, 64, cfg.d_model), generator=gen)
        ref = init_lm_params(8, cfg, device="cpu").blocks[0].moe
        routes.clear()
        moe_mod._route_logits = route_logits
        moe_mod._route = logged(route)
        y0, a0 = moe_mod.moe(ref, x, cfg)
        moe_mod._route = route
        moe_mod._route_logits = logged(route_logits)
        plain = list(routes)
        (y0 * w).sum().add(a0["load_balance"] + a0["router_z"]).backward()
        routes.clear()
        xd = distribute_tensor(x, cell.args[0].embed.table.device_mesh,
                               [Shard(0), Replicate()], src_data_rank=None)
        wd = distribute_tensor(w, xd.device_mesh, xd.placements,
                               src_data_rank=None)
        y1, a1 = moe_mod.moe(p, xd, cfg)
        (y1 * wd).sum().add(a1["load_balance"] + a1["router_z"]).backward()
        # a "data" rank routes the blocks its rows lie in
        n, block = len(routes), 8 * 64 // len(plain)
        sizes = dict(mesh.shape)
        rows = 8 * 64 // sizes["data"]
        first = rank // sizes["model"] * rows // block
        assert n == max(rows // block, 1), (n, rows, block)
        plain = plain[first:first + n]
        for (c1, k1), (c0, k0) in zip(routes, plain):
            assert torch.equal(c1, c0) and torch.equal(k1, k0)
        assert y1.placements == xd.placements, y1.placements
        close(y1, y0, "moe output")
        assert full(a1["dropped_frac"]).item() == a0["dropped_frac"].item()
        for k in ("load_balance", "router_z"):
            close(a1[k], a0[k], k, atol=0.0)
        for n, q in ref.named_parameters():
            g = p.get_parameter(n).grad
            assert g.placements == p.get_parameter(n).placements, (n, g)
            close(g, q.grad, "grad " + n, rtol=1e-3, atol=1e-5)

    def run(cfg, saved):
        layer(cfg, mesh)
        opt = adamw.AdamWConfig(**opt_over)
        cell = build_cell("mixtral-8x7b", ShapeSpec("t", 64, 8, "train"), mesh,
                          cfg, opt_cfg=opt, device="cpu", seed=3)
        batch = {n: full(v).clone() for n, v in cell.args[3].items()}
        ref = init_lm_params(3, cfg, device="cpu")
        rout = make_train_step(cfg, opt)(
            ref, adamw.init(dict(ref.named_parameters())),
            guard_init(GUARD_CFG, "cpu"), batch)
        out = call(cell)
        for k in ("loss", "grad_norm", "lr", "skipped", "ce", "aux"):
            close(out[3][k], rout[3][k], k, atol=0.0)
            saved["metric_" + k] = full(out[3][k]).numpy()
        for (n, p), q in zip(out[0].named_parameters(), ref.parameters()):
            close(p.detach(), q.detach(), n, rtol=1e-3, atol=1e-6)
            saved["param_" + n] = full(p.detach()).numpy()
        saved["tokens"] = batch["tokens"].numpy()
        cell = build_cell("mixtral-8x7b", ShapeSpec("p", 64, 8, "prefill"),
                          mesh, cfg, device="cpu", seed=5)
        tokens = full(cell.args[1]).clone()
        logits = call(cell)
        close(logits, lm_prefill(init_lm_params(5, cfg, device="cpu"),
                                 tokens, cfg), "prefill")
        saved["prefill_tokens"] = tokens.numpy()
        saved["prefill_logits"] = full(logits).numpy()
        cell = build_cell("mixtral-8x7b", ShapeSpec("d", 64, 8, "decode"),
                          mesh, cfg, device="cpu", seed=4)
        token = full(cell.args[1]).clone()
        rlog, _ = lm_decode_step(
            init_lm_params(4, cfg, device="cpu"), token, 0,
            init_cache(cfg, 8, 64, dtype=torch.float32, device="cpu"), cfg)
        logits, _ = call(cell)
        close(logits, rlog.detach(), "decode logits")
        saved["decode_token"] = token.numpy()
        saved["decode_logits"] = full(logits).numpy()

    try:
        saved = {}
        for name, over in configs.items():
            part = {}
            run(get_config("mixtral-8x7b").reduced(**over), part)
            saved.update({f"{name}/{k}": v for k, v in part.items()})
        # blocks of 256 tokens over pairs of the 4 "data" ranks
        for e in (3, 4):
            layer(get_config("mixtral-8x7b").reduced(**dict(
                configs["tp"], n_experts=e, moe_chunk=256)),
                Mesh((4, 1), ("data", "model")))
        if rank == 0:
            np.savez(path, **saved)
    finally:
        dist.destroy_process_group()
    print("MOE_OK", rank)
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def gloo_moe(tmp_path_factory):
    """Rank 0's results of `_RANK` (every rank checked itself against
    the unsharded port functions)."""
    path = tmp_path_factory.mktemp("moe") / "rank0.npz"
    world, port = 4, str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), str(world), port, str(path),
         json.dumps({n: dict(c, **F32) for n, c in GLOO.items()}),
         json.dumps(OPT)],
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
        assert f"MOE_OK {r}" in out
    saved = dict(np.load(path))
    return {name: {k.split("/", 1)[1]: v for k, v in saved.items()
                   if k.startswith(name + "/")} for name in GLOO}


def _configs(name):
    return (jget(ARCH).reduced(**GLOO[name], **F32),
            get_config(ARCH).reduced(**GLOO[name], **F32))


def _jax_params(seed, tc):
    tree = lm_params_to_numpy(init_lm_params(seed, tc, device="cpu"))
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("name", list(GLOO))
def test_train_cell_equals_the_jax_step(gloo_moe, name):
    got = gloo_moe[name]
    jc, tc = _configs(name)
    jp = _jax_params(3, tc)
    jp, _, _, jm = jax.jit(jmake_train_step(jc, jadamw.AdamWConfig(**OPT)))(
        jp, jadamw.init(jp), jguard_init(JGUARD_CFG),
        {"tokens": jnp.asarray(got["tokens"])})
    for k in ("loss", "grad_norm", "lr", "skipped", "ce", "aux"):
        np.testing.assert_allclose(got["metric_" + k], float(jm[k]),
                                   rtol=1e-4, err_msg=k)
    model = init_lm_params(3, tc, device="cpu")
    import torch
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


@pytest.mark.parametrize("name", list(GLOO))
def test_prefill_cell_equals_the_jax_prefill(gloo_moe, name):
    got = gloo_moe[name]
    jc, tc = _configs(name)
    logits = jax.jit(lambda p, t: jprefill(p, t, jc))(
        _jax_params(5, tc), jnp.asarray(got["prefill_tokens"]))
    np.testing.assert_allclose(got["prefill_logits"],
                               np.asarray(logits), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", list(GLOO))
def test_decode_cell_equals_the_jax_step(gloo_moe, name):
    got = gloo_moe[name]
    jc, tc = _configs(name)
    logits, _ = jax.jit(lambda p, t, c: jdecode(p, t, 0, c, jc))(
        _jax_params(4, tc), jnp.asarray(got["decode_token"]),
        jinit_cache(jc, 8, 64, dtype=jnp.float32))
    np.testing.assert_allclose(got["decode_logits"],
                               np.asarray(logits), rtol=1e-4, atol=1e-5)
