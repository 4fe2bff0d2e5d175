"""The port's (arch x shape x mesh) cells against the JAX package's, on
the CPU.

- `pick_accum_steps` equals the reference's over a grid of meshes,
  batches, lengths and widths.
- Every (arch, shape) of `all_cells()` at its published width on the
  16 x 16 mesh: the cell's global argument shapes and dtypes, and its
  `token_count`, equal the reference's (`jax.eval_shape` cells on an
  `AbstractMesh`).  The port's cells are built on the meta device over a
  fake 256-rank process group in a child interpreter (the default group
  is global to a process); its per-layer parameters and caches are
  compared with the reference's stacked leaves, stacked back.
- A 4-rank gloo group (one child process per rank) on a (2, 2) mesh,
  llama3.2-1b `reduced()` in float32 compute with float32 caches: the
  train cell's loss, grad norm and updated parameters, the decode
  cell's logits and caches and the prefill cell's logits equal the
  unsharded port step in every rank, and rank 0's train and decode
  results the JAX package's steps on the same weights and tokens:
  metrics rtol 1e-4, parameters rtol 1e-3 / atol 1e-6, as
  `tests/test_torch_train.py` holds them (the sharded reductions add
  in another order, and AdamW's first step divides a gradient by its
  own magnitude, so a near-zero gradient's update moves by up to lr);
  logits and caches rtol 1e-4 / atol 1e-5.
"""
import itertools
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

from repro.configs.registry import ShapeSpec as JShapeSpec
from repro.configs.registry import get_config as jget
from repro.launch.specs import GUARD_CFG as JGUARD_CFG
from repro.launch.specs import build_cell as jbuild_cell
from repro.launch.specs import make_train_step as jmake_train_step
from repro.launch.specs import pick_accum_steps as jpick
from repro.core.guard import guard_init as jguard_init
from repro.models import init_cache as jinit_cache
from repro.models import lm_decode_step as jdecode
from repro.optim import adamw as jadamw
from repro.sharding.rules import abstract_mesh
from repro_torch.configs import get_config
from repro_torch.configs.registry import all_cells
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.specs import pick_accum_steps
from repro_torch.models import init_lm_params, lm_params_to_numpy

ROOT = Path(__file__).resolve().parents[1]
# the full lr at the first step; eps 1e-3 keeps that step's update linear
# in a near-zero gradient (at eps 1e-8 it is +-lr for any gradient far
# above 1e-8, and a reduction-order difference in a gradient near 1e-8
# moves it by up to lr)
OPT = dict(warmup_steps=1, total_steps=10, eps=1e-3)


def _env():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    return env


def test_pick_accum_steps_is_the_references():
    meshes = [((16, 16), ("data", "model")),
              ((2, 16, 16), ("pod", "data", "model")),
              ((4, 2), ("data", "model")), ((1, 1), ("data", "model"))]
    for (sizes, names), b, s, d in itertools.product(
            meshes, (1, 8, 32, 96, 128, 256), (64, 4096, 32768),
            (128, 2048, 8192)):
        assert pick_accum_steps(Mesh(sizes, names), b, s, d) == \
            jpick(abstract_mesh(sizes, names), b, s, d), (sizes, b, s, d)


# ------------------------------------------------- argument shapes --
_PORT_CELLS = textwrap.dedent("""
    import json
    import torch
    from repro_torch.configs.registry import all_cells
    from repro_torch.launch.mesh import fake_group, make_production_mesh
    from repro_torch.launch.specs import build_cell
    from repro_torch.models.transformer import block_layout
    from repro_torch.optim.adamw import OptState
    from repro_torch.sharding.rules import param_path
    from repro_torch.tree import tree_paths

    def dtype(t):
        return str(t.dtype).replace("torch.", "")

    def add(out, key, shape, dt):
        prev = out.setdefault("/".join(key), [list(shape), dt])
        assert prev == [list(shape), dt], (key, prev, shape, dt)

    def stacked(out, prefix, model, named):
        for n, t in named:
            path, stack = param_path(model, n)
            shape = ((stack,) if stack else ()) + tuple(t.shape)
            add(out, prefix + tuple(path.split("/")), shape, dtype(t))

    def leaves(cell, cfg):
        out, model = {}, cell.args[0]
        for i, a in enumerate(cell.args):
            pre = (str(i),)
            if isinstance(a, torch.nn.Module):
                stacked(out, pre, model, a.named_parameters())
            elif isinstance(a, OptState):
                for f in ("m", "v"):
                    stacked(out, pre + (f,), model, getattr(a, f).items())
                add(out, pre + ("count",), a.count.shape, dtype(a.count))
            elif isinstance(a, list):  # per-layer decode caches
                per = len(block_layout(cfg)[0])
                for layer, c in enumerate(a):
                    for f, t in zip(c._fields, c):
                        add(out, pre + (f"cache_{layer % per}", f),
                            (len(a) // per,) + tuple(t.shape), dtype(t))
            elif isinstance(a, dict) and "self" in a:  # enc-dec caches
                for k, layers in a.items():
                    for c in layers:
                        for f, t in zip(c._fields, c):
                            add(out, pre + (k, f),
                                (len(layers),) + tuple(t.shape), dtype(t))
            else:
                for path, t in tree_paths(a):
                    add(out, pre + path, t.shape, dtype(t))
        return out

    mesh = make_production_mesh()
    res = {}
    with fake_group(mesh.size):
        dmesh = mesh.device_mesh("cpu")
        for arch, sp, skip in all_cells():
            if skip:
                continue
            cell = build_cell(arch, sp, mesh, dmesh=dmesh)
            res[f"{arch}/{sp.name}"] = {
                "token_count": cell.token_count,
                "leaves": leaves(cell, cell.args[0].cfg)}
    print(json.dumps(res))
""")


def _key(entry):
    if hasattr(entry, "key"):
        return str(entry.key)
    if hasattr(entry, "name"):
        return str(entry.name)
    return str(entry.idx)


def _reference_leaves(cell):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(cell.args)[0]:
        out["/".join(_key(e) for e in path)] = [list(leaf.shape),
                                                str(leaf.dtype)]
    return out


def test_cell_arguments_and_tokens_equal_the_references():
    proc = subprocess.Popen([sys.executable, "-c", _PORT_CELLS],
                            env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    mesh = abstract_mesh((16, 16), ("data", "model"))
    want = {}
    for arch, sp, skip in all_cells():
        if skip:
            continue
        cell = jbuild_cell(arch, JShapeSpec(*sp), mesh)
        want[f"{arch}/{sp.name}"] = {"token_count": cell.token_count,
                                     "leaves": _reference_leaves(cell)}
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    got = json.loads(out.strip().splitlines()[-1])
    assert len(got) == len(want) == 35
    for name in want:
        assert got[name]["token_count"] == want[name]["token_count"], name
        assert got[name]["leaves"] == want[name]["leaves"], name


# ------------------------------------------------ 4-rank gloo mesh --
_RANK = textwrap.dedent("""
    import json
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import get_config
    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.core.guard import guard_init
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.specs import (GUARD_CFG, build_cell,
                                          make_train_step)
    from repro_torch.models import (init_cache, init_lm_params,
                                    lm_cache_to_numpy, lm_decode_step,
                                    lm_prefill)
    from repro_torch.optim import adamw

    torch.set_num_threads(1)
    rank, world, port, path = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4])
    OPT = json.loads(sys.argv[5])
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)

    def full(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    def close(a, b, what, rtol=1e-4, atol=1e-5):
        torch.testing.assert_close(full(a), b, rtol=rtol, atol=atol,
                                   msg=lambda m: f"{what}: {m}")

    try:
        mesh = Mesh((2, 2), ("data", "model"))
        cfg = get_config("llama3.2-1b").reduced(compute_dtype="float32",
                                                kv_dtype="float32")
        opt = adamw.AdamWConfig(**OPT)
        saved = {}
        # train: 8 x 32 tokens, fresh optimizer and guard
        cell = build_cell("llama3_2_1b", ShapeSpec("t", 32, 8, "train"),
                          mesh, cfg, opt_cfg=opt, device="cpu", seed=3)
        batch = {n: full(v).clone() for n, v in cell.args[3].items()}
        ref = init_lm_params(3, cfg, device="cpu")
        rout = make_train_step(cfg, opt)(
            ref, adamw.init(dict(ref.named_parameters())),
            guard_init(GUARD_CFG, "cpu"), batch)
        out = cell.fn(*cell.args)
        for k in ("loss", "grad_norm", "lr", "skipped", "ce"):
            close(out[3][k], rout[3][k], k, atol=0.0)
            saved["metric_" + k] = full(out[3][k]).numpy()
        for (n, p), q in zip(out[0].named_parameters(), ref.parameters()):
            close(p.detach(), q.detach(), n, rtol=1e-3, atol=1e-6)
            saved["param_" + n] = full(p.detach()).numpy()
        saved["tokens"] = batch["tokens"].numpy()
        # decode: batch 8 at position 0 over 64 zeroed slots
        cell = build_cell("llama3_2_1b", ShapeSpec("d", 64, 8, "decode"),
                          mesh, cfg, device="cpu", seed=4)
        token = full(cell.args[1]).clone()
        ref = init_lm_params(4, cfg, device="cpu")
        rlog, rcache = lm_decode_step(
            ref, token, 0, init_cache(cfg, 8, 64, dtype=torch.float32,
                                      device="cpu"), cfg)
        logits, caches = cell.fn(*cell.args)
        close(logits, rlog.detach(), "decode logits")
        for i, (c, rc) in enumerate(zip(caches, rcache)):
            for f, a, b in zip(c._fields, c, rc):
                close(a, b, f"cache {i} {f}")
        saved["decode_token"] = token.numpy()
        saved["decode_logits"] = full(logits).numpy()
        for j, c in lm_cache_to_numpy([type(c)(*map(full, c))
                                       for c in caches], cfg).items():
            saved[f"decode_{j}_k"], saved[f"decode_{j}_v"] = c.k, c.v
        # prefill: 8 x 32 prompts, the last position's logits
        cell = build_cell("llama3_2_1b", ShapeSpec("p", 32, 8, "prefill"),
                          mesh, cfg, device="cpu", seed=5)
        ref = init_lm_params(5, cfg, device="cpu")
        close(cell.fn(*cell.args),
              lm_prefill(ref, full(cell.args[1]).clone(), cfg), "prefill")
        if rank == 0:
            np.savez(path, **saved)
    finally:
        dist.destroy_process_group()
    print("CELLS_OK", rank)
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def gloo_cells(tmp_path_factory):
    """Rank 0's results of `_RANK` (every rank checked itself against
    the unsharded port step)."""
    path = tmp_path_factory.mktemp("cells") / "rank0.npz"
    world, port = 4, str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), str(world), port, str(path),
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
        assert f"CELLS_OK {r}" in out
    return dict(np.load(path))


def _jax_params(seed, jc, tc):
    tree = lm_params_to_numpy(init_lm_params(seed, tc, device="cpu"))
    return jax.tree_util.tree_map(jnp.asarray, tree)


def test_sharded_train_cell_equals_the_jax_step(gloo_cells):
    over = dict(compute_dtype="float32", kv_dtype="float32")
    jc = jget("llama3.2-1b").reduced(**over)
    tc = get_config("llama3.2-1b").reduced(**over)
    jp = _jax_params(3, jc, tc)
    opt = jadamw.AdamWConfig(**OPT)
    jp, _, _, jm = jax.jit(jmake_train_step(jc, opt))(
        jp, jadamw.init(jp), jguard_init(JGUARD_CFG),
        {"tokens": jnp.asarray(gloo_cells["tokens"])})
    for k in ("loss", "grad_norm", "lr", "skipped", "ce"):
        np.testing.assert_allclose(gloo_cells["metric_" + k], float(jm[k]),
                                   rtol=1e-4, err_msg=k)
    model = init_lm_params(3, tc, device="cpu")
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(torch.from_numpy(gloo_cells["param_" + n]))
    got = lm_params_to_numpy(model)
    for (path, a), b in zip(
            jax.tree_util.tree_flatten_with_path(
                jax.tree_util.tree_map(np.asarray, jp))[0],
            jax.tree_util.tree_leaves(got)):
        np.testing.assert_allclose(b, a, rtol=1e-3, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))


def test_sharded_decode_cell_equals_the_jax_step(gloo_cells):
    over = dict(compute_dtype="float32", kv_dtype="float32")
    jc = jget("llama3.2-1b").reduced(**over)
    tc = get_config("llama3.2-1b").reduced(**over)
    jp = _jax_params(4, jc, tc)
    logits, caches = jax.jit(lambda p, t, c: jdecode(p, t, 0, c, jc))(
        jp, jnp.asarray(gloo_cells["decode_token"]),
        jinit_cache(jc, 8, 64, dtype=jnp.float32))
    np.testing.assert_allclose(gloo_cells["decode_logits"],
                               np.asarray(logits), rtol=1e-4, atol=1e-5)
    for j, c in caches.items():
        for f in ("k", "v"):
            np.testing.assert_allclose(gloo_cells[f"decode_{j}_{f}"],
                                       np.asarray(getattr(c, f)),
                                       rtol=1e-4, atol=1e-5,
                                       err_msg=f"{j}.{f}")


def test_cells_cover_every_shape_kind():
    kinds = {sp.kind for _, sp, skip in all_cells() if not skip}
    assert kinds == {"train", "prefill", "decode"}
