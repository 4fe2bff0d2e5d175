"""Attention's heads and the read-out split over "model", on the CPU.

Three configs, `reduced()` widened so that their projections are split
by the rules (d 512, KV heads 2 x 64, d_ff 1024, vocab 512):

- "heads": 8 query heads.  Like llama3.2-1b on the 16 x 16 mesh (8 KV
  heads), it has fewer KV heads than the "model" axis has ranks (4),
  and the K and V projections (512 x 128) split into half heads: the
  query heads split over "model" (`sharding/hints.py::HeadSplit`).
- "rows": 6 query heads, which do not split over 4 ranks (as
  starcoder2's 24, qwen2's 28 or gemma2's 8 over 16): the query rows
  split instead, two blocks of S / 8 per rank (`RowSplit`).
- "moe": mixtral-8x7b's, 8 query heads as "heads", and its 4 experts
  split over "model" (expert-parallel by the rules): the MoE's tokens
  stay batch split on the local shards (`rows_reshape`), its output
  back on its input's layout (`placed_as`).

- Structure, on a fake 8-rank group, mesh (2, 4), meta tensors: a
  view DTensor refuses (2 heads from a dim split 4 ways) is retried by
  `ViewResharding` with the dim replicated and recorded in the cell
  function's `fallbacks`; the train (chunked CE, remat), prefill and
  decode cells need no such retry; the chunked attention runs on plain local
  tensors holding h / 4 = 2 query heads over all 64 rows and the one KV
  head they read ("heads", "moe"), or all 6 heads over 64 / 8 rows
  ("rows");
  the CE runs on vocab-split logits; the prefill and decode logits come
  out split over the vocab; the decode cache is read on its own split
  (head_dim over "model").
- Numerics, on a 4-rank gloo group (one child process per rank), mesh
  (1, 4), float32 compute and caches: the train cell's metrics and
  updated parameters, the prefill cell's logits and the decode cell's
  logits and caches equal the unsharded port functions in every rank,
  and rank 0's the JAX package's functions on the same weights and
  tokens, at `tests/test_torch_cells.py`'s tolerances (metrics rtol
  1e-4, parameters rtol 1e-3 / atol 1e-6, logits and caches rtol 1e-4
  / atol 1e-5).  Also in every rank, on a (2, 2) mesh: a batch-1 decode
  over filled caches whose sequence the rules split over "data" (the
  long_500k layout), at position 37, against the unsharded step.
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

ROOT = Path(__file__).resolve().parents[1]
WIDE = dict(d_model=512, n_heads=8, n_kv=2, head_dim=64, d_ff=1024,
            ce_chunk=16, remat=True)
CONFIGS = {"heads": ("llama3.2-1b", WIDE),
           "rows": ("llama3.2-1b", dict(WIDE, n_heads=6)),
           "moe": ("mixtral-8x7b", WIDE)}
F32 = dict(compute_dtype="float32", kv_dtype="float32")
OPT = dict(warmup_steps=1, total_steps=10, eps=1e-3)  # as test_torch_cells


def _env():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    return env


# ----------------------------------------------- structure, fake group --
_STRUCTURE = textwrap.dedent("""
    import json, sys
    import torch
    from torch.distributed.tensor import Shard, distribute_tensor
    from repro_torch.configs import get_config
    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.launch.mesh import Mesh, fake_group
    from repro_torch.launch.specs import build_cell, on_dtensors
    from repro_torch.models import attention, transformer

    seen = []
    flash, ce = attention.flash_attention, transformer.vocab_parallel_ce

    def flash_seen(q, k, v, **kw):
        seen.append(("flash", type(q).__name__, q.shape[1],
                     q.shape[2] * q.shape[3], k.shape[2]))
        return flash(q, k, v, **kw)

    def ce_seen(logits, tgt):
        seen.append(("ce", str(logits.placements)))
        return ce(logits, tgt)

    attention.flash_attention = flash_seen
    transformer.vocab_parallel_ce = ce_seen
    def record(arch, cfg, kind, dmesh):
        seen.clear()
        cell = build_cell(arch, ShapeSpec(kind, 64, 8, kind), mesh, cfg,
                          dmesh=dmesh)
        res = cell.fn(*cell.args)
        rec = {"fallbacks": [repr(f) for f in cell.fn.fallbacks],
               "seen": sorted(set(map(repr, seen)))}
        if kind == "prefill":
            rec["logits"] = str(res.placements)
        if kind == "decode":
            rec["logits"] = str(res[0].placements)
            k = cell.args[3][0].k
            rec["cache"] = [str(k.placements), list(k.to_local().shape)]
        return rec

    mesh = Mesh((2, 4), ("data", "model"))
    out = {}
    with fake_group(8):
        dmesh = mesh.device_mesh("cpu")
        # a view the shards cannot follow: 2 heads of a dim split 4 ways
        x = distribute_tensor(torch.empty(4, 8, 128, device="meta"), dmesh,
                              [Shard(0), Shard(2)])
        view = on_dtensors(lambda t: t.view(4, 8, 2, 64))
        y = view(x)
        out["refused"] = {"shape": list(y.shape), "placements":
                          str(y.placements), "fallbacks": view.fallbacks,
                          "x": [str(p) for p in x.placements]}
        for name, (arch, over) in json.loads(sys.argv[1]).items():
            cfg = get_config(arch).reduced(**over)
            for kind in ("train", "prefill", "decode"):
                out[f"{name}/{kind}"] = record(arch, cfg, kind, dmesh)
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def structure():
    res = subprocess.run(
        [sys.executable, "-c", _STRUCTURE, json.dumps(CONFIGS)], env=_env(),
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_no_view_is_resharded(structure, name, kind):
    assert structure[f"{name}/{kind}"]["fallbacks"] == []


def test_a_refused_view_is_resharded_and_recorded(structure):
    rec = structure["refused"]
    assert rec["shape"] == [4, 8, 2, 64]
    assert rec["placements"] == "(Shard(dim=0), Replicate())"
    assert rec["fallbacks"] == [["aten.view.default", [4, 8, 128],
                                 rec["x"], [2]]]


# plain tensors: (query rows, query heads, KV heads) of each flash call
LOCAL = {"heads": "('flash', 'Tensor', 64, 2, 1)",  # h / 4, all rows
         "rows": "('flash', 'Tensor', 8, 6, 2)",  # every head, S / 8 rows
         "moe": "('flash', 'Tensor', 64, 2, 1)"}


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_attention_runs_on_local_shares(structure, name, kind):
    flash = [s for s in structure[f"{name}/{kind}"]["seen"]
             if "'flash'" in s]
    assert flash == [LOCAL[name]], flash


@pytest.mark.parametrize("name", list(CONFIGS))
def test_logits_stay_vocab_split(structure, name):
    ce = [s for s in structure[f"{name}/train"]["seen"] if "'ce'" in s]
    assert ce == ["('ce', '(Shard(dim=0), Shard(dim=2))')"], ce
    for kind in ("prefill", "decode"):
        assert structure[f"{name}/{kind}"]["logits"] == \
            "(Shard(dim=0), Shard(dim=1))"


@pytest.mark.parametrize("name", list(CONFIGS))
def test_decode_reads_the_cache_on_its_split(structure, name):
    place, local = structure[f"{name}/decode"]["cache"]
    assert place == "(Shard(dim=0), Shard(dim=3))"
    assert local == [4, 64, 2, 16]


# ------------------------------------------------ numerics, 4-rank gloo --
_RANK = textwrap.dedent("""
    import json
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, distribute_tensor
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
    configs, opt_over = json.loads(sys.argv[5]), json.loads(sys.argv[6])
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

    def run(arch, cfg, saved):
        mesh = Mesh((1, 4), ("data", "model"))
        opt = adamw.AdamWConfig(**opt_over)
        cell = build_cell(arch, ShapeSpec("t", 64, 8, "train"), mesh, cfg,
                          opt_cfg=opt, device="cpu", seed=3)
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
        cell = build_cell(arch, ShapeSpec("p", 64, 8, "prefill"), mesh,
                          cfg, device="cpu", seed=5)
        tokens = full(cell.args[1]).clone()
        logits = call(cell)
        ref = init_lm_params(5, cfg, device="cpu")
        close(logits, lm_prefill(ref, tokens, cfg), "prefill")
        saved["prefill_tokens"] = tokens.numpy()
        saved["prefill_logits"] = full(logits).numpy()
        cell = build_cell(arch, ShapeSpec("d", 64, 8, "decode"), mesh,
                          cfg, device="cpu", seed=4)
        token = full(cell.args[1]).clone()
        ref = init_lm_params(4, cfg, device="cpu")
        rlog, rcache = lm_decode_step(
            ref, token, 0, init_cache(cfg, 8, 64, dtype=torch.float32,
                                      device="cpu"), cfg)
        logits, caches = call(cell)
        close(logits, rlog.detach(), "decode logits")
        for i, (c, rc) in enumerate(zip(caches, rcache)):
            for f, a, b in zip(c._fields, c, rc):
                close(a, b, f"cache {i} {f}")
        saved["decode_token"] = token.numpy()
        saved["decode_logits"] = full(logits).numpy()
        for j, c in lm_cache_to_numpy([type(c)(*map(full, c))
                                       for c in caches], cfg).items():
            saved[f"decode_{j}_k"], saved[f"decode_{j}_v"] = c.k, c.v
        # batch 1 on a (2, 2) mesh: the cache's sequence split over
        # "data", filled, read at position 37
        mesh = Mesh((2, 2), ("data", "model"))
        cell = build_cell(arch, ShapeSpec("d1", 64, 1, "decode"), mesh, cfg,
                          device="cpu", seed=6)
        gen = torch.Generator().manual_seed(7)
        whole = [type(c)(*(torch.randn(t.shape, generator=gen) for t in c))
                 for c in cell.args[3]]
        placed = [type(c)(*(distribute_tensor(w.clone(), t.device_mesh,
                                              t.placements,
                                              src_data_rank=None)
                            for w, t in zip(cw, c)))
                  for cw, c in zip(whole, cell.args[3])]
        token = full(cell.args[1]).clone()
        logits, caches = call(cell, cell.args[0], token, 37, placed)
        rlog, rcache = lm_decode_step(init_lm_params(6, cfg, device="cpu"),
                                      token, 37, whole, cfg)
        close(logits, rlog.detach(), "long decode logits")
        for i, (c, rc) in enumerate(zip(caches, rcache)):
            assert any(p.is_shard(1) for p in c.k.placements), c.k.placements
            for f, a, b in zip(c._fields, c, rc):
                close(a, b, f"long cache {i} {f}")

    try:
        saved = {}
        for name, (arch, over) in configs.items():
            part = {}
            run(arch, get_config(arch).reduced(**over), part)
            saved.update({f"{name}/{k}": v for k, v in part.items()})
        if rank == 0:
            np.savez(path, **saved)
    finally:
        dist.destroy_process_group()
    print("HEADS_OK", rank)
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def gloo_heads(tmp_path_factory):
    """Rank 0's results of `_RANK` (every rank checked itself against
    the unsharded port functions)."""
    path = tmp_path_factory.mktemp("heads") / "rank0.npz"
    world, port = 4, str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), str(world), port, str(path),
         json.dumps({n: (a, dict(c, **F32))
                     for n, (a, c) in CONFIGS.items()}),
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
        assert f"HEADS_OK {r}" in out
    saved = dict(np.load(path))
    return {name: {k.split("/", 1)[1]: v for k, v in saved.items()
                   if k.startswith(name + "/")} for name in CONFIGS}


def _configs(name):
    arch, over = CONFIGS[name]
    return (jget(arch).reduced(**over, **F32),
            get_config(arch).reduced(**over, **F32))


def _jax_params(seed, tc):
    tree = lm_params_to_numpy(init_lm_params(seed, tc, device="cpu"))
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_train_cell_equals_the_jax_step(gloo_heads, name):
    got = gloo_heads[name]
    jc, tc = _configs(name)
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


@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_cell_equals_the_jax_prefill(gloo_heads, name):
    got = gloo_heads[name]
    jc, tc = _configs(name)
    logits = jax.jit(lambda p, t: jprefill(p, t, jc))(
        _jax_params(5, tc), jnp.asarray(got["prefill_tokens"]))
    np.testing.assert_allclose(got["prefill_logits"],
                               np.asarray(logits), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_decode_cell_equals_the_jax_step(gloo_heads, name):
    got = gloo_heads[name]
    jc, tc = _configs(name)
    logits, caches = jax.jit(lambda p, t, c: jdecode(p, t, 0, c, jc))(
        _jax_params(4, tc), jnp.asarray(got["decode_token"]),
        jinit_cache(jc, 8, 64, dtype=jnp.float32))
    np.testing.assert_allclose(got["decode_logits"],
                               np.asarray(logits), rtol=1e-4, atol=1e-5)
    for j, c in caches.items():
        for f in ("k", "v"):
            np.testing.assert_allclose(got[f"decode_{j}_{f}"],
                                       np.asarray(getattr(c, f)),
                                       rtol=1e-4, atol=1e-5,
                                       err_msg=f"{j}.{f}")
