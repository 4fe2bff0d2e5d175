"""The port's sharding rules against the JAX package's, on the CPU.

For all ten configs at their published widths (the port's models built
on the meta device, the reference's trees by `jax.eval_shape`), on both
production meshes (the reference's `AbstractMesh`, no devices) and under
every combination of `RULE_FLAGS`: each of the port's parameters gets
the reference's `param_spec` of its tree path and stacked shape with
the stack entry dropped, padded to the leaf's ndim; `batch_spec`,
`cache_spec` and `state_cache_shardings` equal the reference's for
every `SHAPES` entry.  Also the cases of `tests/test_substrate.py`'s
rule tests and `placements` on a fake process group (a child
interpreter: the default group is global to a process).
"""
import itertools
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.models import init_cache as jinit_cache
from repro.models import init_encdec_cache as jinit_encdec_cache
from repro.models import init_encdec_params as jinit_encdec_params
from repro.models import init_lm_params as jinit_lm_params
from repro.sharding import rules as jrules
from repro_torch.configs.registry import ARCHS, SHAPES, get_config
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import (EncDec, LM, init_cache, init_encdec_cache)
from repro_torch.sharding import rules
from repro_torch.tree import tree_paths

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
FLAG_SETS = [dict(zip(rules.RULE_FLAGS, bits))
             for bits in itertools.product((False, True),
                                           repeat=len(rules.RULE_FLAGS))]


def _meshes(kind):
    sizes, names = MESHES[kind]
    return Mesh(sizes, names), jrules.abstract_mesh(sizes, names)


def _ref(spec, ndim):
    """A reference PartitionSpec as the port's tuple of `ndim` entries."""
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


def _drop(spec, ndim, stacked):
    full = _ref(spec, ndim + (1 if stacked else 0))
    return full[1:] if stacked else full


def _jax_params(cfg):
    init = jinit_encdec_params if cfg.family == "encdec" else jinit_lm_params
    return jax.eval_shape(lambda k: init(k, cfg), jax.random.PRNGKey(0))


def _port_model(cfg):
    return (EncDec if cfg.family == "encdec" else LM)(cfg, device="meta")


@pytest.fixture
def flags(monkeypatch):
    """Sets a flag combination on both packages' RULE_FLAGS (restored
    after the test)."""
    def set_flags(combo):
        for k, v in combo.items():
            monkeypatch.setitem(rules.RULE_FLAGS, k, v)
            monkeypatch.setitem(jrules.RULE_FLAGS, k, v)
    return set_flags


def test_rule_flags_are_the_references():
    assert rules.RULE_FLAGS == jrules.RULE_FLAGS
    assert rules.REPLICATE_BELOW == jrules.REPLICATE_BELOW
    assert len(FLAG_SETS) == 8


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_references(arch, flags):
    cfg, jcfg = get_config(arch), jget_config(arch)
    model = _port_model(cfg)
    jtree = {"/".join(p): leaf for p, leaf in tree_paths(_jax_params(jcfg))}
    named = list(model.named_parameters())
    paths = {n: rules.param_path(model, n) for n, _ in named}
    # the mapping covers the reference's tree, stacked shapes included
    assert {path for path, _ in paths.values()} == set(jtree)
    for n, p in named:
        path, stack = paths[n]
        assert jtree[path].shape == ((stack,) if stack else ()) + p.shape, n
    for kind, combo in itertools.product(MESHES, FLAG_SETS):
        flags(combo)
        mesh, jmesh = _meshes(kind)
        got = rules.params_shardings(mesh, model)
        want = {path: jrules.param_spec(jmesh, path, leaf.shape)
                for path, leaf in jtree.items()}
        for n, p in named:
            path, stack = paths[n]
            assert got[n] == _drop(want[path], p.ndim, bool(stack)), \
                (n, kind, combo)


def _jax_caches(jcfg, b, s):
    if jcfg.family == "encdec":
        return jax.eval_shape(lambda: jinit_encdec_cache(jcfg, b, s, s))
    return jax.eval_shape(lambda: jinit_cache(jcfg, b, s))


def _port_caches(cfg, b, s):
    if cfg.family == "encdec":
        return init_encdec_cache(cfg, b, s, s, device="meta")
    return init_cache(cfg, b, s, device="meta")


def _cache_pairs(cfg, caches, jcaches):
    """(port leaf spec path, reference stacked leaf) pairs: layer g *
    per + j is `cache_<j>[g]`; the enc-dec's layer l is "self"[l]."""
    if cfg.family == "encdec":
        for k in ("self", "cross"):
            for layer in range(len(caches[k])):
                for f in range(2):
                    yield (k, layer, f), jcaches[k][f]
        return
    per = len(jcaches)
    for i in range(len(caches)):
        jc = jcaches[f"cache_{i % per}"]
        for f in range(len(jc)):
            yield (i, f), jc[f]


def _at(tree, where):
    for k in where:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_equal_the_references(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for sp in SHAPES:
        caches = _port_caches(cfg, sp.global_batch, sp.seq_len)
        jcaches = _jax_caches(jcfg, sp.global_batch, sp.seq_len)
        for kind in MESHES:
            mesh, jmesh = _meshes(kind)
            for bkind in ("train", "decode"):
                assert rules.batch_spec(mesh, sp.global_batch, bkind) == \
                    tuple(jrules.batch_spec(jmesh, sp.global_batch, bkind))
            got = rules.state_cache_shardings(mesh, caches)
            want = jax.tree_util.tree_map(
                lambda s: s.spec, jrules.state_cache_shardings(jmesh, jcaches))
            for where, jleaf in _cache_pairs(cfg, caches, jcaches):
                ndim = len(jleaf.shape) - 1
                wspec = _at(want, where[:1] if cfg.family == "encdec"
                            else (f"cache_{where[0] % len(jcaches)}",))
                wspec = wspec[where[-1]]
                assert _at(got, where) == _drop(wspec, ndim, True), \
                    (arch, sp.name, kind, where)
                # a per-layer KV cache takes the reference's rule directly
                leaf = _at(caches, where)
                if len(jleaf.shape) == 5:
                    assert rules.cache_spec(mesh, leaf.shape, 0, 1) == \
                        _drop(jrules.cache_spec(jmesh, jleaf.shape), ndim,
                              True)


def test_substrate_cases_hold():
    """`tests/test_substrate.py`'s rule cases, in the port's specs."""
    mesh = make_production_mesh()
    assert rules.param_spec(mesh, "blocks_0/mlp/wi/w",
                            (48, 8192, 22016)) == (None, "data", "model")
    assert rules.param_spec(mesh, "blocks_0/mlp/wo/w",
                            (48, 22016, 8192)) == (None, "model", "data")
    assert rules.param_spec(mesh, "embed/table", (128256, 4096)) == \
        ("model", "data")
    assert rules.param_spec(mesh, "blocks_0/moe/wi",
                            (48, 16, 6144, 10752)) == \
        (None, "model", None, "data")
    assert rules.param_spec(mesh, "blocks_0/moe/wo",
                            (48, 16, 10752, 6144)) == \
        (None, "model", "data", None)
    assert rules.param_spec(mesh, "blocks_0/moe/wi",
                            (32, 8, 4096, 14336)) == \
        (None, None, "data", "model")
    assert rules.param_spec(mesh, "final_norm/scale", (4096,)) == ()
    multi = make_production_mesh(multi_pod=True)
    assert rules.batch_spec(multi, 256) == (("pod", "data"), None)
    assert rules.batch_spec(multi, 16) == ("data", None)
    assert rules.cache_spec(multi, (32, 128, 32768, 8, 128)) == \
        (None, ("pod", "data"), None, None, "model")
    assert rules.cache_spec(multi, (13, 1, 524288, 4, 256)) == \
        (None, None, "data", None, "model")
    # the port's per-layer cache: the same rule on the unstacked axes
    assert rules.cache_spec(multi, (128, 32768, 8, 128), 0, 1) == \
        (("pod", "data"), None, None, "model")


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard

    multi = make_production_mesh(multi_pod=True)
    assert rules.placements(multi, (("pod", "data"), None)) == \
        [Shard(0), Shard(0), Replicate()]
    assert rules.placements(multi, (None, "model")) == \
        [Replicate(), Replicate(), Shard(1)]
    assert rules.placements(multi, ()) == [Replicate()] * 3
    with pytest.raises(ValueError, match="mesh order"):
        rules.placements(multi, (("data", "pod"),))


_POD_OUTER = textwrap.dedent("""
    from torch.distributed.tensor import distribute_tensor
    import torch
    from repro_torch.launch.mesh import Mesh, fake_group
    from repro_torch.sharding.rules import placements
    mesh = Mesh((2, 2, 2), ("pod", "data", "model"))
    for rank in range(8):
        with fake_group(8, rank):
            dm = mesh.device_mesh("cpu")
            x = torch.arange(16.0).reshape(16, 1)
            local = distribute_tensor(
                x, dm, placements(mesh, (("pod", "data"), None)),
                src_data_rank=None).to_local()
            pod, data, model = dm.get_coordinate()
            first = (pod * 2 + data) * 4
            assert local[:, 0].tolist() == list(range(first, first + 4)), \\
                (rank, local[:, 0].tolist())
    print("POD_OUTER_OK")
""")


def test_tuple_spec_shards_pod_outermost():
    """Rank (pod, data, model) holds rows [(2 pod + data) * 4, +4) of a
    16-row tensor placed by (("pod", "data"), None): pod outermost, as a
    PartitionSpec splits."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", _POD_OUTER], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "POD_OUTER_OK" in res.stdout


def test_fake_group_import_path_exists():
    """The fake process group's store lives under a private path
    (`launch/mesh.py::fake_group`); fail loudly when it moves."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert FakeStore is not None
    assert torch.distributed.is_available()
