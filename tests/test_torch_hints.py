"""The port's activation hints against the JAX package's, on the CPU.

`residual_spec` must be the spec the reference's `maybe_shard(x,
"residual")` constrains the residual to: the test captures it by
replacing `jax.lax.with_sharding_constraint` for the call (the
reference's files are untouched), over meshes, residual shapes and both
sequence-parallel settings.  Without hints, and for a plain tensor,
`maybe_shard` returns its argument; with hints a DTensor is
redistributed to the spec's placements (a child interpreter on a fake
process group: the default group is global to a process).  The decode
cache's shard-wise write, `write_slot`, equals `index_copy_` on the
whole cache on a 2-rank gloo group.
"""
import itertools
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.sharding import hints as jhints
from repro.sharding.rules import abstract_mesh
from repro_torch.launch.mesh import Mesh
from repro_torch.sharding import hints

ROOT = Path(__file__).resolve().parents[1]
MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((4, 2), ("data", "model")),
          ((1, 1), ("data", "model")),
          ((2, 2, 2), ("pod", "data", "model"))]
SHAPES = [(b, s, 8) for b, s in itertools.product(
    (1, 2, 3, 8, 16, 32, 256), (1, 2, 15, 16, 64, 4096))]


def _norm(spec):
    """A spec's entries with lone-axis tuples read as the axis."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _reference_spec(monkeypatch, sizes, names, shape, sp):
    seen = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, sharding: seen.append(sharding.spec) or x)
    x = jax.ShapeDtypeStruct(shape, jnp.float32)
    with jhints.activation_hints(abstract_mesh(sizes, names), sp=sp):
        assert jhints.maybe_shard(x, "residual") is x
    assert len(seen) == 1
    return _norm(seen[0])


@pytest.mark.parametrize("sizes,names", MESHES)
def test_residual_spec_is_the_references(monkeypatch, sizes, names):
    mesh = Mesh(sizes, names)
    for shape, sp in itertools.product(SHAPES, (True, False)):
        want = _reference_spec(monkeypatch, sizes, names, shape, sp)
        assert _norm(hints.residual_spec(mesh, shape, sp)) == want, \
            (sizes, shape, sp)


def test_maybe_shard_is_a_no_op_without_hints():
    x = torch.ones(4, 16, 8)
    assert hints.maybe_shard(x, "residual") is x
    assert not hints.sp_enabled()
    with hints.activation_hints(Mesh((2, 2), ("data", "model")), sp=True):
        assert hints.sp_enabled()
        # a plain tensor is not constrained
        assert hints.maybe_shard(x, "residual") is x
    assert not hints.sp_enabled()


_DTENSOR = textwrap.dedent("""
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.mesh import Mesh, fake_group
    from repro_torch.sharding import hints
    from repro_torch.sharding.rules import placements
    mesh = Mesh((2, 2, 2), ("pod", "data", "model"))
    with fake_group(8):
        dm = mesh.device_mesh("cpu")
        x = distribute_tensor(torch.ones(8, 16, 4), dm, [Replicate()] * 3)
        assert hints.maybe_shard(x) is x
        for sp, want in ((True, [Shard(0), Shard(0), Shard(1)]),
                         (False, [Shard(0), Shard(0), Replicate()])):
            with hints.activation_hints(mesh, sp=sp):
                y = hints.maybe_shard(x, "residual")
            assert list(y.placements) == want, (sp, y.placements)
            assert list(y.placements) == placements(
                mesh, hints.residual_spec(mesh, (8, 16, 4), sp))
            assert tuple(y.to_local().shape) == (
                (2, 8, 4) if sp else (2, 16, 4))
        # other kinds and ranks pass
        with hints.activation_hints(mesh):
            assert hints.maybe_shard(x, "attn") is x
    print("HINTS_OK")
""")


def test_maybe_shard_redistributes_a_dtensor():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", _DTENSOR], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "HINTS_OK" in res.stdout


def test_touched_dims_of_a_view():
    assert list(hints._touched((2, 4, 512), (2, 4, 8, 64))) == [2]
    assert list(hints._touched((2, 4, 8, 64), (2, 4, 512))) == [2, 3]
    assert list(hints._touched((2, 4, 8), (8, 8))) == [0, 1]
    assert list(hints._touched((3, 5), (3, 5))) == []


_WRITE_RANK = textwrap.dedent("""
    import sys
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.mesh import Mesh
    from repro_torch.sharding.hints import write_slot
    rank, port = int(sys.argv[1]), sys.argv[2]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    try:
        dm = Mesh((2, 1), ("data", "model")).device_mesh("cpu")
        gen = torch.Generator().manual_seed(0)
        for place in ([Shard(1), Replicate()], [Shard(0), Replicate()],
                      [Replicate(), Replicate()]):
            cache = torch.randn(2, 8, 2, 4, generator=gen)
            value = torch.randn(2, 1, 2, 4, generator=gen)
            for slot in (0, 3, 4, 7):
                want = cache.clone().index_copy_(1, torch.tensor([slot]),
                                                 value)
                got = distribute_tensor(cache.clone(), dm, place,
                                        src_data_rank=None)
                write_slot(got, torch.tensor([slot]),
                           distribute_tensor(value, dm, [Replicate()] * 2,
                                             src_data_rank=None))
                assert torch.equal(got.full_tensor(), want), (place, slot)
    finally:
        dist.destroy_process_group()
    print("WRITE_OK", rank)
""")


def test_write_slot_on_split_caches():
    """`write_slot` on a 2-rank gloo group: a cache split along its
    slots (context parallelism), along its batch, and replicated, each
    equal to `index_copy_` on the whole cache."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = str(sock.getsockname()[1])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen([sys.executable, "-c", _WRITE_RANK, str(r),
                               port], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, err[-3000:]
        assert f"WRITE_OK {r}" in out


def test_write_slot_on_a_plain_cache():
    cache = torch.zeros(2, 4, 1, 3)
    value = torch.ones(2, 1, 1, 3)
    hints.write_slot(cache, torch.tensor([2]), value)
    assert cache[:, 2].eq(1).all() and cache.sum() == 6
