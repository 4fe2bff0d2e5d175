"""The port's time-sharded TEDA scan against the JAX package's, on the CPU.

Covered: the Welford block moments and merge (`core/scan.py`) against
the JAX package's, a zero-count merge included; `distributed_teda` over
eight shards on `["cpu"] * 8` (the CPU stand-in for eight devices)
against the JAX package's 8-device `distributed_teda`, run in a child
interpreter with `--xla_force_host_platform_device_count=8` as the JAX
package's own test runs it (fields, final state, and the collectives
the axis counts against `collective_stats` of the compiled program);
D in {1, 2, 8} against the port's `teda_scan` and `teda_numpy_loop`,
every shard's final state bit for bit the same; the mesh form; T not
divisible by D; and `distributed_teda_group` over a 4-rank gloo group
of child processes, each rank bit for bit the `DeviceAxis` form's
block.
"""
import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.scan import WelfordState as JWelford
from repro.core.scan import welford_combine as jwelford_combine
from repro.core.scan import welford_of_block as jwelford_of_block
from repro_torch.core import teda_numpy_loop, teda_scan, welford_combine
from repro_torch.core.distributed import (distributed_teda,
                                          make_distributed_teda)
from repro_torch.core.scan import WelfordState, welford_of_block
from repro_torch.launch.cost_analysis import collective_stats
from repro_torch.launch.mesh import make_host_mesh

ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL, BAND = 5e-4, 1e-5, 1e-4
FIELDS = ("ecc", "typ", "zeta", "threshold", "outlier", "k")

torch.set_num_threads(2)


def _stream(t=1024, n=4, seed=42):
    """The JAX package's test stream: N(0, 1) with a burst at 700-720."""
    x = np.random.default_rng(seed).normal(size=(t, n)).astype(np.float32)
    x[700:720] += 6.0
    return x


def _child_env():
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def _words(v: torch.Tensor) -> torch.Tensor:
    return v.view(torch.int32) if v.dtype == torch.float32 else v


def _flags_outside_band(zeta, thr, a, b):
    """Flag mismatches outside the 1e-4 band around the threshold."""
    zeta, thr = np.asarray(zeta, np.float64), np.asarray(thr, np.float64)
    band = np.abs(zeta - thr) <= BAND * thr
    return int(((np.asarray(a) != np.asarray(b)) & ~band).sum())


# ------------------------------------------------------------- Welford --
@pytest.mark.parametrize("shape", [(64, 3), (48, 5, 3)])
def test_welford_block_matches_reference(shape):
    x = np.random.default_rng(1).normal(2.0, 3.0, size=shape)
    x = x.astype(np.float32)
    got = welford_of_block(torch.from_numpy(x))
    ref = jwelford_of_block(jnp.asarray(x))
    for name in WelfordState._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-6, err_msg=name)
    assert got.count.shape == shape[1:-1]


@pytest.mark.parametrize("shape", [(40, 3), (40, 5, 3)])
def test_welford_combine_matches_reference(shape):
    rng = np.random.default_rng(2)
    xa = rng.normal(0.0, 1.0, size=shape).astype(np.float32)
    xb = rng.normal(4.0, 2.0, size=(24,) + shape[1:]).astype(np.float32)
    got = welford_combine(welford_of_block(torch.from_numpy(xa)),
                          welford_of_block(torch.from_numpy(xb)))
    ref = jwelford_combine(jwelford_of_block(jnp.asarray(xa)),
                           jwelford_of_block(jnp.asarray(xb)))
    whole = welford_of_block(torch.from_numpy(np.concatenate([xa, xb])))
    for name in WelfordState._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-6, err_msg=name)
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   getattr(whole, name).numpy(),
                                   rtol=1e-5, err_msg=name)


def test_welford_combine_with_a_zero_count_block():
    x = np.random.default_rng(3).normal(size=(32, 2, 3)).astype(np.float32)
    blk = welford_of_block(torch.from_numpy(x))
    empty = WelfordState(count=torch.zeros(2), mean=torch.zeros(2, 3),
                         m2=torch.zeros(2))
    jblk = jwelford_of_block(jnp.asarray(x))
    jempty = JWelford(count=jnp.zeros(2), mean=jnp.zeros((2, 3)),
                      m2=jnp.zeros(2))
    for got, ref in ((welford_combine(empty, blk),
                      jwelford_combine(jempty, jblk)),
                     (welford_combine(blk, empty),
                      jwelford_combine(jblk, jempty))):
        for name in WelfordState._fields:
            assert torch.equal(getattr(got, name), getattr(blk, name)), name
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       np.asarray(getattr(ref, name)),
                                       rtol=1e-6, err_msg=name)
    both = welford_combine(empty, empty)  # n = 0: the safe_n guard
    assert torch.isfinite(both.mean).all() and float(both.m2.sum()) == 0.0


# ------------------------------------------- against the JAX package --
_JAX_8DEV = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np, jax, jax.numpy as jnp
    from repro.core.distributed import make_distributed_teda
    from repro.launch.hlo_analysis import collective_stats
    x = jnp.asarray(np.load(sys.argv[1]))
    m = jnp.float32(3.0)
    fn = make_distributed_teda(jax.make_mesh((8,), ("data",)))
    fin, out = fn(x, m)
    np.savez(sys.argv[2], fk=np.asarray(fin.k), fmean=np.asarray(fin.mean),
             fvar=np.asarray(fin.var),
             **{f: np.asarray(getattr(out, f)) for f in out._fields})
    print(json.dumps(collective_stats(fn.lower(x, m).compile().as_text())))
""")


@pytest.fixture(scope="module")
def jax_8dev(tmp_path_factory):
    """The JAX package's 8-device run on `_stream()`: (outputs, stats)."""
    d = tmp_path_factory.mktemp("jax8")
    np.save(d / "x.npy", _stream())
    res = subprocess.run([sys.executable, "-c", _JAX_8DEV, str(d / "x.npy"),
                          str(d / "out.npz")], env=_child_env(),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return (dict(np.load(d / "out.npz")),
            json.loads(res.stdout.strip().splitlines()[-1]))


def test_eight_shards_match_the_jax_package(jax_8dev):
    ref, _ = jax_8dev
    fn = make_distributed_teda(["cpu"] * 8)
    fin, out = fn(torch.from_numpy(_stream()), 3.0)
    for f in FIELDS:
        got = getattr(out, f).numpy()
        assert got.shape == (1024,), f
        if f == "outlier":
            assert _flags_outside_band(ref["zeta"], ref["threshold"], got,
                                       ref[f]) == 0
            assert got[700:720].any()
        else:
            np.testing.assert_allclose(got, ref[f], rtol=RTOL, atol=ATOL,
                                       err_msg=f)
    assert float(fin.k) == float(ref["fk"]) == 1024.0
    np.testing.assert_allclose(fin.mean.numpy(), ref["fmean"], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(fin.var), float(ref["fvar"]), rtol=RTOL,
                               atol=ATOL)
    assert len(fn.finals) == 8
    for other in fn.finals:
        for a, b in zip(other, fin):
            assert torch.equal(_words(a), _words(b))


def test_counted_collectives_equal_the_compiled_programs(jax_8dev):
    _, ref_stats = jax_8dev
    fn = make_distributed_teda(["cpu"] * 8)
    fn(torch.from_numpy(_stream()), 3.0)
    got = collective_stats(fn.axis)
    assert got == ref_stats
    assert got == {"all-gather": 168.0, "total_bytes": 168.0,
                   "all-gather_count": 3}


# ----------------------------------------------- the port on its own --
@pytest.mark.parametrize("d", [1, 2, 8])
def test_shards_match_the_scan_and_the_loop(d):
    x = _stream()
    fn = make_distributed_teda(["cpu"] * d)
    fin, out = fn(torch.from_numpy(x), 3.0)
    sfin, sout = teda_scan(torch.from_numpy(x), 3.0)
    loop = teda_numpy_loop(x, 3.0)
    for f in ("ecc", "typ", "zeta", "threshold", "k"):
        np.testing.assert_allclose(getattr(out, f).numpy(),
                                   getattr(sout, f).numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=f)
    for f in ("ecc", "zeta", "threshold"):
        np.testing.assert_allclose(getattr(out, f).numpy(), loop[f],
                                   rtol=RTOL, atol=ATOL, err_msg=f)
    assert _flags_outside_band(loop["zeta"], loop["threshold"],
                               out.outlier.numpy(), loop["outlier"]) == 0
    assert torch.equal(out.outlier, sout.outlier)
    assert torch.equal(fin.k, sfin.k) and float(fin.k) == 1024.0
    np.testing.assert_allclose(fin.mean.numpy(), loop["mean"], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(fin.var), loop["var"], rtol=RTOL)
    np.testing.assert_allclose(float(fin.var), float(sfin.var), rtol=RTOL)
    for other in fn.finals:
        for a, b in zip(other, fin):
            assert torch.equal(_words(a), _words(b))


@pytest.mark.parametrize("d,n", [(2, 1), (4, 4), (8, 3)])
def test_counted_gathers_follow_the_ring_model(d, n):
    fn = make_distributed_teda(["cpu"] * d)
    x = np.random.default_rng(d).normal(size=(8 * d, n)).astype(np.float32)
    fn(x, 3.0)
    stats = collective_stats(fn.axis)
    want = (d - 1) / d * (d * n * 4 + 2 * d * 4)
    assert stats["all-gather_count"] == 3
    assert stats["all-gather"] == stats["total_bytes"] == pytest.approx(want)


def test_the_mesh_form_equals_the_device_list_form():
    x = torch.from_numpy(_stream())
    mesh = make_host_mesh(data=4, model=2, device="cpu")
    fin, out = distributed_teda(x, 3.0, mesh)
    lfin, lout = distributed_teda(x, 3.0, ["cpu"] * 4)
    for a, b in zip(tuple(out) + tuple(fin), tuple(lout) + tuple(lfin)):
        assert torch.equal(_words(a), _words(b))


def test_indivisible_stream_length_raises():
    with pytest.raises(ValueError, match="divisible"):
        distributed_teda(np.zeros((10, 2), np.float32), 3.0, ["cpu"] * 4)


# ------------------------------------------------ the process group --
_GLOO_RANK = textwrap.dedent("""
    import sys
    import numpy as np, torch, torch.distributed as dist
    from repro_torch.core.distributed import (distributed_teda_group,
                                              make_distributed_teda)
    torch.set_num_threads(1)
    rank, world, port, path = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4])
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        x = torch.from_numpy(np.load(path))
        t = x.shape[0] // world
        fin, out = distributed_teda_group(x[rank * t:(rank + 1) * t], 3.0)
        ref = make_distributed_teda(["cpu"] * world)
        _, rout = ref(x, 3.0)
        words = lambda v: v.view(torch.int32) if v.is_floating_point() else v
        for f, a, b in zip(out._fields, out, rout):
            assert torch.equal(words(a), words(b[rank * t:(rank + 1) * t])), f
        for a, b in zip(fin, ref.finals[rank]):
            assert torch.equal(words(a), words(b))
        assert bool(out.outlier.any()) == (rank == 2)
    finally:
        dist.destroy_process_group()
    print("GROUP_OK", rank)
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_gloo_group_ranks_equal_the_device_axis_form(tmp_path):
    world = 4
    np.save(tmp_path / "x.npy", _stream())
    port = str(_free_port())
    env = _child_env()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _GLOO_RANK, str(r), str(world), port,
         str(tmp_path / "x.npy")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    try:
        results = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, (out, err)) in enumerate(zip(procs, results)):
        assert p.returncode == 0, err[-3000:]
        assert f"GROUP_OK {r}" in out
