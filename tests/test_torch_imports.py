"""Import hygiene of the PyTorch port.

`repro_torch` and `chip_smoke.py` must import neither JAX nor the JAX
package `repro`: a fresh interpreter imports the port, runs a CPU
engine step per backend, fills a `SlotPool`, serves a few streams
through `serve_streams`, migrates a stream in a two-shard `ShardedPool`,
serves through a two-shard gateway, runs an engine split over two
devices and a word-length evaluation, trains a reduced LM for two steps,
saves and restores a checkpoint, runs the data clouds, scans one stream
over two CPU shards, runs a two-stage pipeline and the TEDA dry run,
traces a reduced decode cell on a fake four-rank group, and trains one
step on a one-device mesh, after which neither is in `sys.modules`; and
no source file of the port (every sub-package, the LM and training ones
included) names them in an import.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|from\s+repro[\s.]|"
    r"import\s+repro(\s|\.|,|$))", re.M)

_PROBE = """
import sys
import numpy as np
import repro_torch
from repro_torch.engine import StreamEngine
from repro_torch.fixedpoint import QFormat
for backend in ("scan", "cuda", "cuda-q", "ensemble"):
    eng = StreamEngine(8, backend, device="cpu", fmt=QFormat(32, 20),
                       detectors=("teda", "rde", "zscore", "hst", "teda-q"))
    out = eng.process(np.ones((4, 8), np.float32))
    assert out["ecc"].shape == (4, 8)
from repro_torch.engine import SlotPool
from repro_torch.launch.serve import _demo_streams, serve_streams
pool = SlotPool("cuda-q", buckets=(2, 4), device="cpu", fmt=QFormat(32, 20))
pool.acquire(3)
assert pool.capacity == 4
res = serve_streams(_demo_streams(3, 8, 2), backend="cuda-q", device="cpu",
                    fmt=QFormat(32, 20), buckets=(2, 4), chunk_t=4)
assert res["requests"] == 3 and res["samples"] == 30
from repro_torch.engine import ShardedPool
fleet = ShardedPool("cuda-q", shards=2, buckets=(2, 4), device="cpu",
                    fmt=QFormat(32, 20))
shard, _ = fleet.acquire("a", shard=0)
fleet.migrate("a", 1)
assert fleet.lookup("a")[0] == 1 and fleet.migrations == 1
res = serve_streams(_demo_streams(4, 8, 2), backend="cuda-q", device="cpu",
                    fmt=QFormat(32, 20), buckets=(2, 4), chunk_t=4,
                    shards=2, rebalance_every=2)
assert res["shards"] == 2 and res["samples"] == 40
split = StreamEngine(8, "cuda-q", devices=["cpu", "cpu"],
                     fmt=QFormat(32, 20))
assert split.process(np.ones((4, 8), np.float32))["ecc"].shape == (4, 8)
from repro_torch.fixedpoint import evaluate_format
evaluate_format(np.ones((6, 2), np.float32), QFormat(16, 8))
import tempfile
import torch
from repro_torch.configs import get_config
from repro_torch.launch.train import train
_, hist, _ = train(get_config("llama3.2-1b").reduced(), 2, 2, 16, None,
                   device="cpu")
assert len(hist) == 2
from repro_torch.checkpoint import CheckpointManager
with tempfile.TemporaryDirectory() as d:
    mgr = CheckpointManager(d, async_save=False)
    mgr.save(1, {"w": torch.ones(3, dtype=torch.bfloat16)})
    assert mgr.restore({"w": torch.zeros(3, dtype=torch.bfloat16)})[0][
        "w"].sum() == 3
from repro_torch.core import clouds_run
assert int(clouds_run(torch.zeros(4, 2))[0].n_active) == 1
from repro_torch.core.distributed import distributed_teda
fin, out = distributed_teda(np.ones((8, 2), np.float32), 3.0, ["cpu"] * 2)
assert out.ecc.shape == (8,) and float(fin.k) == 8.0
from repro_torch.sharding.pipeline import make_pipelined
piped = make_pipelined(["cpu"] * 2, lambda w, x: x * w, 2)
assert float(piped(torch.tensor([2.0, 3.0]), torch.ones(3, 2)).sum()) == 36
from repro_torch.launch.teda_dryrun import run as teda_dryrun
assert teda_dryrun(False, 1 << 12, 4)["collectives"]["all-gather_count"] == 3
import contextlib
from repro_torch.configs.registry import ShapeSpec
from repro_torch.launch import dryrun, hillclimb
from repro_torch.launch.mesh import Mesh, fake_group, make_host_mesh
from repro_torch.launch.specs import build_cell
from repro_torch.sharding import hints
with fake_group(4):
    cell = build_cell("llama3_2_1b", ShapeSpec("d", 16, 4, "decode"),
                      Mesh((2, 2), ("data", "model")),
                      get_config("llama3.2-1b").reduced())
    assert dryrun._trace(cell, contextlib.nullcontext())["flops"] > 0
assert hillclimb.parse_override("remat_policy=dots") == ("remat_policy",
                                                         "dots")
_, hist, _ = train(get_config("llama3.2-1b").reduced(), 1, 2, 16, None,
                   device="cpu", mesh=make_host_mesh(device="cpu"))
assert len(hist) == 1
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
print("BAD", bad)
"""


def test_port_runs_without_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "BAD []"


def test_no_source_imports_jax_or_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    scanned = {p.relative_to(PORT).parts[0] for p in files
               if PORT in p.parents}
    for sub in ("models", "configs", "optim", "data", "checkpoint", "core",
                "launch", "engine", "kernels", "sharding"):
        assert sub in scanned, sub
    for path in files:
        hits = _FORBIDDEN.findall(path.read_text())
        assert not hits, f"{path.relative_to(ROOT)} imports {hits}"
    # the pattern does catch what it is meant to catch
    assert _FORBIDDEN.search("import jax.numpy as jnp")
    assert _FORBIDDEN.search("from repro.engine import x")
    assert _FORBIDDEN.search("import repro")
    assert not _FORBIDDEN.search("from repro_torch.engine import x")
    assert not _FORBIDDEN.search("import repro_torch")
