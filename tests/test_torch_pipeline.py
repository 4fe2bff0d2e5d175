"""The port's GPipe stage loop against the JAX package's, on the CPU.

The JAX package's `make_pipelined` runs in a child interpreter with
four virtual host devices (`--xla_force_host_platform_device_count=4`,
as the JAX package's own pipeline test runs it): its four affine stages
over 6 microbatches, M = 1 and M = 2 < S, and a nonlinear stage with
stacked (S, d, d) weights.  The port runs the same stages on
`["cpu"] * 4`; the schedule's M + S - 1 ticks show as the counted
handoffs, one collective-permute of one microbatch per tick.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch.cost_analysis import collective_stats
from repro_torch.launch.mesh import Mesh
from repro_torch.sharding.collectives import DeviceAxis
from repro_torch.sharding.pipeline import make_pipelined, pipeline_forward

ROOT = Path(__file__).resolve().parents[1]
SCALES = [[2.0], [0.5], [3.0], [1.0]]  # the JAX package's test's stages
MICROBATCHES = (6, 1, 2)

_JAX_CHILD = textwrap.dedent("""
    import json, os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from repro.sharding.pipeline import make_pipelined
    from repro.sharding.rules import make_mesh_compat
    mesh = make_mesh_compat((4,), ("pipe",))
    ws = jnp.asarray(%(scales)r)
    affine = make_pipelined(mesh, lambda w, x: x * w[0], 4)
    res = {}
    for m in %(mbs)r:
        x = jnp.arange(m * 4.0).reshape(m, 4)
        res[f"affine_{m}"] = np.asarray(affine(ws, x)).tolist()
    rng = np.random.default_rng(0)
    w = jnp.asarray(rng.normal(size=(4, 8, 8)).astype(np.float32) * 0.5)
    x = jnp.asarray(rng.normal(size=(5, 3, 8)).astype(np.float32))
    # shard_map hands each stage its (1, d, d) block of the stack
    tanh = make_pipelined(mesh, lambda w, x: jnp.tanh(x @ w[0]), 4)
    res["tanh"] = np.asarray(tanh(w, x)).tolist()
    print(json.dumps(res))
""") % {"scales": SCALES, "mbs": MICROBATCHES}


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = str(ROOT / "src")
    res = subprocess.run([sys.executable, "-c", _JAX_CHILD], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("m", MICROBATCHES)
def test_affine_stages_equal_the_reference(reference, m):
    run = make_pipelined(["cpu"] * 4, lambda w, x: x * w[0], 4)
    x = torch.arange(m * 4.0).reshape(m, 4)
    out = run(torch.tensor(SCALES), x)
    ref = np.asarray(reference[f"affine_{m}"], np.float32)
    assert out.shape == (m, 4)
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(out.numpy(), (x * 3.0).numpy())


def test_nonlinear_stages_match_the_reference(reference):
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.normal(size=(4, 8, 8)).astype(np.float32) * 0.5)
    x = torch.from_numpy(rng.normal(size=(5, 3, 8)).astype(np.float32))
    run = make_pipelined(["cpu"] * 4, lambda w, x: torch.tanh(x @ w), 4)
    out = run(w, x)
    np.testing.assert_allclose(out.numpy(), np.asarray(reference["tanh"]),
                               rtol=1e-5, atol=1e-6)
    seq = []
    for mb in x:  # the same ops, microbatch by microbatch
        for s in range(4):
            mb = torch.tanh(mb @ w[s])
        seq.append(mb)
    assert torch.equal(out, torch.stack(seq))


@pytest.mark.parametrize("m,s", [(6, 4), (1, 4), (2, 4), (3, 1), (5, 2)])
def test_ticks_and_counted_handoffs(m, s):
    calls = []

    def stage(w, x):
        calls.append(float(w))
        return x + w

    run = make_pipelined(["cpu"] * s, stage, s)
    x = torch.zeros(m, 3, dtype=torch.float64)
    out = run(torch.arange(1.0, s + 1, dtype=torch.float64), x)
    assert torch.equal(out, torch.full((m, 3), s * (s + 1) / 2.0,
                                       dtype=torch.float64))
    stats = collective_stats(run.axis)
    assert stats["collective-permute_count"] == m + s - 1  # one per tick
    assert stats["collective-permute"] == (m + s - 1) * 3 * 8
    assert len(calls) == m * s  # no stage runs without a microbatch


def test_stage_parameters_as_a_list_and_the_mesh_form():
    mesh = Mesh((1, 4), ("data", "pipe"), ["cpu"] * 4)
    blocks = [torch.nn.Linear(4, 4).double() for _ in range(4)]
    run = make_pipelined(mesh, lambda b, x: b(x), 4)
    x = torch.randn(3, 2, 4, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = run(blocks, x)
        seq = []
        for mb in x:  # the same blocks, microbatch by microbatch
            for b in blocks:
                mb = b(mb)
            seq.append(mb)
    assert torch.equal(out, torch.stack(seq))


def test_stage_count_must_match_the_devices():
    with pytest.raises(ValueError, match="stages"):
        pipeline_forward(lambda w, x: x, 3, DeviceAxis(["cpu"] * 4))
    run = make_pipelined(["cpu"] * 2, lambda w, x: x, 2)
    with pytest.raises(ValueError, match="stage parameters"):
        run(torch.ones(3), torch.ones(2, 2))
