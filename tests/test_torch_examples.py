"""The port's examples (`examples/torch_*.py`) against their JAX twins, on
the CPU.

Each `examples/torch_<name>.py` runs with `--device cpu` and its twin
`examples/<name>.py` with `JAX_PLATFORMS=cpu`, each in a child
interpreter, all started together; the verdict lines they print must be
equal: anomalous channels, outlier counts and first indices, agreement
shares, hit / latency / false-alarm rate (and the DAMADICS plot), the
guard's skips at every logged step, the flagged requests.  Throughput
figures, losses, learning rates and straggler trips are left out, and
the kernel's name in a line ("pallas" / "cpu") is not compared.  The
guard's skips and the flagged requests depend on the weights, and the
two packages' generators draw different ones from one seed: the two LM
examples' twins draw theirs (and the prompts) in a JAX child that saves
them as an .npz, and the port's child, before it runs the example,
puts that draw in place of the port's own (`init_lm_params`, and the
prompts that `launch/serve.py::serve` hands to `serve_prompts`); the
examples themselves are run as they are.

Each port example imports neither `jax` nor `repro`, and without a GPU
and without `--device cpu` each one refuses to run.
"""
import json
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
NAMES = ("quickstart", "quickstart_engine", "quickstart_fixedpoint",
         "damadics_stream", "train_guarded", "serve_monitored")
SHARED_DRAW = {"train_guarded", "serve_monitored"}
TIMEOUT_S = 300

# the JAX twin's initial draw for an LM example, as an .npz of its
# leaves under their "/"-joined paths
_WRITE_DRAW = textwrap.dedent("""
    import sys, jax, numpy as np
    from repro.configs.registry import get_config
    from repro.models.transformer import init_lm_params
    name, out = sys.argv[1], sys.argv[2]
    key = jax.random.PRNGKey(0)
    if name == "serve_monitored":  # src/repro/launch/serve.py::serve
        cfg = get_config("qwen2-7b").reduced()
        tree = init_lm_params(key, cfg)
        tree["prompts"] = jax.random.randint(key, (4, 24), 0, cfg.vocab)
    else:  # src/repro/launch/train.py::train
        from repro.launch.train import build_state
        cfg = get_config("llama3.2-1b").reduced()
        tree = build_state(cfg, key)[0]
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    np.savez(out, **{"/".join(k.key for k in path): np.asarray(leaf)
                     for path, leaf in flat})
""")

# a port example as __main__ (after `--draw FILE`, with the twin's draw
# in place of the port's), then the modules it left imported
_PORT = textwrap.dedent("""
    import importlib, json, runpy, sys
    args = sys.argv[1:]
    if args[0] == "--draw":
        import numpy as np
        import torch
        from repro_torch.models.convert import lm_params_from_numpy
        tree = {}
        with np.load(args[1]) as z:
            for name in z.files:
                *parents, leaf = name.split("/")
                node = tree
                for key in parents:
                    node = node.setdefault(key, {})
                node[leaf] = z[name]
        prompts = tree.pop("prompts", None)

        def drawn(seed, cfg, device=None):
            return lm_params_from_numpy(tree, cfg, device)

        for mod in ("repro_torch.models", "repro_torch.launch.train"):
            importlib.import_module(mod).init_lm_params = drawn
        if prompts is not None:
            serve = importlib.import_module("repro_torch.launch.serve")
            plain = serve.serve_prompts

            def given(params, _, *rest, **kw):
                return plain(params, torch.as_tensor(prompts), *rest, **kw)

            serve.serve_prompts = given
        args = args[2:]
    sys.argv = args
    runpy.run_path(sys.argv[0], run_name="__main__")
    print("MODULES " + json.dumps(sorted(
        m for m in sys.modules if m.split(".")[0] in ("jax", "repro"))))
""")


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **extra)
    env.pop("XLA_FLAGS", None)
    return env


def _start(cmd, **env):
    return subprocess.Popen(cmd, env=_env(**env), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(p, what):
    out, err = p.communicate(timeout=TIMEOUT_S)
    assert p.returncode == 0, f"{what}: {err[-3000:]}"
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{name: (twin's stdout, port's stdout)}: every twin, every draw
    writer and the port examples that need no draw started together,
    the other port examples as soon as their draw is written."""
    tmp = tmp_path_factory.mktemp("examples")
    ex = ROOT / "examples"
    procs, twins, ports, writers = [], {}, {}, {}

    def port(name, *draw):
        # one thread each: 14 children share the machine with the other
        # test workers, and oversubscribed thread pools stall them
        p = _start([sys.executable, "-c", _PORT, *draw,
                    str(ex / f"torch_{name}.py"), "--device", "cpu"],
                   OMP_NUM_THREADS="1")
        procs.append(p)
        return p

    try:
        for name in NAMES:
            twins[name] = _start([sys.executable, str(ex / f"{name}.py")],
                                 JAX_PLATFORMS="cpu")
            procs.append(twins[name])
            if name in SHARED_DRAW:
                writers[name] = _start([sys.executable, "-c", _WRITE_DRAW,
                                        name, str(tmp / f"{name}.npz")],
                                       JAX_PLATFORMS="cpu")
                procs.append(writers[name])
            else:
                ports[name] = port(name)
        for name, w in writers.items():
            _finish(w, f"{name} draw")
            ports[name] = port(name, "--draw", str(tmp / f"{name}.npz"))
        return {name: (_finish(twins[name], name),
                       _finish(ports[name], f"torch_{name}"))
                for name in NAMES}
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


def _verdicts(name, out):
    """The lines of `out` that carry verdicts, with the figures that are
    not verdicts (speeds, losses, rates, straggler trips) taken out."""
    lines = [ln for ln in out.strip().splitlines()
             if not ln.startswith("MODULES ")]
    if name == "serve_monitored":
        return [ln for ln in lines if "tok/s" not in ln]
    if name == "train_guarded":
        keep = []
        for ln in lines:
            step = re.match(r"\[train\] step=(\d+) .*skipped=(\d+)", ln)
            if step:
                keep.append(f"step {step[1]} skipped {step[2]}")
            elif "guard-skipped" in ln or "guard skipped" in ln:
                keep.append(re.search(r"skipped\D*(\d+)", ln)[0])
            else:
                keep.append(ln)
        return keep
    return [re.sub(r"^\w+ (integer )?kernel:", "kernel:", ln)
            .replace("lax.scan", "scan") for ln in lines]


@pytest.mark.parametrize("name", NAMES)
def test_verdicts_equal_the_jax_twins(runs, name):
    twin, port = runs[name]
    want = _verdicts(name, twin)
    assert len(want) >= 2, twin
    assert _verdicts(name, port) == want


@pytest.mark.parametrize("name", NAMES)
def test_the_port_example_imports_no_jax(runs, name):
    line = runs[name][1].strip().splitlines()[-1]
    assert line.startswith("MODULES ")
    assert json.loads(line[len("MODULES "):]) == []


@pytest.fixture(scope="module")
def refusals():
    """{name: the port example run with no arguments}, all started
    together."""
    procs = {name: _start([sys.executable,
                           str(ROOT / "examples" / f"torch_{name}.py")])
             for name in NAMES}
    out = {}
    try:
        for name, p in procs.items():
            _, err = p.communicate(timeout=120)
            out[name] = (p.returncode, err)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="runs only where no GPU is visible")
@pytest.mark.parametrize("name", NAMES)
def test_without_a_gpu_the_example_refuses(refusals, name):
    rc, err = refusals[name]
    assert rc != 0
    assert "CUDA is not available" in err
