"""Nothing the benchmark runs loads JAX or the JAX package, and the
references load nothing of the program (top-level names compared
whole: `repro_torch` is not `repro`)."""
import subprocess
import sys

from tedabench.harness import ROOT

PROBE = r"""
import sys
sys.path[:0] = [{src!r}, {root!r}]
{body}
tops = {{n.split(".")[0] for n in sys.modules}}
bad = sorted(tops & {{"jax", "jaxlib", "flax", "repro"}})
print("BAD", bad, "TORCH_PORT", "repro_torch" in tops)
"""


def probe(body):
    code = PROBE.format(src=str(ROOT / "src"), root=str(ROOT), body=body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


def test_harness_and_port_load_no_jax():
    line = probe(
        "import runpy\n"
        "runpy.run_path('tedabench/run.py', run_name='not_main')\n"
        "from tedabench import harness, control\n"
        "harness.make_engine(harness.load_json('configs', "
        "'damadics-fleet-q32.20'), 'cpu')\n"
        "for k in ('teda_f64', 'teda_q'):\n"
        "    harness.load_module('reference', k)\n"
        "import pathlib\n"
        "for p in pathlib.Path('tedabench/metrics').glob('*.py'):\n"
        "    harness.load_module('metrics', p.stem)\n")
    assert line == "BAD [] TORCH_PORT True"


def test_references_load_nothing_of_the_program():
    line = probe(
        "import importlib.util\n"
        "for k in ('teda_f64', 'teda_q'):\n"
        "    p = 'tedabench/reference/%s.py' % k\n"
        "    s = importlib.util.spec_from_file_location(k, p)\n"
        "    s.loader.exec_module(importlib.util.module_from_spec(s))\n"
        "import tedabench.check, tedabench.data\n")
    assert line == "BAD [] TORCH_PORT False"
