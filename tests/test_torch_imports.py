"""Import hygiene of the PyTorch port.

`repro_torch` and `chip_smoke.py` must import neither JAX nor the JAX
package `repro`: a fresh interpreter imports the port and runs a CPU
engine step, after which neither is in `sys.modules`; and no source
file of the port names them in an import.
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
    for path in files:
        hits = _FORBIDDEN.findall(path.read_text())
        assert not hits, f"{path.relative_to(ROOT)} imports {hits}"
    # the pattern does catch what it is meant to catch
    assert _FORBIDDEN.search("import jax.numpy as jnp")
    assert _FORBIDDEN.search("from repro.engine import x")
    assert _FORBIDDEN.search("import repro")
    assert not _FORBIDDEN.search("from repro_torch.engine import x")
    assert not _FORBIDDEN.search("import repro_torch")
