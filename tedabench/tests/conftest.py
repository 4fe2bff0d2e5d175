"""Test settings of the benchmark's harness: the repository's root and
its `src` on the path, and the `card` marker for tests that need a
CUDA device (each decides inside the test, and skips on the CPU)."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips on the CPU")
