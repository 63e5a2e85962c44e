"""Tests of the benchmark harness.  They run on the CPU at tiny sizes,
with the port's host kernel; those marked ``cuda`` need the card and
skip without one.  Run them from the root of the checkout:

    python -m pytest -q perfbench/tests
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and nvcc; skips on a machine without one")
