"""The benchmark's own tests (not part of the repository's suite).

    python3 -m pytest -q perfbench/tests

Run from the root of the checkout.  Tests that need the card carry the
``cuda`` marker and skip without one; the rest run on the CPU at smoke
sizes (``perfbench/tests/data``).
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped without one")
