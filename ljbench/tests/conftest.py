"""Tests of the benchmark harness (not the port's tests): CPU tests at small
sizes, and card tests marked ``cuda`` that skip where there is no card.

    python -m pytest ljbench/tests -q
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU (skips where there is none)")
