"""pytest settings of the benchmark's own tests (``port_bench/tests``)."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one (decided in the `card` fixture)")
