"""On the card: each cell's whole command, with a short window, prints a
correct result line. Run with ``python -m pytest port_bench/tests -m card``
on a machine with a card; skips without one."""

import json
import subprocess
import sys

import pytest
from pb_helpers import REPO, SEED

CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_card(card, workload, trace):
    proc = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", workload, "--seed", str(SEED),
         "--seconds", "3", "--trace", str(trace)],
        cwd=REPO, capture_output=True, text=True, timeout=360,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, proc.stderr[-4000:]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert line["metrics"]
