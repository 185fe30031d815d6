"""The control, the reference one precision below the configuration's put
in the program's place, fails the comparison: PageRank's scores held in
bfloat16, BFS's predecessor ids carried in bfloat16, SSSP's distances
carried in bfloat16. At a scale a test run
holds; the readings at the cells' own size are taken on the card by
``port_bench/calibrate.py`` (PERF.md)."""

import pytest
import torch
from pb_helpers import SEED, make_root

from port_bench import calibrate, harness


@pytest.mark.parametrize("workload", ["kron24.pagerank", "urand24.pagerank", "kron24.bfs",
                                      "urand24.bfs", "kron24w.sssp"])
def test_control_fails(tmp_path, workload):
    root = make_root(tmp_path, scale=12)
    cell = harness.load_cell(root, workload)
    readings = calibrate.control_readings(cell, SEED, torch.device("cpu"))
    limits = cell.traffic["limits"]
    assert any(readings[name] > limits[name] for name in readings), readings
