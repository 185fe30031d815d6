"""Helpers of the benchmark's tests: a copy of the benchmark at a tiny
scale, and one run of a cell of it on the CPU."""

import json
import shutil
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "port_bench"
TINY_SCALE = 10
SEED = 2**31 + 11  # above 32 signed bits: a seed may be any whole number


def make_root(tmp_path: Path, scale: int = TINY_SCALE) -> Path:
    """A checkout's benchmark in ``tmp_path``: the folder copied, each
    configuration cut to 2^scale vertices, and BENCHMARK.json beside it."""
    root = tmp_path / "root"
    shutil.copytree(BENCH, root / BENCH.name, ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        path = root / c["file"]
        config = json.loads(path.read_text())
        config["scale"] = scale
        path.write_text(json.dumps(config))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def run_tiny(root: Path, workload: str, seed: int = SEED, seconds: float = 0.3,
             trace: bool = False) -> dict:
    """One run of ``workload`` of ``root`` on the CPU: everything of a run
    but the look for a card."""
    from port_bench import harness

    return harness.run_cell(root, workload, seed, seconds, trace, torch.device("cpu"),
                            time.perf_counter(), log=lambda msg: None)
