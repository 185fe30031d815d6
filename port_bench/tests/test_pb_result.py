"""The result line of a run, the CLIs' refusal without a card, and a run
traced on the CPU."""

import json
import subprocess
import sys

import pytest
from pb_helpers import REPO, run_tiny

CELLS = ["kron24.pagerank", "urand24.pagerank", "kron24.bfs", "urand24.bfs"]


def spec():
    return json.loads((REPO / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("workload", CELLS)
def test_result_line(tiny_root, workload):
    out = run_tiny(tiny_root, workload)
    line = json.loads(json.dumps(out))  # one JSON object
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    units = {m["name"]: m["unit"] for m in spec()["end_to_end"]
             if workload in m.get("workloads", [workload])}
    assert {k: v["unit"] for k, v in line["metrics"].items()} == units
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for check in line["checks"].values():
        assert set(check) == {"value", "limit"} and check["value"] <= check["limit"]


@pytest.mark.parametrize("workload", ["kron24.pagerank", "urand24.bfs"])
def test_traced_result_line(tiny_root, workload):
    line = run_tiny(tiny_root, workload, trace=True)
    per_layer = [m for m in spec()["per_layer"] if workload in m["workloads"]]
    analytic = workload.split(".")[1]
    # the CPU launches nothing: the device's readers find nothing and stay out
    assert set(line["metrics"]) == {"ingest.build_s",
                                    f"algorithms.launches_per_query.{analytic}",
                                    f"algorithms.host_reads_per_query.{analytic}"}
    assert set(line["metrics"]) <= {m["name"] for m in per_layer}
    assert line["metrics"][f"algorithms.host_reads_per_query.{analytic}"]["value"] >= 1
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert line["correct"] is True


@pytest.mark.parametrize("args", [
    ["port_bench/run.py", "--workload", "kron24.pagerank", "--seed", str(2**31 + 5),
     "--seconds", "1", "--trace", "0"],
    ["port_bench/calibrate.py", "--workload", "kron24.pagerank", "--seeds", "1",
     "--control-seeds", "2"],
], ids=["run", "calibrate"])
def test_cli_refuses_without_card(args):
    proc = subprocess.run(
        [sys.executable, *args],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""},
    )
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no CUDA card" in proc.stderr
