"""Each metric's reader on a made-up run record, and the reading of a
profiler window on made-up events."""

import json
import math
import types

import pytest
from pb_helpers import BENCH, REPO
from torch.autograd import DeviceType

from port_bench import harness, timing

RECORD = dict(
    cell="x", analytic="pagerank", setup_s=12.5, ingest_build_s=0.5, window_s=2.0,
    latencies_s=[0.1 * (i + 1) for i in range(20)], nominal_edges=[10**9] * 20,
    profile=dict(wall_s=2.0, busy_s=1.5, launches=700, host_reads=400, queries=20,
                 bytes=3.35e12 * 0.15),
)


def read(name, rec=RECORD):
    return harness.metric_reader(BENCH, name, rec["analytic"])(rec)


def test_every_metric_has_a_reader():
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for w in spec["workloads"]:
        cell = harness.load_cell(REPO, w["name"])
        for m in cell.end_to_end + cell.per_layer:
            path = harness.reader_path(BENCH, m["name"], cell.traffic["analytic"])
            assert path.exists(), (w["name"], m["name"])


def test_reader_path_falls_back_to_the_general_reader():
    metrics = BENCH / "metrics"
    assert harness.reader_path(BENCH, "gteps.bfs", "bfs") == metrics / "gteps.py"
    assert (harness.reader_path(BENCH, "kernels.bfs_roofline", "bfs")
            == metrics / "kernels.roofline.py")
    assert (harness.reader_path(BENCH, "algorithms.launches_per_query.pagerank", "pagerank")
            == metrics / "algorithms.launches_per_query.py")
    assert harness.reader_path(BENCH, "setup_s", "bfs") == metrics / "setup_s.py"
    # another analytic's metric names no reader in this cell
    assert not harness.reader_path(BENCH, "kernels.bfs_roofline", "pagerank").exists()
    assert not harness.reader_path(BENCH, "gteps.bfs", "pagerank").exists()


@pytest.mark.parametrize("analytic", ["pagerank", "bfs"])
def test_end_to_end_readers(analytic):
    rec = dict(RECORD, analytic=analytic)
    assert read(f"gteps.{analytic}", rec) == pytest.approx(20 * 1e9 / 2.0 / 1e9)
    # nearest rank: the 19th of 20
    assert read(f"query_p95_ms.{analytic}", rec) == pytest.approx(1900.0)
    assert read("setup_s", rec) == 12.5
    empty = dict(rec, latencies_s=[], nominal_edges=[])
    assert read(f"gteps.{analytic}", empty) is None
    assert read(f"query_p95_ms.{analytic}", empty) is None


@pytest.mark.parametrize("analytic", ["pagerank", "bfs"])
def test_per_layer_readers(analytic):
    rec = dict(RECORD, analytic=analytic)
    assert read("ingest.build_s", rec) == 0.5
    assert read(f"algorithms.launches_per_query.{analytic}", rec) == 35.0
    assert read(f"algorithms.host_reads_per_query.{analytic}", rec) == 20.0
    assert read(f"device.idle_pct.{analytic}", rec) == pytest.approx(25.0)
    assert read(f"kernels.{analytic}_roofline", rec) == pytest.approx(10.0)
    untraced = dict(rec, profile=None)
    for name in (f"algorithms.launches_per_query.{analytic}",
                 f"algorithms.host_reads_per_query.{analytic}", f"device.idle_pct.{analytic}",
                 f"kernels.{analytic}_roofline"):
        assert read(name, untraced) is None
    idle = dict(rec, profile=dict(RECORD["profile"], busy_s=0.0))
    assert read(f"device.idle_pct.{analytic}", idle) is None  # nothing ran: no share
    assert read(f"kernels.{analytic}_roofline", idle) is None


def event(start, end, name, device):
    return types.SimpleNamespace(
        time_range=types.SimpleNamespace(start=start, end=end), name=name,
        device_type=DeviceType.CUDA if device else DeviceType.CPU)


def test_busy_union_and_gaps():
    assert timing.busy_union([(0, 10), (5, 15), (20, 30)]) == 25
    device = [(0, 10), (5, 15), (20, 30), (40, 41)]
    host = [(0, 100, "query"), (16, 19, "aten::nonzero"), (31, 33, "aten::item")]
    gaps = timing.idle_gaps(device, host)
    # 15-20: nonzero at 17.5; 30-40: the query alone at 35
    assert gaps == {"aten::nonzero": 5e-6, "query": 10e-6}
    assert timing.idle_gaps([(0, 1), (3, 4)], []) == {"python": 2e-6}


def test_read_profile():
    events = [
        event(0, 1_000_000, "query", False),
        event(10, 20, timing.HOST_READ_OP, False),
        event(30, 40, timing.HOST_READ_OP, False),
        event(0, 400_000, "spmv", True),
        event(500_000, 600_000, "spmv", True),
        event(600_000, 700_000, "fill", True),
    ]
    prof = types.SimpleNamespace(events=lambda: events)
    p = timing.read_profile(prof, 1.0)
    assert p["busy_s"] == pytest.approx(0.6) and p["launches"] == 3 and p["host_reads"] == 2
    assert p["device_ops"] == [["spmv", 0.5], ["fill", 0.1]]
    assert p["idle_gaps"] == [["query", 0.1]]
    assert math.isclose(p["wall_s"], 1.0)


def test_bound():
    assert timing.bound_s(3.35e12) == 1.0
