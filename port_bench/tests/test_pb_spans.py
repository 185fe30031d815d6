"""The reading of the program's spans (``spans.py``) on made-up profiler
events, the readers of the metrics that take them from a run's record, and
a traced run on the CPU that records them."""

import json
import math
import sys
import time
import types

import pytest
import torch
from pb_helpers import BENCH, SEED
from test_pb_metrics import RECORD, event

from port_bench import harness, spans, timing

# two BFS calls, in microseconds: the first with a dense and a sparse level
# and reads between them, the second with one dense level; a kernel span
# outside any call
SPANS = [
    (0, 100, "cgt/algorithms.bfs"),
    (5, 10, "cgt/sync.bfs.frontier_any"),
    (10, 40, "cgt/step.bfs.dense"),
    (15, 25, "cgt/kernel.spmv_minplus"),
    (45, 50, "cgt/sync.bfs.frontier_any"),
    (50, 90, "cgt/step.bfs.sparse"),
    (55, 60, "cgt/sync.bfs.frontier_ids"),
    (70, 80, "cgt/sync.bfs.unvisited"),
    (120, 160, "cgt/algorithms.bfs"),
    (125, 150, "cgt/step.bfs.dense"),
    (170, 180, "cgt/kernel.spmv_sum"),
]
# busy 0-12, 20-30, 35-56, 58-72, 95-130, 140-145, 155-175; idle between
DEVICE = [(0, 12), (20, 30), (35, 56), (58, 72), (95, 130), (140, 145), (155, 175)]
READS = [7, 47, 130, 200]  # two in sync spans, two in none


def test_partition_nests_and_cuts_children_at_their_parent():
    pieces = spans.partition([(0, 10, "cgt/algorithms.x"), (2, 12, "cgt/step.x.a"),
                              (20, 30, "cgt/kernel.k")])
    assert pieces == [(0, 2, "cgt/algorithms.x", spans.IN_CALLS),
                      (2, 10, "cgt/step.x.a", spans.IN_STEPS),
                      (20, 30, "cgt/kernel.k", spans.OUTSIDE_CALLS)]
    # a sync inside a step stays in the step's part; one beside it in the call's
    pieces = spans.partition(SPANS)
    assert (55, 60, "cgt/sync.bfs.frontier_ids", spans.IN_STEPS) in pieces
    assert (45, 50, "cgt/sync.bfs.frontier_any", spans.IN_CALLS) in pieces
    assert all(a[1] <= b[0] for a, b in zip(pieces, pieces[1:]))


def test_idle_split_is_exact():
    host = [(s, e, n) for s, e, n in SPANS]
    total = sum(timing.idle_gaps(DEVICE, host).values())
    rec = spans.summarize(DEVICE, SPANS, {timing.HOST_READ_OP: READS})
    idle = rec["idle_s"]
    assert math.isclose(sum(idle.values()), total, abs_tol=1e-9)
    # gaps 12-20 (dense step 12-15, its kernel span 15-20), 30-35 (step),
    # 56-58 (a read in the sparse step), 72-95 (the step's read 72-80 and
    # the step 80-90, the call 90-95), 130-140 (step), 145-155 (step
    # 145-150, call 150-155)
    assert idle["in_steps"] == pytest.approx((8 + 5 + 2 + 18 + 10 + 5) / 1e6)
    assert idle["in_calls"] == pytest.approx((5 + 5) / 1e6)
    assert idle["outside_calls"] == 0
    by_span = dict(rec["idle_by_span"])
    assert by_span["cgt/kernel.spmv_minplus"] == pytest.approx(5e-6)
    assert by_span["cgt/sync.bfs.frontier_ids"] == pytest.approx(2e-6)
    assert by_span["cgt/sync.bfs.unvisited"] == pytest.approx(8e-6)
    assert by_span["cgt/step.bfs.sparse"] == pytest.approx(10e-6)
    assert rec["counts"]["cgt/algorithms.bfs"] == 2
    assert rec["counts"]["cgt/step.bfs.dense"] == 2
    assert rec["host_s"]["cgt/algorithms.bfs"] == pytest.approx(140e-6)
    assert rec["syncs_with_host_read"] == 2
    assert rec["outside_syncs"] == {timing.HOST_READ_OP: 2, "aten::nonzero": 0,
                                    "cudaStreamSynchronize": 0}
    waits = {"aten::nonzero": [57, 75, 110], "cudaStreamSynchronize": [7, 190]}
    assert spans.summarize(DEVICE, SPANS, waits)["outside_syncs"] == {
        timing.HOST_READ_OP: 0, "aten::nonzero": 1, "cudaStreamSynchronize": 1}


def test_a_program_without_spans_reads_as_no_spans():
    rec = spans.summarize(DEVICE, [], {timing.HOST_READ_OP: READS})
    assert rec["counts"] == {} and rec["idle_s"]["in_steps"] == 0
    total = sum(timing.idle_gaps(DEVICE, []).values())
    assert math.isclose(rec["idle_s"]["outside_calls"], total, abs_tol=1e-9)
    assert rec["idle_by_span"] == [["none", pytest.approx(total)]]


def test_read_spans_takes_the_profilers_events():
    events = ([event(s, e, n, False) for s, e, n in SPANS]
              + [event(s, e, "kernel", True) for s, e in DEVICE]
              + [event(t, t + 1, timing.HOST_READ_OP, False) for t in READS]
              + [event(57, 58, "aten::nonzero", False), event(0, 1, "aten::index", False)])
    prof = type("Prof", (), {"events": lambda self: events})()
    rec = spans.read_spans(prof)
    waits = {timing.HOST_READ_OP: READS, "aten::nonzero": [57]}
    assert rec == spans.summarize(DEVICE, SPANS, waits, (0, 201))
    assert rec["idle_edges_s"] == pytest.approx([0.0, 26e-6])


def test_the_split_and_the_edges_make_the_windows_idle_time():
    window = (-10, 200)
    rec = spans.summarize(DEVICE, SPANS, window=window)
    assert rec["idle_edges_s"] == pytest.approx([10e-6, 25e-6])
    busy = timing.busy_union(DEVICE)
    idle = sum(rec["idle_s"].values()) + sum(rec["idle_edges_s"])
    assert math.isclose(idle, (window[1] - window[0] - busy) / 1e6, abs_tol=1e-12)
    no_window = spans.summarize(DEVICE, SPANS, {timing.HOST_READ_OP: READS})
    assert no_window["idle_edges_s"] == [0.0, 0.0]


def test_span_readers_on_a_record():
    summary = spans.summarize(DEVICE, SPANS, {timing.HOST_READ_OP: READS})
    setup = [
        dict(name="cgt/setup.import", parent=None, host_s=2.5, device_s=None),
        dict(name="cgt/ingest.symmetrize", parent=None, host_s=0.1, device_s=0.3),
        dict(name="cgt/ingest.compress", parent=None, host_s=0.05, device_s=0.2),
        dict(name="cgt/ingest.compress", parent=None, host_s=0.05, device_s=0.25),
    ]
    rec = dict(RECORD, analytic="bfs", spans=summary, setup_spans=setup,
               profile=dict(RECORD["profile"], busy_s=1.0))

    def read(name, r=rec):
        return harness.metric_reader(BENCH, name, r["analytic"])(r)

    assert read("algorithms.idle_ms_per_step.bfs") == pytest.approx(
        1e3 * summary["idle_s"]["in_steps"] / 3)
    assert read("algorithms.syncs_per_query.bfs") == 2.0
    assert read("algorithms.dense_levels_per_query.bfs") == 1.0
    assert read("algorithms.sparse_levels_per_query.bfs") == 0.5
    assert read("ingest.symmetrize_s") == 0.3
    assert read("ingest.compress_s") == 0.25  # the newest graph's
    assert read("setup.port_import_s") == 2.5
    # another analytic's calls and steps are not this one's; no device, no idle
    other = dict(rec, analytic="pagerank")
    assert read("algorithms.idle_ms_per_step.pagerank", other) is None
    assert spans.per_query(other, spans.SYNC) is None
    assert read("algorithms.idle_ms_per_step.bfs",
                dict(rec, profile=dict(rec["profile"], busy_s=0.0))) is None
    # untraced: nothing to read
    untraced = dict(RECORD, analytic="bfs", profile=None, spans=None, setup_spans=None)
    for name in ("algorithms.idle_ms_per_step.bfs", "algorithms.syncs_per_query.bfs",
                 "algorithms.dense_levels_per_query.bfs", "setup.port_import_s",
                 "ingest.compress_s"):
        assert read(name, untraced) is None


@pytest.mark.parametrize("name", ["ingest.symmetrize_s", "ingest.compress_s"])
def test_the_ingest_readers_read_the_programs_set_up_spans(name):
    path = harness.reader_path(BENCH, name, "bfs")
    assert path == BENCH / "metrics" / f"{name}.py"
    read = harness.metric_reader(BENCH, name, "bfs")
    span = "cgt/" + name[:-2]
    rec = dict(RECORD, setup_spans=[dict(name=span, parent=None, host_s=0.1, device_s=0.5),
                                    dict(name=span, parent=None, host_s=0.1, device_s=0.25)])
    assert read(rec) == 0.25
    # a program older than the spans, and a span with no device time (the CPU)
    assert read(dict(RECORD, setup_spans=None)) is None
    assert read(dict(RECORD, setup_spans=[dict(name=span, parent=None, host_s=0.1,
                                               device_s=None)])) is None
    # a program that keeps set-up spans but not this one
    with pytest.raises(LookupError, match=span):
        read(dict(RECORD, setup_spans=[dict(name="cgt/ingest.validate", parent=None,
                                            host_s=0.1, device_s=0.5)]))


def test_program_setup_spans(monkeypatch):
    fake = types.SimpleNamespace(setup_spans=lambda: [dict(name="cgt/setup.import")])
    monkeypatch.setitem(sys.modules, "cugraph_tpu_torch.utils.timer", fake)
    assert spans.program_setup_spans() == [dict(name="cgt/setup.import")]
    monkeypatch.setitem(sys.modules, "cugraph_tpu_torch.utils.timer", types.SimpleNamespace())
    assert spans.program_setup_spans() is None
    monkeypatch.setitem(sys.modules, "cugraph_tpu_torch.utils.timer", None)
    with pytest.raises(ImportError):
        spans.program_setup_spans()


def test_a_traced_run_records_the_spans(tiny_root):
    """A traced BFS run on the CPU: the record's spans count every call,
    every host read of the window lies in one read span, and the span
    metrics are in the result line."""
    seen = {}
    read_trace = harness.read_trace

    def keep(win, log):
        seen.update(read_trace(win, log))
        return seen

    harness.read_trace = keep
    try:
        logged = []
        out = harness.run_cell(tiny_root, "kron24.bfs", SEED, 0.3, True, torch.device("cpu"),
                               time.perf_counter(), log=logged.append)
    finally:
        harness.read_trace = read_trace
    assert out["correct"] is True
    summary = seen["spans"]
    calls = summary["counts"]["cgt/algorithms.bfs"]
    assert calls == out["attempted"]
    assert set(summary["outside_syncs"].values()) == {0}
    assert summary["syncs_with_host_read"] == out["metrics"][
        "algorithms.host_reads_per_query.bfs"]["value"] * calls
    m = out["metrics"]
    assert m["algorithms.dense_levels_per_query.bfs"]["value"] > 0
    assert m["algorithms.syncs_per_query.bfs"]["value"] > 0
    assert m["setup.port_import_s"]["value"] > 0
    assert "algorithms.idle_ms_per_step.bfs" not in m  # the CPU has no device time
    assert {"cgt/ingest.validate", "cgt/ingest.symmetrize", "cgt/ingest.compress"} <= {
        s["name"] for s in seen["setup_spans"]}
    line = [msg for msg in logged if msg.startswith("spans: ")]
    assert len(line) == 1 and json.loads(line[0][len("spans: "):])["counts"] == summary["counts"]
