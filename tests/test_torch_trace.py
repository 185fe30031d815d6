"""The port's spans (``cugraph_tpu_torch/utils/timer.py``) on the CPU: the
shared no-op without a profiler, nesting under one, the step and read
spans of PageRank and BFS counted against what the calls did, every
blocking read of the two inside a read span, the set-up spans of ingest,
kernel loads and the import, and the Chrome trace."""

import collections
import contextlib
import inspect
import json
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import cugraph_tpu_torch as ct
from cugraph_tpu_torch.algos import link_analysis, traversal
from cugraph_tpu_torch.prims.cuda import build
from cugraph_tpu_torch.utils import timer

CPU = "cpu"
REPO = Path(__file__).resolve().parents[1]
BLOCKING_OPS = ("aten::_local_scalar_dense", "aten::nonzero")
V = 1024


def random_graph(seed=0, v=V, e=8 * V):
    gen = torch.Generator().manual_seed(seed)
    src = torch.randint(0, v, (e,), generator=gen)
    dst = torch.randint(0, v, (e,), generator=gen)
    return ct.from_edgelist(src, dst, num_vertices=v, symmetrize=True, device=CPU)


@pytest.fixture(scope="module")
def graph():
    return random_graph()


@pytest.fixture
def mixed_levels(monkeypatch):
    """Both kinds of BFS level at this size: sparse while the frontier is
    small, dense once it is not."""
    monkeypatch.setattr(traversal, "SPARSE_MIN_VERTICES", 1)
    return (400, 100)


def traced(fn):
    """(result, [(start, end, name)]) of ``fn()`` under the profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()]


def inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def named(events, prefix):
    return [e for e in events if e[2].startswith(prefix)]


def test_span_is_the_shared_no_op_without_a_profiler(fresh_setup_spans):
    assert not torch.autograd._profiler_enabled()
    first, second = timer.span("cgt/a"), timer.span("cgt/b")
    assert first is second is timer._NO_SPAN
    with first:
        with second:
            pass
    assert timer.setup_spans() == []


def test_spanned_keeps_the_function_and_marks_each_call():
    @timer.spanned("cgt/f")
    def f(x: int, *, y: int = 2) -> int:
        """doc"""
        return x + y

    assert (f.__name__, f.__doc__) == ("f", "doc")
    assert list(inspect.signature(f).parameters) == ["x", "y"]
    assert f(1) == 3
    out, events = traced(lambda: [f(1), f(2, y=5)])
    assert out == [3, 7]
    assert len(named(events, "cgt/f")) == 2


def test_nested_spans_appear_inside_their_parents():
    def body():
        with timer.span("cgt/outer"):
            with timer.span("cgt/inner"):
                return torch.ones(8).cumsum(0)

    _, events = traced(body)
    (outer,) = named(events, "cgt/outer")
    (inner,) = named(events, "cgt/inner")
    (op,) = named(events, "aten::cumsum")
    assert inside(inner, outer) and inside(op, inner)


@pytest.mark.parametrize("tol", [0.0, 1e-4])
def test_pagerank_marks_each_iteration_and_its_read(graph, tol):
    (_, iterations), events = traced(lambda: ct.pagerank(graph, max_iterations=20, tol=tol))
    assert (iterations == 20) == (tol == 0.0)
    steps = named(events, "cgt/step.pagerank.iteration")
    diffs = named(events, "cgt/sync.pagerank.diff")
    (call,) = named(events, "cgt/algorithms.pagerank")
    assert len(steps) == len(diffs) == iterations
    assert len(named(events, "cgt/kernel.spmv_sum")) == iterations
    for step in steps:
        assert inside(step, call)
        assert sum(inside(d, step) for d in diffs) == 1


def test_bfs_counts_its_dense_and_sparse_levels(graph, mixed_levels):
    (dist, _), events = traced(lambda: ct.bfs(graph, 3, sparse_caps=mixed_levels))
    reached = dist[dist != traversal.INVALID_DISTANCE]
    levels = int(reached.max()) + 1  # the last level finds nothing new
    dense = named(events, "cgt/step.bfs.dense")
    sparse = named(events, "cgt/step.bfs.sparse")
    assert dense and sparse
    assert len(dense) + len(sparse) == levels
    assert len(named(events, "cgt/sync.bfs.frontier_any")) == levels + 1
    assert len(named(events, "cgt/kernel.spmv_minplus")) == len(dense)
    for name in ("frontier_ids", "out_edge_total", "unvisited", "touched"):
        assert len(named(events, f"cgt/sync.bfs.{name}")) == len(sparse)
    (call,) = named(events, "cgt/algorithms.bfs")
    assert all(inside(s, call) for s in dense + sparse)


CALLS = {
    "pagerank": lambda g: ct.pagerank(g, max_iterations=10, tol=0.0),
    "pagerank_personalized": lambda g: ct.pagerank(
        g, personalization=([1, 5, 9], [1.0, 2.0, 3.0]), max_iterations=10, tol=1e-5),
    "bfs_mixed": lambda g: ct.bfs(g, 3, sparse_caps=(400, 100)),
    "bfs_sources": lambda g: ct.bfs(g, [3, 700, 1000], depth_limit=3,
                                    sparse_caps=(10**6, 10**6)),
}


@pytest.mark.parametrize("call", sorted(CALLS))
def test_every_blocking_read_lies_in_a_read_span(graph, mixed_levels, call):
    _, events = traced(lambda: CALLS[call](graph))
    (top,) = named(events, "cgt/algorithms.")
    syncs = named(events, "cgt/sync.")
    blocking = [e for e in events if e[2] in BLOCKING_OPS and inside(e, top)]
    assert blocking
    outside = [e for e in blocking if not any(inside(e, s) for s in syncs)]
    assert outside == []
    # and every read span holds at most one host read
    reads = [e for e in blocking if e[2] == "aten::_local_scalar_dense"]
    assert all(sum(inside(r, s) for r in reads) <= 1 for s in syncs)


def _null_span(*args, **kwargs):
    return contextlib.nullcontext()


@pytest.mark.parametrize("call", ["pagerank", "bfs_mixed"])
def test_spans_add_no_operation(graph, mixed_levels, monkeypatch, call):
    def ops():
        _, events = traced(lambda: CALLS[call](graph))
        return collections.Counter(e[2] for e in events if not e[2].startswith("cgt/"))

    with_spans = ops()
    # timer's own span is the one that the spanned functions call
    for module in (traversal, link_analysis, timer):
        monkeypatch.setattr(module, "span", _null_span)
    assert ops() == with_spans


@pytest.fixture
def fresh_setup_spans(monkeypatch):
    """An empty store of set-up spans, so that a test reads only its own."""
    monkeypatch.setattr(timer, "_setup_spans", collections.deque(maxlen=timer.SETUP_SPANS_KEPT))


def test_from_edgelist_keeps_its_set_up_spans_without_a_profiler(fresh_setup_spans):
    assert not torch.autograd._profiler_enabled()
    random_graph(seed=1, v=64, e=256)
    new = timer.setup_spans()
    assert [s["name"] for s in new] == [
        "cgt/ingest.validate", "cgt/ingest.symmetrize", "cgt/ingest.compress"]
    for s in new:
        assert s["parent"] is None and s["end_s"] >= s["start_s"]
        assert s["device_s"] is None and s["host_s"] >= 0  # no CUDA events on the CPU
    assert new[0]["end_s"] <= new[1]["start_s"] <= new[1]["end_s"] <= new[2]["start_s"]


def test_set_up_spans_stay_bounded(monkeypatch):
    monkeypatch.setattr(timer, "_setup_spans", collections.deque(maxlen=4))
    for seed in range(3):
        random_graph(seed=seed, v=32, e=64)
    assert [s["name"] for s in timer.setup_spans()] == [
        "cgt/ingest.compress", "cgt/ingest.validate", "cgt/ingest.symmetrize",
        "cgt/ingest.compress"]


def test_the_import_is_a_set_up_span():
    # in a process of its own: here the graphs of earlier tests may have
    # pushed it out of the bounded store
    code = ("import json, cugraph_tpu_torch; from cugraph_tpu_torch.utils import timer; "
            "print(json.dumps(timer.setup_spans()))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300, check=True)
    (span,) = [s for s in json.loads(proc.stdout) if s["name"] == "cgt/setup.import"]
    assert span["parent"] is None and span["device_s"] is None
    assert 0 < span["host_s"] < 600


def test_kernel_load_holds_the_nvcc_span(tmp_path, monkeypatch, fresh_setup_spans):
    fake = tmp_path / "nvcc"  # writes the file named after -o, as nvcc would
    fake.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n: > "$2"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_loaded", {})
    fns = {name: types.SimpleNamespace() for name in build.SIGNATURES["scan"]}
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: types.SimpleNamespace(**fns))
    build.load("scan")
    build.load("scan")  # loaded already: no span
    load, nvcc = timer.setup_spans()
    assert (nvcc["name"], nvcc["parent"]) == ("cgt/setup.nvcc.scan", "cgt/setup.kernel_load.scan")
    assert (load["name"], load["parent"]) == ("cgt/setup.kernel_load.scan", None)
    assert load["start_s"] <= nvcc["start_s"] and nvcc["end_s"] <= load["end_s"]


def test_profiler_trace_writes_the_spans(graph, tmp_path):
    with timer.profiler_trace(str(tmp_path / "trace")):
        ct.pagerank(graph, max_iterations=3, tol=0.0)
    (path,) = (tmp_path / "trace").iterdir()
    names = collections.Counter(e.get("name") for e in json.loads(path.read_text())["traceEvents"])
    assert names["cgt/algorithms.pagerank"] == 1
    assert names["cgt/step.pagerank.iteration"] == 3
    assert names["cgt/sync.pagerank.diff"] == 3
    assert names["cgt/kernel.spmv_sum"] == 3
