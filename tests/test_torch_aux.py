"""Aux subsystems of cugraph_tpu_torch against cugraph_tpu on the CPU:
the expensive checks and their wiring into ingest, and
serialization (round trip, file, garbage), mirroring tests/test_aux.py;
besides, blobs cross between the packages both ways and give the same
graph (equal CSR and CSC arrays), ``broadcast_graph`` gives each of two
gloo ranks its blocks, and the profiler writes a Chrome trace.
"""

import importlib
import io
import json

import numpy as np
import pytest
import torch

import _torch_dist_worker as worker
import cugraph_tpu as cg
from cugraph_tpu.core import serialize as jser

import cugraph_tpu_torch as ct
from cugraph_tpu_torch.core.serialize import (
    MAGIC,
    deserialize_graph,
    load_graph,
    save_graph,
    serialize_graph,
)
from cugraph_tpu_torch.testing import karate_edgelist
from cugraph_tpu_torch.utils import validation
from cugraph_tpu_torch.utils.error import GraphError
from cugraph_tpu_torch.utils.timer import profiler_trace

CPU = "cpu"


def test_profiler_trace_writes_chrome_trace(tmp_path):
    with profiler_trace(str(tmp_path / "trace")):
        torch.ones(64).cumsum(0)
    (path,) = (tmp_path / "trace").iterdir()
    assert path.suffix == ".json"
    events = json.loads(path.read_text())["traceEvents"]
    assert any("cumsum" in e.get("name", "") for e in events)


@pytest.fixture
def checks_on():
    validation.set_expensive_checks(True)
    try:
        yield
    finally:
        validation.set_expensive_checks(False)


@pytest.mark.parametrize("as_tensors", [False, True])
def test_expensive_checks(checks_on, as_tensors):
    conv = torch.tensor if as_tensors else np.array
    with pytest.raises(GraphError, match="src vertex id out of range"):
        validation.check_edgelist(conv([0, 5]), conv([1, 2]), None, num_vertices=3)
    with pytest.raises(GraphError, match="negative dst"):
        validation.check_edgelist(conv([0, 1]), conv([1, -2]), None, num_vertices=3)
    with pytest.raises(GraphError, match="non-finite edge weight"):
        validation.check_edgelist(conv([0]), conv([1]), conv([np.nan]), num_vertices=2)
    validation.check_edgelist(conv([0]), conv([1]), conv([1.0]), num_vertices=2)
    validation.check_edgelist(conv([]), conv([]), None, num_vertices=0)
    with pytest.raises(GraphError):
        validation.check_vertex_values(np.zeros(3), 4)
    with pytest.raises(GraphError, match="non-finite"):
        validation.check_vertex_values(conv([0.0, np.inf]), 2)
    validation.check_vertex_values(conv([1, 2]), 2)


def test_expensive_checks_off_by_default():
    assert not validation.expensive_checks_enabled()
    validation.check_edgelist(np.array([0, 99]), np.array([1, 2]), None, 3)
    validation.check_vertex_values(np.zeros(3), 4)


def test_expensive_checks_env_switch(monkeypatch):
    """The JAX package's switch, read when the module loads."""
    try:
        monkeypatch.setenv("CUGRAPH_TPU_EXPENSIVE_CHECKS", "1")
        assert importlib.reload(validation).expensive_checks_enabled()
    finally:
        monkeypatch.delenv("CUGRAPH_TPU_EXPENSIVE_CHECKS")
        assert not importlib.reload(validation).expensive_checks_enabled()


def test_expensive_checks_wired_into_ingest(checks_on):
    with pytest.raises(GraphError):
        ct.from_edgelist(np.array([0, 9]), np.array([1, 2]), num_vertices=3, device=CPU)
    with pytest.raises(GraphError, match="non-finite edge weight"):
        ct.from_edgelist([0, 1], [1, 2], [1.0, np.nan], device=CPU)


def test_nan_weights_pass_ingest_with_checks_off():
    g = ct.from_edgelist([0, 1], [1, 2], [1.0, np.nan], device=CPU)
    assert g.num_edges == 2


def _same_graph(a, b):
    """Two graphs (either package) with equal CSR and CSC arrays."""
    assert (a.num_vertices, a.num_edges, a.is_symmetric) == (b.num_vertices, b.num_edges,
                                                              b.is_symmetric)
    for adj_a, adj_b in ((a.csr(), b.csr()), (a.csc(), b.csc())):
        e = adj_a.num_edges
        for name in ("offsets", "majors", "minors", "weights"):
            x, y = getattr(adj_a, name), getattr(adj_b, name)
            assert (x is None) == (y is None)
            if x is not None:
                n = adj_a.num_majors + 1 if name == "offsets" else e
                np.testing.assert_array_equal(np.asarray(x)[:n], np.asarray(y)[:n])


def test_serialize_roundtrip():
    src, dst, w = karate_edgelist()
    g = ct.from_edgelist(src, dst, w, symmetrize=True, device=CPU)
    blob = serialize_graph(g)
    g2 = deserialize_graph(blob, device=CPU)
    assert g2.num_vertices == g.num_vertices
    assert g2.num_edges == g.num_edges
    assert g2.is_symmetric == g.is_symmetric
    _same_graph(g, g2)
    pr1, _ = ct.pagerank(g, tol=1e-8)
    pr2, _ = ct.pagerank(g2, tol=1e-8)
    assert torch.equal(pr1, pr2)
    g3 = deserialize_graph(io.BytesIO(blob), device=CPU)
    _same_graph(g, g3)


def test_serialize_file(tmp_path):
    src, dst, w = karate_edgelist()
    g = ct.from_edgelist(src, dst, w, device=CPU)
    path = str(tmp_path / "g.cgt")
    save_graph(g, path)
    g2 = load_graph(path, device=CPU)
    assert g2.num_edges == g.num_edges
    _same_graph(g, g2)


def test_serialize_rejects_garbage():
    with pytest.raises(Exception):
        deserialize_graph(b"not a graph", device=CPU)
    buf = io.BytesIO()
    np.savez_compressed(buf, magic=np.frombuffer(b"other", np.uint8))
    with pytest.raises(GraphError, match="not a cugraph_tpu graph blob"):
        deserialize_graph(buf.getvalue(), device=CPU)


def _graphs(weighted, symmetric):
    rng = np.random.default_rng(5)
    src, dst = rng.integers(0, 60, 400), rng.integers(0, 60, 400)
    w = rng.random(400).astype(np.float32) if weighted else None
    kw = dict(num_vertices=64, symmetrize=symmetric)
    return cg.from_edgelist(src, dst, w, **kw), ct.from_edgelist(src, dst, w, device=CPU, **kw)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("symmetric", [False, True])
def test_blobs_cross_packages(weighted, symmetric):
    jg, tg = _graphs(weighted, symmetric)
    assert MAGIC == jser.MAGIC
    jblob, tblob = jser.serialize_graph(jg), serialize_graph(tg)
    _same_graph(tg, deserialize_graph(jblob, device=CPU))  # JAX blob -> port
    _same_graph(jg, jser.deserialize_graph(tblob))  # port blob -> JAX
    with np.load(io.BytesIO(jblob)) as a, np.load(io.BytesIO(tblob)) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_broadcast_graph_on_two_gloo_ranks():
    """broadcast_graph of a loaded blob gives each rank of a (2, 1) mesh the
    blocks that distribute_graph gives it from the graph itself."""
    results = worker.spawn(worker.run_broadcast_graph, 2)
    assert [r["shape"] for r in results] == [(2, 1)] * 2
    assert all(r["same"] for r in results)
    assert sum(r["edges"] for r in results) == 300
