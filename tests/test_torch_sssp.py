"""SSSP, the frontier push prim, extract_bfs_paths and two_hop_neighbors of
cugraph_tpu_torch against cugraph_tpu on the CPU.

On the CPU the JAX package always takes its frontier branch (``_sssp_jit``:
its min-plus layout exists only on a TPU). The port's frontier branch
follows the same rules, so distances agree within rtol 1e-6 and
predecessors are equal. The port's sweep branch (weighted, E >= 2^18) is
forced on at small size by lowering its gate: its distances agree with the
JAX function, and its predecessors follow their own rule, the smallest src
among the tree edges, which may pick another parent on ties, so they are
checked against that rule and for tree validity.
"""

import numpy as np
import pytest
import torch

import cugraph_tpu as cg
import cugraph_tpu_torch as ct
from cugraph_tpu import prims as jprims
from cugraph_tpu.algos.traversal import two_hop_neighbors as jax_two_hop
from cugraph_tpu_torch import prims as tprims
from cugraph_tpu_torch.algos import traversal
from test_torch_centrality import GRAPHS, build_both

SOURCES = [0, 5, [1, 33]]


@pytest.fixture(scope="module", params=list(GRAPHS))
def graphs(request):
    return build_both(GRAPHS[request.param])


def _assert_dist_close(got, want):
    want = np.asarray(want)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(np.isinf(got.numpy()), np.isinf(want))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def _tree_edges(tg, dist, sources):
    """(src, dst, on_tree) over the CSC: dist[s] + w == dist[d], d finite
    and not a source (w = 1 unweighted)."""
    csc = tg.csc()
    s, d = csc.minors.numpy(), csc.majors.numpy()
    w = np.ones(len(s), np.float32) if csc.weights is None else csc.weights.numpy()
    is_src = np.zeros(tg.num_vertices, bool)
    is_src[np.atleast_1d(sources)] = True
    on_tree = np.isfinite(dist[d]) & (dist[s] + w == dist[d]) & ~is_src[d]
    return s, d, on_tree


def _assert_valid_tree(tg, dist, pred, sources):
    """Every reached non-source vertex has a predecessor joined to it by a
    tree edge; sources and unreached vertices have -1."""
    s, d, on_tree = _tree_edges(tg, dist, sources)
    has = np.zeros(tg.num_vertices, bool)
    has[d[on_tree & (s == pred[d])]] = True
    reached = np.isfinite(dist)
    reached[np.atleast_1d(sources)] = False
    assert np.all(has == reached)
    assert np.all(pred[~reached] == -1)


@pytest.mark.parametrize("sources", SOURCES)
def test_sssp_frontier_branch_equals_jax(graphs, sources):
    jg, tg = graphs
    jd, jp = cg.sssp(jg, sources)
    td, tp = ct.sssp(tg, sources)
    _assert_dist_close(td, jd)
    assert tp.dtype == torch.int32
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


@pytest.mark.parametrize("cutoff", [0.5, 2.0])
def test_sssp_cutoff_equals_jax(graphs, cutoff):
    jg, tg = graphs
    jd, jp = cg.sssp(jg, 0, cutoff=cutoff)
    td, tp = ct.sssp(tg, 0, cutoff=cutoff)
    _assert_dist_close(td, jd)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert np.all(td.numpy()[np.isfinite(td.numpy())] <= cutoff)


@pytest.fixture
def sweep_gate(monkeypatch):
    """Open the sweep branch at any size; count its calls."""
    calls = []
    real = traversal._sssp_sweeps
    monkeypatch.setattr(traversal, "SSSP_SWEEP_MIN_EDGES", 0)
    monkeypatch.setattr(traversal, "_sssp_sweeps", lambda *a: calls.append(1) or real(*a))
    return calls


@pytest.mark.parametrize("name", ["karate_sym_w", "rmat10w"])
@pytest.mark.parametrize("cutoff", [None, 1.5])
@pytest.mark.parametrize("sources", SOURCES)
def test_sssp_sweep_branch_matches_jax(sweep_gate, name, cutoff, sources):
    jg, tg = build_both(GRAPHS[name])
    jd, _ = cg.sssp(jg, sources, cutoff=cutoff)
    td, tp = ct.sssp(tg, sources, cutoff=cutoff)
    assert sweep_gate == [1]
    _assert_dist_close(td, jd)
    dist, pred = td.numpy(), tp.numpy()
    s, d, on_tree = _tree_edges(tg, dist, sources)
    want = np.full(tg.num_vertices, tg.num_vertices)
    np.minimum.at(want, d[on_tree], s[on_tree])
    np.testing.assert_array_equal(pred, np.where(want < tg.num_vertices, want, -1))
    _assert_valid_tree(tg, dist, pred, sources)


def test_sssp_gate_constants(sweep_gate, monkeypatch):
    """Unweighted graphs and graphs above 2^24 vertices keep the frontier
    branch; the default gate needs E >= 2^18."""
    assert (traversal.SSSP_SWEEP_MAX_VERTICES, traversal.MAX_VERTICES) == (1 << 24, 1 << 24)
    _, tg = build_both(GRAPHS["rmat10"])
    ct.sssp(tg, 0)
    _, tw = build_both(GRAPHS["rmat10w"])
    monkeypatch.setattr(traversal, "SSSP_SWEEP_MAX_VERTICES", tw.num_vertices - 1)
    ct.sssp(tw, 0)
    monkeypatch.setattr(traversal, "SSSP_SWEEP_MIN_EDGES", 1 << 18)
    monkeypatch.setattr(traversal, "SSSP_SWEEP_MAX_VERTICES", 1 << 24)
    ct.sssp(tw, 0)
    assert sweep_gate == []


@pytest.mark.parametrize("sweep", [False, True])
def test_sssp_unreachable_equals_jax(monkeypatch, sweep):
    """Vertices 4 and 5 are unreachable from 0 (5 is isolated)."""
    src = np.array([0, 1, 2, 0, 4], np.int32)
    dst = np.array([1, 2, 3, 2, 3], np.int32)
    w = np.array([0.5, 0.25, 1.0, 1.0, 0.1], np.float32)
    if sweep:
        monkeypatch.setattr(traversal, "SSSP_SWEEP_MIN_EDGES", 0)
    jd, jp = cg.sssp(cg.from_edgelist(src, dst, w, num_vertices=6), 0)
    td, tp = ct.sssp(ct.from_edgelist(src, dst, w, num_vertices=6, device="cpu"), 0)
    _assert_dist_close(td, jd)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tp.numpy(), [-1, 0, 1, 2, -1, -1])


@pytest.mark.parametrize("op", ["MINIMUM", "ANY", "PLUS"])
def test_frontier_push_equals_jax(op):
    """transform_reduce_v_frontier_outgoing_e_by_dst: touched and reduced
    payloads over the frontier's out-edges, keep masked."""
    jg, tg = build_both(GRAPHS["rmat10w"])
    rng = np.random.default_rng(3)
    frontier = rng.random(tg.num_vertices) < 0.1
    vals = rng.random(tg.num_vertices).astype(np.float32)

    def e_op(s, d, sv, dv, w):
        return sv + w < dv + 0.5, sv * w

    jt, jr = jprims.transform_reduce_v_frontier_outgoing_e_by_dst(
        jg, frontier, e_op, reduce_op=getattr(jprims, op), src_values=vals, dst_values=vals
    )
    tt, tr = tprims.transform_reduce_v_frontier_outgoing_e_by_dst(
        tg, torch.from_numpy(frontier), e_op, reduce_op=getattr(tprims, op),
        src_values=torch.from_numpy(vals), dst_values=torch.from_numpy(vals),
    )
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-6)


@pytest.mark.parametrize("algo", ["bfs", "sssp"])
def test_extract_bfs_paths_equals_jax(graphs, algo):
    jg, tg = graphs
    dist, pred = (np.array(a) for a in getattr(cg, algo)(jg, 0))
    reached = np.flatnonzero(np.isfinite(dist.astype(np.float32)) & (dist != 2**31 - 1))
    dests = reached[:: max(len(reached) // 7, 1)]
    jp, jl = cg.extract_bfs_paths(jg, dist, pred, dests)
    tp, tl = ct.extract_bfs_paths(tg, torch.from_numpy(dist), torch.from_numpy(pred), dests)
    assert tl == jl and tp.dtype == torch.int32
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tp.numpy()[:, -1], dests)


def test_two_hop_neighbors_equals_jax(graphs):
    jg, tg = graphs
    js, jd = jax_two_hop(jg)
    ts, td = traversal.two_hop_neighbors(tg)
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_array_equal(td.numpy(), jd)
