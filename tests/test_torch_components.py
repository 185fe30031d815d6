"""Components and cores of cugraph_tpu_torch against cugraph_tpu on the CPU.

WCC, SCC, core numbers (all three degree types) and k-cores must be EQUAL:
every step is an integer min, count or comparison. Graphs: karate
(symmetrized), a directed R-MAT at scale 10 with its many small
components, the same symmetrized, and a small directed graph with cycles.
"""

import networkx as nx
import numpy as np
import pytest
import torch

import cugraph_tpu as cg
import cugraph_tpu_torch as ct
from cugraph_tpu.core.convert import decompress_to_edgelist as jdecompress


def _karate():
    e = np.array(nx.karate_club_graph().edges(), dtype=np.int32)
    return e[:, 0], e[:, 1], 34


def _rmat_np(scale, edgefactor, seed):
    rng = np.random.default_rng(seed)
    e = edgefactor << scale
    src = np.zeros(e, np.int64)
    dst = np.zeros(e, np.int64)
    for _ in range(scale):
        sb = rng.random(e) < 0.38
        db = rng.random(e) < np.where(sb, 0.19 / 0.38, 0.19 / 0.76)
        src, dst = (src << 1) | sb, (dst << 1) | db
    return src.astype(np.int32), dst.astype(np.int32), 1 << scale


def _cycles():
    # 0->1->2->0, 2->3, 3->4->3, 5 alone, 6->7
    src = np.array([0, 1, 2, 2, 3, 4, 6], np.int32)
    dst = np.array([1, 2, 0, 3, 4, 3, 7], np.int32)
    return src, dst, 8


GRAPHS = {
    "karate_sym": (_karate, True),
    "rmat10_dir": (lambda: _rmat_np(10, 4, 0), False),
    "rmat10_sym": (lambda: _rmat_np(10, 4, 0), True),
    "cycles_dir": (_cycles, False),
}


@pytest.fixture(scope="module", params=list(GRAPHS))
def graphs(request):
    make, sym = GRAPHS[request.param]
    src, dst, v = make()
    return (
        cg.from_edgelist(src, dst, num_vertices=v, symmetrize=sym),
        ct.from_edgelist(src, dst, num_vertices=v, symmetrize=sym, device="cpu"),
    )


def test_wcc_equals_jax(graphs):
    jg, tg = graphs
    got = ct.weakly_connected_components(tg)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(cg.weakly_connected_components(jg)))


def test_scc_equals_jax(graphs):
    jg, tg = graphs
    got = ct.strongly_connected_components(tg)
    assert got.dtype == torch.int32 and got.device == tg.device
    np.testing.assert_array_equal(got.numpy(), np.asarray(cg.strongly_connected_components(jg)))
    # SCC labels refine WCC labels
    wcc = ct.weakly_connected_components(tg)
    assert torch.equal(wcc[got.long()], wcc)


@pytest.mark.parametrize("degree_type", ["incoming", "outgoing", "incoming_outgoing"])
def test_core_number_equals_jax(graphs, degree_type):
    jg, tg = graphs
    got = ct.core_number(tg, degree_type)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(cg.core_number(jg, degree_type)))
    assert ct.core_number.rounds >= int(got.max()) + 1


def test_core_number_rejects_unknown_degree_type(graphs):
    with pytest.raises(ct.utils.GraphError, match="degree_type"):
        ct.core_number(graphs[1], "both")


@pytest.mark.parametrize("k", [2, 4, 7])
def test_k_core_equals_jax(graphs, k):
    jg, tg = graphs
    jsub, jmap = cg.k_core(jg, k)
    tsub, tmap = ct.k_core(tg, k)
    np.testing.assert_array_equal(tmap.numpy(), np.asarray(jmap))
    assert tsub.num_vertices == jsub.num_vertices and tsub.num_edges == jsub.num_edges
    js, jd, _ = jdecompress(jsub)
    ts, td, _ = ct.core.decompress_to_edgelist(tsub)
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_array_equal(td.numpy(), jd)
