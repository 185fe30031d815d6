"""The port's three repaired faults, each against the JAX package.

1. Gradients through the aggregation: ``spmm_aggregate`` above the dense
   branch (V > 8192) backpropagates through ``SpmmRowsFunction`` (its
   backward is ``spmm_rows`` over the CSR). dX equals ``jax.grad`` of the
   JAX ``spmm_aggregate`` on the CPU (exact f32 in both: relative 1e-5 of
   max |dX|) and autograd through the plain version; the MG aggregation,
   which has no backward yet, raises instead of losing the gradient.
2. ``bfs`` above MAX_VERTICES (lowered with monkeypatch) runs every level
   as the compacted push and equals the JAX ``bfs``, distances and
   predecessors.
3. The JAX names' parameters: ``bfs``'s positional ``direction_optimizing``,
   ``rmat_edgelist``'s ``clip_and_flip``, the per_v prims' ``init``, and the
   ``prims`` exports.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cugraph_tpu as cg
import cugraph_tpu_torch as ct
from cugraph_tpu import prims as jprims
from cugraph_tpu.generators.rmat import rmat_edgelist as jax_rmat
from cugraph_tpu.gnn import spmm_aggregate as jax_aggregate
from cugraph_tpu_torch import prims as tprims
from cugraph_tpu_torch.algos import traversal
from cugraph_tpu_torch.dist import mg_prims
from cugraph_tpu_torch.generators.rmat import scramble_vertex_ids
from cugraph_tpu_torch.gnn import SAGEConv, spmm_aggregate
from cugraph_tpu_torch.prims.cuda import SpmmRowsFunction, spmm_rows, spmm_rows_reference

TOL_GRAD_REL = 1e-5


def _graph_np(seed, v=9000, e=40000, weighted=False):
    rng = np.random.default_rng(seed)
    src = (rng.zipf(1.5, e) % v).astype(np.int32)  # hub sources
    dst = (rng.zipf(1.3, e) % v).astype(np.int32)  # heavy destinations
    w = rng.random(e).astype(np.float32) + 0.5 if weighted else None
    return src, dst, w, v


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


@pytest.mark.parametrize("op,weighted", [("mean", False), ("sum", False), ("sum", True)])
def test_spmm_aggregate_gradient_matches_jax(op, weighted):
    src, dst, w, v = _graph_np(op == "mean", weighted=weighted)
    f = 16
    rng = np.random.default_rng(1)
    x = rng.normal(size=(v, f)).astype(np.float32)
    r = rng.normal(size=(v, f)).astype(np.float32)  # dL/dY of L = sum(Y * r)
    jg = cg.from_edgelist(src, dst, w, num_vertices=v)

    def loss(xj):
        return jnp.sum(jax_aggregate(jg, xj, op=op, use_weights=weighted) * r)

    want = np.asarray(jax.grad(loss)(jnp.asarray(x)))
    tg = ct.from_edgelist(src, dst, w, num_vertices=v, device="cpu")
    xt = torch.from_numpy(x).requires_grad_()
    y = spmm_aggregate(tg, xt, op=op, use_weights=weighted)
    (y * torch.from_numpy(r)).sum().backward()
    got = xt.grad.numpy()
    assert y.grad_fn is not None and np.isfinite(got).all()
    assert _rel(got, want) < TOL_GRAD_REL
    # and against autograd through the plain version itself
    xr = torch.from_numpy(x).requires_grad_()
    yr = spmm_rows_reference(tg.csc(), xr, use_weights=weighted)
    if op == "mean":
        yr = yr / tg.in_degrees().clamp(min=1)[:, None]
    (yr * torch.from_numpy(r)).sum().backward()
    assert _rel(got, xr.grad.numpy()) < TOL_GRAD_REL


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_spmm_rows_function_backward_is_the_transposed_product(precision):
    """SpmmRowsFunction's backward is spmm_rows over the CSR, in the mode
    of the forward: on the CPU it equals the plain version over the CSR of
    the incoming gradient, bit for bit."""
    src, dst, w, v = _graph_np(2, v=500, e=3000, weighted=True)
    tg = ct.from_edgelist(src, dst, w, num_vertices=v, device="cpu")
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(v, 8)).astype(np.float32)).requires_grad_()
    dy = torch.from_numpy(rng.normal(size=(v, 8)).astype(np.float32))
    y = SpmmRowsFunction.apply(x, tg.csc(), tg.csr(), precision, True)
    torch.testing.assert_close(y, spmm_rows(tg.csc(), x.detach(), precision=precision),
                               rtol=0, atol=0)
    y.backward(dy)
    torch.testing.assert_close(x.grad, spmm_rows_reference(tg.csr(), dy, precision=precision),
                               rtol=0, atol=0)


def test_sage_conv_backpropagates_through_the_neighbour_term():
    """dL/dx of a SAGEConv above the dense branch equals autograd of the
    same layer written over the plain version."""
    src, dst, _, v = _graph_np(3)
    tg = ct.from_edgelist(src, dst, num_vertices=v, device="cpu")
    torch.manual_seed(0)
    conv = SAGEConv(8, 4, device="cpu")
    x = torch.randn(v, 8)
    xg = x.clone().requires_grad_()
    conv(tg, xg).square().sum().backward()
    xr = x.clone().requires_grad_()
    nbr = spmm_rows_reference(tg.csc(), xr) / tg.in_degrees().clamp(min=1)[:, None]
    (conv.lin_self(xr) + conv.lin_nbr(nbr)).square().sum().backward()
    assert _rel(xg.grad.numpy(), xr.grad.numpy()) < TOL_GRAD_REL


def test_gradient_needs_the_csr():
    src, dst, _, v = _graph_np(4)
    csc_only = ct.from_edgelist(src, dst, num_vertices=v, store="in", device="cpu")
    x = torch.randn(v, 4)
    spmm_aggregate(csc_only, x)  # no gradient asked: fine
    with torch.no_grad():
        spmm_aggregate(csc_only, x.clone().requires_grad_())
    with pytest.raises(ct.utils.GraphError):
        spmm_aggregate(csc_only, x.clone().requires_grad_())


def test_mg_spmm_raises_on_a_gradient():
    feats = torch.randn(6, 4, requires_grad=True)
    with pytest.raises(NotImplementedError, match="no backward"):
        mg_prims.per_v_incoming_sorted_spmm(None, None, feats)


def _karate():
    import networkx as nx

    g = nx.karate_club_graph()
    e = np.array(g.edges(), dtype=np.int32)
    src = np.concatenate([e[:, 0], e[:, 1]])
    dst = np.concatenate([e[:, 1], e[:, 0]])
    return src, dst, g.number_of_nodes()


def _random_directed(seed, v=3000, e=12000):
    rng = np.random.default_rng(seed)
    return (rng.zipf(1.6, e) % v).astype(np.int32), rng.integers(0, v, e).astype(np.int32), v


@pytest.mark.parametrize("graph", ["karate", "random"])
@pytest.mark.parametrize("sources", [[0], [3, 17]])
def test_bfs_above_max_vertices_matches_jax(graph, sources, monkeypatch):
    src, dst, v = _karate() if graph == "karate" else _random_directed(5)
    want_d, want_p = cg.bfs(cg.from_edgelist(src, dst, num_vertices=v), np.array(sources))
    tg = ct.from_edgelist(src, dst, num_vertices=v, device="cpu")
    minplus = []
    monkeypatch.setattr(traversal, "spmv_minplus", lambda *a, **k: minplus.append(1))
    monkeypatch.setattr(traversal, "MAX_VERTICES", v - 1)
    got_d, got_p = ct.bfs(tg, sources)
    assert minplus == []  # every level took the compacted push
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    got_d, _ = ct.bfs(tg, sources, 2)
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(cg.bfs(
        cg.from_edgelist(src, dst, num_vertices=v), np.array(sources), 2)[0]))


def test_ego_graph_above_max_vertices(monkeypatch):
    src, dst, v = _karate()
    tg = ct.from_edgelist(src, dst, num_vertices=v, symmetrize=True, device="cpu")
    want_sub, want_map = ct.ego_graph(tg, 0, 2)
    monkeypatch.setattr(traversal, "MAX_VERTICES", 8)
    sub, vmap = ct.ego_graph(tg, 0, 2)
    assert torch.equal(vmap, want_map) and sub.num_edges == want_sub.num_edges


def test_bfs_positional_direction_optimizing_matches_jax():
    src, dst, v = _random_directed(6)
    jg = cg.from_edgelist(src, dst, num_vertices=v)
    tg = ct.from_edgelist(src, dst, num_vertices=v, device="cpu")
    for args in ((None, False), (None, True), (3, True)):
        want_d, want_p = cg.bfs(jg, 0, *args)
        got_d, got_p = ct.bfs(tg, 0, *args)
        np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
        np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    got = ct.bfs(tg, 0, None, False, (1, 1))  # sparse_caps stays fifth
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(cg.bfs(jg, 0)[0]))


@pytest.mark.parametrize("scramble", [False, True])
def test_rmat_clip_and_flip_as_jax(scramble):
    """Both packages flip (src, dst) where src < dst, before the scramble:
    the clipped list is (max, min) of the unclipped one, scrambled after."""
    from cugraph_tpu.generators.rmat import scramble_vertex_ids as jax_scramble

    scale, e = 8, 4000
    key = jax.random.PRNGKey(3)
    js, jd = (np.asarray(a) for a in jax_rmat(scale, e, rng_key=key))
    jcs, jcd = (np.asarray(a) for a in jax_rmat(scale, e, rng_key=key, clip_and_flip=True,
                                                scramble=scramble))
    ts, td = ct.rmat_edgelist(scale, e, generator=torch.Generator().manual_seed(3), device="cpu")
    tcs, tcd = ct.rmat_edgelist(scale, e, generator=torch.Generator().manual_seed(3),
                                clip_and_flip=True, scramble=scramble, device="cpu")
    jhi, jlo = np.maximum(js, jd), np.minimum(js, jd)
    thi, tlo = torch.maximum(ts, td), torch.minimum(ts, td)
    if scramble:
        jhi, jlo = (np.asarray(jax_scramble(jnp.asarray(a), scale)) for a in (jhi, jlo))
        thi, tlo = (scramble_vertex_ids(a, scale) for a in (thi, tlo))
    np.testing.assert_array_equal(jcs, jhi)
    np.testing.assert_array_equal(jcd, jlo)
    assert torch.equal(tcs, thi) and torch.equal(tcd, tlo)
    if not scramble:
        assert (tcs >= tcd).all() and (jcs >= jcd).all() and (tcs > tcd).any()


@pytest.mark.parametrize("direction", ["incoming", "outgoing"])
@pytest.mark.parametrize("op,init", [("PLUS", 2.5), ("MINIMUM", 0.25), ("MAXIMUM", -0.5),
                                     ("PLUS", None)])
def test_per_v_init_matches_jax(direction, op, init):
    rng = np.random.default_rng(7)
    v, e = 200, 600
    src, dst = rng.integers(0, v - 20, e), rng.integers(0, v - 20, e)  # 20 isolated
    w = rng.random(e).astype(np.float32)
    x = rng.normal(size=v).astype(np.float32)
    jg = cg.from_edgelist(src, dst, w, num_vertices=v)
    tg = ct.from_edgelist(src, dst, w, num_vertices=v, device="cpu")
    name = f"per_v_transform_reduce_{direction}_e"

    def e_op(s, d, sv, dv, wt):
        return sv * wt

    want = getattr(jprims, name)(jg, e_op, reduce_op=getattr(jprims, op), init=init,
                                 src_values=jnp.asarray(x))
    got = getattr(tprims, name)(tg, e_op, reduce_op=getattr(tprims, op), init=init,
                                src_values=torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def _exports(pkg):
    """Public names of a prims package, without its subpackages (pallas,
    cuda), which appear once some test has imported them."""
    return {n for n in dir(pkg)
            if not n.startswith("_") and not isinstance(getattr(pkg, n), types.ModuleType)}


def test_prims_exports_the_jax_names():
    want, got = _exports(jprims), _exports(tprims)
    assert want - got == set()
    for name in ("LOGICAL_OR", "update_v_frontier", "per_v_random_select_outgoing_e",
                 "transform_reduce_e", "count_if_e",
                 "transform_e", "extract_if_e", "transform_reduce_v", "reduce_v", "count_if_v",
                 "transform_reduce_e_by_src_key", "transform_reduce_e_by_dst_key",
                 "aggregate_outgoing_e_by_dst_key",
                 "per_v_transform_reduce_dst_key_aggregated_outgoing_e",
                 "per_v_pair_dst_nbr_intersection", "triangle_counts_per_vertex"):
        assert callable(getattr(tprims, name)) or name == "LOGICAL_OR"


def test_logical_or_and_update_v_frontier_as_jax():
    rng = np.random.default_rng(8)
    v, e = 60, 200
    src, dst = rng.integers(0, v - 5, e), rng.integers(0, v - 5, e)
    flag = rng.random(v) < 0.2
    jg = cg.from_edgelist(src, dst, num_vertices=v)
    tg = ct.from_edgelist(src, dst, num_vertices=v, device="cpu")

    def e_op(s, d, sv, dv, w):
        return sv

    want = jprims.per_v_transform_reduce_incoming_e(
        jg, e_op, reduce_op=jprims.LOGICAL_OR, src_values=jnp.asarray(flag))
    got = tprims.per_v_transform_reduce_incoming_e(
        tg, e_op, reduce_op=tprims.LOGICAL_OR, src_values=torch.from_numpy(flag))
    assert got.dtype == torch.bool
    # a vertex with no in-edge gets the identity, False; the JAX package
    # gives True there (its segment max over int32 leaves the int32
    # minimum, which casts to True). The port departs from it on purpose
    # (ROADMAP §3); both values are pinned, the rest compared
    has_in = tg.in_degrees().numpy() > 0
    assert (~has_in).any() and not got.numpy()[~has_in].any()
    assert np.asarray(want)[~has_in].all()
    np.testing.assert_array_equal(got.numpy()[has_in], np.asarray(want)[has_in])
    want_v = jprims.reduce_v(jg, jnp.asarray(flag), reduce_op=jprims.LOGICAL_OR)
    got_v = tprims.reduce_v(tg, torch.from_numpy(flag), reduce_op=tprims.LOGICAL_OR)
    assert bool(got_v) == bool(want_v) and got_v.dtype == torch.bool
    empty = tprims.reduce_v(tg, torch.zeros(0, dtype=torch.bool), reduce_op=tprims.LOGICAL_OR)
    assert not bool(empty)

    def v_op(touched, reduced, values):
        return touched & ~values, values | touched

    touched = torch.from_numpy(rng.random(v) < 0.3)
    jn, jv = jprims.update_v_frontier(jnp.asarray(touched.numpy()), None, jnp.asarray(flag), v_op)
    tn, tv = tprims.update_v_frontier(touched, None, torch.from_numpy(flag), v_op)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
