"""cugraph_tpu_torch.dist against cugraph_tpu.dist on the same meshes.

The port's ranks run in spawned processes over gloo on the CPU
(``_torch_dist_worker.py``, which imports no JAX): one spawn per mesh
shape runs every entry point on two graphs and returns each rank's shards
and the unsharded arrays. The JAX package runs the same graphs on a mesh
of the same shape over its 8 virtual CPU devices (conftest.py).

Graphs: karate, symmetrized, with weights in [0.5, 1.5); and a directed
R-MAT edge list at scale 9 (multi-edges kept). Tolerances:

- partition math, blocks, degrees, BFS distances and predecessors: equal
  (predecessors are the smallest frontier in-neighbour in both packages);
- out-weight sums: rtol 1e-6 (f32 sums in another order);
- PageRank: 1e-6 absolute, as the JAX package's MG == SG tests;
- ``mg_spmm_aggregate`` sum and mean: the port rounds the operands to bf16
  and sums in f32 (the contract of the JAX kernel branch), so it is held
  within 2e-2 of the JAX package's f32 XLA branch (the JAX package's own
  tolerance between its two branches, test_dist_extra.py), within
  sum |x| * 2^-8 of float64 for each entry (bf16's relative rounding,
  2^-8, on each operand), and within 1e-5 of the single-device port's
  bf16 ``spmm_rows_reference`` (f32 summation order only); max is exact;
- ``mg_sage_forward``: within 2e-2 of the JAX package's on the same
  carried parameters (bf16 aggregation against f32).
- the MG aggregation's backward (``MGSpmmFunction``): dX for an integer
  dY in {-1, 0, 1} equal to autograd through the global bf16
  ``spmm_rows_reference`` (every sum an integer under 256, exact in f32
  and bf16); for a normal dY, within 1e-5 of each row's sum of |terms|
  of the global bf16 product over the CSR, and within 2^-7 + 1e-5 of
  autograd through the plain version (autograd rounds the summed row to
  bf16, the kernel each term of dY);
- ``make_sage_train_step``, two steps: each step's update p_new - p_old
  within (2^-7 + 1e-5) of lr * max |g| of the JAX package's update, leaf
  by leaf (its XLA branch is f32, the port follows the bf16 contract:
  2^-8 on each aggregation operand), the loss within 2e-2 of JAX's; loss
  and parameters within 1e-5 of the port's own 1 x 1 run;
- ``mg_sssp``: distances equal to the JAX package's, predecessors to the
  single-device sweep's rule (the smallest src among the tree edges);
- Katz, eigenvector and HITS: within 1e-5 of the JAX package's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_worker as worker
import cugraph_tpu as cg
import cugraph_tpu_torch as ct
from cugraph_tpu.dist import Partition2D as JaxPartition2D
from cugraph_tpu.dist import distribute_graph as jax_distribute_graph
from cugraph_tpu.dist import make_mesh as jax_make_mesh
from cugraph_tpu.dist import mesh_shape_for as jax_mesh_shape_for
from cugraph_tpu.dist import mg_algos as jax_mg_algos
from cugraph_tpu.dist import mg_gnn as jax_mg_gnn
from cugraph_tpu.dist.mg_graph import distribute_edgelist_chunks as jax_distribute_chunks
from cugraph_tpu.dist.mg_graph import shard_vertex_values as jax_shard
from cugraph_tpu.dist.mg_graph import unshard_vertex_values as jax_unshard
from cugraph_tpu.testing import karate_edgelist
from cugraph_tpu_torch.dist import Partition2D, mesh_shape_for
from cugraph_tpu_torch.gnn import spmm_aggregate
from cugraph_tpu_torch.prims.cuda import spmm_rows_reference

SHAPES = [(1, 1), (2, 1), (1, 2), (2, 2)]
TRAIN_SHAPES = [(1, 1), (2, 1), (1, 2)]
GRAPHS = ["karate", "rmat"]
F, HIDDEN, OUT = 16, 16, 8
BF16_REL = 2.0 ** -8  # bf16's largest relative rounding error

shapes = pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
train_shapes = pytest.mark.parametrize("shape", TRAIN_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
graphs = pytest.mark.parametrize("graph", GRAPHS)


def _rmat_np(scale, num_edges, seed):
    rng = np.random.default_rng(seed)
    src = np.zeros(num_edges, np.int64)
    dst = np.zeros(num_edges, np.int64)
    for _ in range(scale):
        sb = rng.random(num_edges) < 0.38
        db = rng.random(num_edges) < np.where(sb, 0.19 / 0.38, 0.19 / 0.76)
        src, dst = (src << 1) | sb, (dst << 1) | db
    return src.astype(np.int32), dst.astype(np.int32), 1 << scale


@functools.lru_cache(maxsize=None)
def _cases():
    rng = np.random.default_rng(21)
    ks, kd, _ = karate_edgelist()
    rs, rd, rv = _rmat_np(9, 4096, 9)
    cases = {
        "karate": dict(src=ks, dst=kd, w=(0.5 + rng.random(len(ks))).astype(np.float32),
                       num_vertices=34, symmetrize=True, sources=[0], chunks=None),
        "rmat": dict(src=rs, dst=rd, w=None, num_vertices=rv, symmetrize=False,
                     sources=[0, 5],
                     chunks=[(rs[:1500], rd[:1500], None), (rs[1500:], rd[1500:], None)]),
    }
    for i, c in enumerate(cases.values()):
        v = c["num_vertices"]
        c["personalization"] = ([0, 3, 7], [1.0, 2.0, 0.5])
        c["nstart"] = (0.1 + rng.random(v)).astype(np.float32)
        c["feats"] = rng.random((v, F)).astype(np.float32)
        params = jax_mg_gnn.init_sage_params(jax.random.PRNGKey(i), F, HIDDEN, OUT)
        c["params"] = {k: np.asarray(a) for k, a in params.items()}
        c["dy_int"] = rng.integers(-1, 2, (v, F)).astype(np.float32)
        c["dy_float"] = rng.normal(size=(v, F)).astype(np.float32)
        c["targets"] = rng.random((v, OUT)).astype(np.float32)
        c["katz_alpha"] = 0.05 if c["w"] is None else 0.02
    return cases


@functools.lru_cache(maxsize=None)
def _port(shape):
    """Per-rank results of the port on one mesh shape (one spawn)."""
    return worker.spawn(worker.run_mesh, shape[0] * shape[1], shape, _cases())


@functools.lru_cache(maxsize=None)
def _jax_graph(shape, graph):
    c = _cases()[graph]
    mesh = jax_make_mesh(shape)
    g = cg.from_edgelist(c["src"], c["dst"], c["w"], num_vertices=c["num_vertices"],
                         symmetrize=c["symmetrize"])
    return mesh, g, jax_distribute_graph(mesh, g)


def _rank(shape, i, j):
    return _port(shape)[i * shape[1] + j]


def _global(shape, graph, key):
    """The port's unsharded array; every rank's copy must be the same."""
    copies = [r[graph][key + "_global"] for r in _port(shape)]
    for other in copies[1:]:
        np.testing.assert_array_equal(other, copies[0])
    return copies[0]


def _port_edges(r, shape, i, j):
    """(dst, src, weight) global triples of a rank's in_block, sorted."""
    rows, vp = shape[0], r["vp"]
    blk = r["in_block"]
    majors, minors = blk["majors"].astype(np.int64), blk["minors"].astype(np.int64)
    dst = (majors // vp * rows + i) * vp + majors % vp
    src = minors + j * rows * vp
    w = np.ones(len(src)) if blk["weights"] is None else blk["weights"]
    return _sorted_triples(dst, src, w)


def _jax_edges(mgg, i, j):
    srcs = np.asarray(mgg.srcs)[i, j].astype(np.int64)  # (C, R, g_pad)
    dsts = np.asarray(mgg.dsts)[i, j].astype(np.int64)
    w = np.ones(srcs.shape) if mgg.weights is None else np.asarray(mgg.weights)[i, j]
    b = np.arange(mgg.cols)[:, None, None]
    valid = dsts < mgg.vp
    dst = (dsts + (b * mgg.rows + i) * mgg.vp)[valid]
    src = (srcs + j * mgg.rows * mgg.vp)[valid]
    return _sorted_triples(dst, src, w[valid])


def _sorted_triples(dst, src, w):
    order = np.lexsort((w, src, dst))
    return dst[order], src[order], np.asarray(w, dtype=np.float32)[order]


# ------------------------------------------------------------ partition


@pytest.mark.parametrize("rows,cols,v", [(1, 1, 34), (2, 1, 34), (1, 2, 35), (2, 4, 100), (3, 2, 7)])
def test_partition_matches_jax(rows, cols, v):
    p, q = Partition2D.create(rows, cols, v), JaxPartition2D.create(rows, cols, v)
    assert (p.rows, p.cols, p.num_vertices, p.vp) == (q.rows, q.cols, q.num_vertices, q.vp)
    assert (p.num_partitions, p.v_padded) == (q.num_partitions, q.v_padded)
    for i in range(rows):
        for j in range(cols):
            assert p.range_of(i, j) == q.range_of(i, j)
            assert p.col_span(j) == q.col_span(j)
            for b in range(cols):
                assert p.dst_range_of_block(i, b) == q.dst_range_of_block(i, b)
    ids = np.arange(v)
    src, dst = np.repeat(ids, v), np.tile(ids, v)
    for a, b in zip(p.edge_block(src, dst), q.edge_block(src, dst)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(p.owner_of_vertex(ids), q.owner_of_vertex(ids)):
        np.testing.assert_array_equal(a, b)
    # the port's edge_block takes tensors too
    for a, b in zip(p.edge_block(torch.from_numpy(src), torch.from_numpy(dst)),
                    q.edge_block(src, dst)):
        np.testing.assert_array_equal(a.numpy(), b)


def test_mesh_shape_for_matches_jax():
    for n in range(1, 65):
        assert mesh_shape_for(n) == jax_mesh_shape_for(n)


# --------------------------------------------------------------- ingest


@shapes
@graphs
def test_blocks_match_jax(shape, graph):
    """Each rank holds the JAX device's edges: the same (dst, src, weight)
    multiset, block counts and vp; out_block holds the same edges."""
    _, g, mgg = _jax_graph(shape, graph)
    for i in range(shape[0]):
        for j in range(shape[1]):
            r = _rank(shape, i, j)[graph]
            assert r["vp"] == mgg.vp and r["num_edges"] == mgg.num_edges
            assert r["is_symmetric"] == mgg.is_symmetric == (graph == "karate")
            np.testing.assert_array_equal(r["block_counts"], np.asarray(mgg.block_counts)[i, j])
            got, want = _port_edges(r, shape, i, j), _jax_edges(mgg, i, j)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
            ob, ib = r["out_block"], r["in_block"]
            in_pairs = np.sort(ib["majors"].astype(np.int64) * 10**9 + ib["minors"])
            out_pairs = np.sort(ob["minors"].astype(np.int64) * 10**9 + ob["majors"])
            np.testing.assert_array_equal(in_pairs, out_pairs)
            np.testing.assert_array_equal(np.diff(ob["offsets"]),
                                          np.bincount(ob["majors"], minlength=len(ob["offsets"]) - 1))
    if shape == (1, 1):
        # one rank: its in_block is the single-device graph's CSC
        sg = _sg_graph(graph).csc()
        ib = _rank(shape, 0, 0)[graph]["in_block"]
        for key in ("offsets", "minors", "majors", "weights"):
            want = getattr(sg, key)
            if want is None:
                assert ib[key] is None
            else:
                np.testing.assert_array_equal(ib[key], want.numpy())


@shapes
@pytest.mark.parametrize("symmetrize", [False, True])
def test_renumbered_chunks_match_jax(shape, symmetrize):
    """distribute_edgelist_chunks(renumber=True) over two chunks, each
    emitting both directions when symmetrize: the same renumber map and
    the same edges on every rank as the JAX package's. With symmetrize the
    port coalesces the streamed edges (each ordered pair stored once, as
    its single-shot ingest does), where the JAX package keeps parallel
    edges: the port's are the JAX package's with each repeated pair taken
    once, and its edge count theirs."""
    c = _cases()["rmat"]
    mesh, _, _ = _jax_graph(shape, "rmat")
    mgc, new_to_old = jax_distribute_chunks(mesh, c["chunks"], num_vertices=c["num_vertices"],
                                            renumber=True, symmetrize=symmetrize)
    want = {(i, j): _jax_edges(mgc, i, j) for i in range(shape[0]) for j in range(shape[1])}
    num_edges = mgc.num_edges
    if symmetrize:
        want = {k: _distinct_pairs(*e) for k, e in want.items()}
        num_edges = sum(len(e[0]) for e in want.values())
        assert num_edges < mgc.num_edges  # the stream repeats pairs
    for i in range(shape[0]):
        for j in range(shape[1]):
            r = _rank(shape, i, j)["rmat"][f"chunks_{symmetrize}"]
            np.testing.assert_array_equal(r["new_to_old"], new_to_old)
            assert (r["vp"], r["num_edges"], r["is_symmetric"]) == (
                mgc.vp, num_edges, mgc.is_symmetric)
            for a, b in zip(_port_edges(r, shape, i, j), want[i, j]):
                np.testing.assert_array_equal(a, b)


def _distinct_pairs(dst, src, w):
    """``_sorted_triples`` of an unweighted rank with each (dst, src) pair
    once."""
    keep = np.ones(len(dst), bool)
    keep[1:] = (dst[1:] != dst[:-1]) | (src[1:] != src[:-1])
    return dst[keep], src[keep], w[keep]


@shapes
@graphs
def test_shard_unshard(shape, graph):
    """Each rank's slice is range q = j*R + i; unshard reassembles them."""
    v = _cases()[graph]["num_vertices"]
    values = np.arange(v, dtype=np.float32) * 0.5
    np.testing.assert_array_equal(_global(shape, graph, "values"), values)
    vp = _rank(shape, 0, 0)[graph]["vp"]
    padded = np.zeros(shape[0] * shape[1] * vp, np.float32)
    padded[:v] = values
    for i in range(shape[0]):
        for j in range(shape[1]):
            q = j * shape[0] + i
            np.testing.assert_array_equal(_rank(shape, i, j)[graph]["values"],
                                          padded[q * vp:(q + 1) * vp])


# ----------------------------------------------------------- algorithms


@shapes
@graphs
def test_degrees_match_jax(shape, graph):
    mesh, _, mgg = _jax_graph(shape, graph)
    want = jax_unshard(mgg, jax_mg_algos.mg_out_weight_sums(mesh, mgg))
    np.testing.assert_allclose(_global(shape, graph, "out_weight_sums"), want, rtol=1e-6)
    # the generic push-reduce prim computes the same sums edge by edge
    np.testing.assert_allclose(_global(shape, graph, "outgoing_weights"), want, rtol=1e-6)
    want = jax_unshard(mgg, jax_mg_algos.mg_in_degrees(mesh, mgg))
    np.testing.assert_array_equal(_global(shape, graph, "in_degrees"), want)


@shapes
@graphs
@pytest.mark.parametrize("variant", ["default", "personalization", "nstart"])
def test_pagerank_matches_jax(shape, graph, variant):
    mesh, _, mgg = _jax_graph(shape, graph)
    c = _cases()[graph]
    kw = {"default": {}, "personalization": {"personalization": c["personalization"]},
          "nstart": {"nstart": c["nstart"]}}[variant]
    pr, _ = jax_mg_algos.mg_pagerank(mesh, mgg, **kw)
    got = _global(shape, graph, f"pagerank_{variant}")
    np.testing.assert_allclose(got, jax_unshard(mgg, pr), rtol=0, atol=1e-6)
    assert abs(float(got.sum()) - 1.0) < 1e-4
    # two iterations do not reach tol: fail_on_nonconvergence raises on every rank
    assert all(r[graph]["pagerank_unconverged_raised"] for r in _port(shape))


@shapes
@graphs
@pytest.mark.parametrize("branch", ["dense", "push"])
def test_bfs_matches_jax(shape, graph, branch):
    """Both of the port's branches (dense min-plus levels; the frontier
    push above 2^24 vertices, forced here) against the JAX package's."""
    mesh, _, mgg = _jax_graph(shape, graph)
    dist, pred = jax_mg_algos.mg_bfs(mesh, mgg, np.asarray(_cases()[graph]["sources"]))
    np.testing.assert_array_equal(_global(shape, graph, f"bfs_{branch}_dist"),
                                  jax_unshard(mgg, dist))
    np.testing.assert_array_equal(_global(shape, graph, f"bfs_{branch}_pred"),
                                  jax_unshard(mgg, pred))
    dist1, _ = jax_mg_algos.mg_bfs(mesh, mgg, np.asarray(_cases()[graph]["sources"]),
                                   depth_limit=1)
    np.testing.assert_array_equal(_global(shape, graph, "bfs_depth1_dist"),
                                  jax_unshard(mgg, dist1))


def _sg_graph(graph):
    c = _cases()[graph]
    return ct.from_edgelist(c["src"], c["dst"], c["w"], num_vertices=c["num_vertices"],
                            symmetrize=c["symmetrize"], device="cpu")


@shapes
@graphs
@pytest.mark.parametrize("op", ["sum", "mean", "max"])
def test_spmm_aggregate(shape, graph, op):
    mesh, _, mgg = _jax_graph(shape, graph)
    x = _cases()[graph]["feats"]
    got = _global(shape, graph, f"spmm_{op}")
    want = jax_unshard(mgg, jax_mg_algos.mg_spmm_aggregate(
        mesh, mgg, jax_shard(mesh, mgg, x), op=op))
    g = _sg_graph(graph)
    csc = g.csc()
    deg = np.maximum(csc.degrees().numpy(), 1)[:, None]
    if op == "max":
        np.testing.assert_array_equal(got, want)
        sg = spmm_aggregate(g, torch.from_numpy(x), op="max")
        np.testing.assert_array_equal(got, sg.numpy())
        return
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
    scale = 1.0 if op == "sum" else deg
    a = _scipy_adj(csc)
    ref64 = a @ x.astype(np.float64) / scale
    bound = a @ np.abs(x.astype(np.float64)) * BF16_REL / scale
    assert (np.abs(got - ref64) <= bound).all()
    sg = spmm_rows_reference(csc, torch.from_numpy(x), precision="bf16", use_weights=False)
    np.testing.assert_allclose(got, sg.numpy() / scale, rtol=1e-5, atol=1e-5)


def _scipy_adj(csc):
    import scipy.sparse as sp

    ones = np.ones(csc.num_edges)
    return sp.csr_matrix((ones, (csc.majors.numpy(), csc.minors.numpy())),
                         shape=(csc.num_majors, csc.num_minors))


@shapes
@graphs
def test_sage_forward_matches_jax(shape, graph):
    mesh, _, mgg = _jax_graph(shape, graph)
    c = _cases()[graph]
    params = {k: jnp.asarray(a) for k, a in c["params"].items()}
    want = jax_unshard(mgg, jax_mg_gnn.mg_sage_forward(
        mesh, mgg, params, jax_shard(mesh, mgg, c["feats"])))
    got = _global(shape, graph, "sage")
    assert got.shape == (c["num_vertices"], OUT) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


def test_spmm_matches_jax_sorted_engine():
    """The JAX package's multi-stream bf16-pair pipeline (TPU kernels #8-#10
    in interpret mode, on its TINY config) and the port's spmm_rows "bf16"
    per rank compute one function: held within 2e-2 on a (2, 2) mesh (the
    JAX pipeline also rounds products and group totals to bf16)."""
    from cugraph_tpu.dist.mg_sorted import build_device_layouts
    from cugraph_tpu.prims.pallas.spmv2 import TINY

    shape = (2, 2)
    mesh, _, mgg = _jax_graph(shape, "karate")
    x = _cases()["karate"]["feats"][:, :6]
    layouts = build_device_layouts(mesh, mgg, use_weights=False, cfg=TINY)
    want = jax_unshard(mgg, jax_mg_algos.mg_spmm_aggregate(
        mesh, mgg, jax_shard(mesh, mgg, x), op="sum",
        sorted_layouts=layouts, sorted_interpret=True))
    got = _global(shape, "karate", "spmm_sum")[:, :6]
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


@shapes
def test_no_kernel_launch_on_cpu_ranks(shape):
    for r in _port(shape):
        assert r["launches_before"] == r["launches_after"] == [0, 0, 0]


# ------------------------------------------------------- training and more


@train_shapes
@graphs
def test_mg_spmm_backward(shape, graph):
    """dX of sum(per_v_incoming_sorted_spmm(X) * dY): the all-gather of dY
    over col_group, spmm_rows over out_block, the reduce-scatter over
    row_group, against autograd through the global plain version."""
    c = _cases()[graph]
    csc, csr = _sg_graph(graph).csc(), _sg_graph(graph).csr()

    def autograd(dy):
        x = torch.from_numpy(c["feats"]).requires_grad_()
        y = spmm_rows_reference(csc, x, precision="bf16", use_weights=False)
        (y * torch.from_numpy(dy)).sum().backward()
        return x.grad.numpy()

    np.testing.assert_array_equal(_global(shape, graph, "dx_int"), autograd(c["dy_int"]))
    got, dy = _global(shape, graph, "dx_float"), torch.from_numpy(c["dy_float"])
    scale = spmm_rows_reference(csr, dy.abs(), precision="bf16", use_weights=False).numpy()
    product = spmm_rows_reference(csr, dy, precision="bf16", use_weights=False).numpy()
    assert (np.abs(got - product) <= 1e-5 * scale).all()
    assert (np.abs(got - autograd(c["dy_float"])) <= (2.0**-7 + 1e-5) * scale).all()


@functools.lru_cache(maxsize=None)
def _jax_train(shape, graph):
    mesh, _, mgg = _jax_graph(shape, graph)
    c = _cases()[graph]
    step = jax_mg_gnn.make_sage_train_step(mesh, mgg, lr=1e-2)
    params = {k: jnp.asarray(a) for k, a in c["params"].items()}
    feats, targets = jax_shard(mesh, mgg, c["feats"]), jax_shard(mesh, mgg, c["targets"])
    out = []
    for _ in range(2):
        params, loss = step(params, feats, targets)
        out.append((float(loss), {k: np.asarray(a) for k, a in params.items()}))
    return out


@train_shapes
@graphs
def test_sage_train_step_matches_jax(shape, graph):
    """Each step's update dp = p_new - p_old, leaf by leaf, within the bf16
    contract's bound of JAX's: (2^-7 + 1e-5) of lr * max |g_JAX| (JAX's
    own max |dp|), beyond the f32 rounding of p - lr * g (2^-22 |p|)."""
    start = (None, _cases()[graph]["params"])
    want = [start] + _jax_train(shape, graph)
    alone = _rank((1, 1), 0, 0)[graph]["train"]
    for r in _port(shape):
        got = [start] + r[graph]["train"]
        for s in range(1, len(got)):
            (loss, params), (jloss, jparams) = got[s], want[s]
            assert np.isfinite(loss) and abs(loss - jloss) <= 2e-2 * abs(jloss)
            assert abs(loss - alone[s - 1][0]) <= 1e-5 * abs(alone[s - 1][0])
            for k, p in params.items():
                dp = p.astype(np.float64) - got[s - 1][1][k]
                jdp = jparams[k].astype(np.float64) - want[s - 1][1][k]
                excess = np.abs(dp - jdp) - 2.0**-22 * np.abs(got[s - 1][1][k])
                assert excess.max() <= (2.0**-7 + 1e-5) * np.abs(jdp).max(), (s, k)
                np.testing.assert_allclose(p, alone[s - 1][1][k], rtol=1e-5, atol=1e-5)
    # the step moves every parameter
    assert all(np.abs(want[1][1][k] - start[1][k]).max() > 0 for k in start[1])


def _sssp_pred_rule(graph, dist, source):
    """The single-device sweep's predecessors in numpy: the smallest src
    among the tree edges dist[s] + w == dist[d] (f32), sources excluded."""
    csc = _sg_graph(graph).csc()
    s, d = csc.minors.numpy().astype(np.int64), csc.majors.numpy().astype(np.int64)
    w = np.ones(len(s), np.float32) if csc.weights is None else csc.weights.numpy()
    tree = np.isfinite(dist[d]) & ((dist[s] + w).astype(np.float32) == dist[d]) & (d != source)
    pred = np.full(len(dist), len(dist), np.int64)
    np.minimum.at(pred, d[tree], s[tree])
    return np.where(pred < len(dist), pred, -1).astype(np.int32)


@train_shapes
@graphs
def test_mg_sssp_matches_jax(shape, graph):
    mesh, _, mgg = _jax_graph(shape, graph)
    source = _cases()[graph]["sources"][0]
    dist, _ = jax_mg_algos.mg_sssp(mesh, mgg, source)
    got = _global(shape, graph, "sssp_dist")
    np.testing.assert_array_equal(got, jax_unshard(mgg, dist))
    assert np.isfinite(got).sum() > 1
    np.testing.assert_array_equal(_global(shape, graph, "sssp_pred"),
                                  _sssp_pred_rule(graph, got, source))


@train_shapes
@graphs
@pytest.mark.parametrize("algo", ["katz", "eigenvector", "hits"])
def test_mg_centrality_matches_jax(shape, graph, algo):
    mesh, _, mgg = _jax_graph(shape, graph)
    if algo == "katz":
        want = {"katz": jax_mg_algos.mg_katz_centrality(mesh, mgg, _cases()[graph]["katz_alpha"])}
    elif algo == "eigenvector":
        want = {"eigenvector": jax_mg_algos.mg_eigenvector_centrality(mesh, mgg)}
    else:
        h, a = jax_mg_algos.mg_hits(mesh, mgg)
        want = {"hits_hubs": h, "hits_authorities": a}
    for key, value in want.items():
        got = _global(shape, graph, key)
        assert np.isfinite(got).all() and np.abs(got).max() > 0
        np.testing.assert_allclose(got, jax_unshard(mgg, value), rtol=0, atol=1e-5)
