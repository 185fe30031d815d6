"""Spanning trees, the Hungarian assignment and Force Atlas 2 of
cugraph_tpu_torch against cugraph_tpu on the CPU.

- Trees: both packages hand scipy the same edge list in the same order, so
  the trees are EQUAL, on distinct weights, on a forest and on tied
  weights (where scipy's choice follows that order: no difference by
  design is needed); the total weight and the forest's components are
  checked besides.
- ``hungarian``: equal cost and assignment on square, non-square and
  parallel-edge inputs (the last parallel edge in CSR order sets the cost
  in both).
- ``force_atlas2``: FA2 is chaotic in f32 (the two packages' repulsion
  sums run in other orders and part ways over hundreds of steps), so each
  step is held to JAX's ``_fa2_step`` from the same state within
  TOL_FA2_STEP of max |pos|, and whole runs of 1 and 5 steps within
  TOL_FA2_RUNS; a long run is held to invariants: finite, and the blocked
  repulsion equal to the unblocked one.
"""

import jax.numpy as jnp
import networkx as nx
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.sparse.csgraph import connected_components

import cugraph_tpu as cg
from cugraph_tpu.algos import layout as jlayout

import cugraph_tpu_torch as ct
from cugraph_tpu_torch.algos import layout
from cugraph_tpu_torch.utils.error import GraphError

CPU = "cpu"
# measured on karate (V = 34): 1 step ~1e-7 of max |pos|, 5 steps ~5e-7
TOL_FA2_STEP = 1e-6
TOL_FA2_RUNS = {1: 1e-6, 5: 1e-5}


def _pair(src, dst, w=None, **kw):
    return (cg.from_edgelist(src, dst, w, **kw),
            ct.from_edgelist(src, dst, w, device=CPU, **kw))


# ------------------------------------------------------------------ trees


def _tree_graphs():
    rng = np.random.default_rng(1)
    src, dst = rng.integers(0, 80, 500), rng.integers(0, 80, 500)
    # distinct weights
    yield "distinct", (src, dst, rng.permutation(500).astype(np.float32) / 7 + 1)
    # a forest: two blocks of ids and 10 isolated vertices
    s2 = np.where(rng.random(500) < 0.5, src % 40, 40 + src % 30)
    d2 = np.where(s2 < 40, dst % 40, 40 + dst % 30)
    yield "forest", (s2, d2, rng.random(500).astype(np.float32) + 0.01)
    # ties: weights in {1, 2, 3}
    yield "ties", (src, dst, rng.integers(1, 4, 500).astype(np.float32))
    # unweighted: every edge counts 1
    yield "unweighted", (src, dst, None)


TREE_GRAPHS = dict(_tree_graphs())


def _host_tree(t):
    return tuple(np.asarray(a) for a in t)


@pytest.mark.parametrize("maximum", [False, True])
@pytest.mark.parametrize("case", list(TREE_GRAPHS))
def test_spanning_tree_equals_jax(case, maximum):
    src, dst, w = TREE_GRAPHS[case]
    jg, tg = _pair(src, dst, w, num_vertices=80, symmetrize=True)
    name = "maximum_spanning_tree" if maximum else "minimum_spanning_tree"
    got = getattr(ct, name)(tg)
    assert [a.dtype for a in got] == [torch.int32, torch.int32, torch.float32]
    assert all(a.device == torch.device(CPU) for a in got)
    want = _host_tree(getattr(cg, name)(jg))
    for a, b in zip(_host_tree(got), want):
        np.testing.assert_array_equal(a, b)
    # a spanning forest: V - (components) edges, the graph's components
    s, d, tw = _host_tree(got)
    n_comp, labels = connected_components(
        sp.coo_matrix((np.ones(len(src)), (src, dst)), shape=(80, 80)), directed=False)
    assert len(s) == 80 - n_comp
    t_comp, t_labels = connected_components(
        sp.coo_matrix((np.ones(len(s)), (s, d)), shape=(80, 80)), directed=False)
    assert t_comp == n_comp and len(set(zip(labels, t_labels))) == n_comp
    # total weight against networkx's tree of the graph's edges
    gs, gd, gw = ct.core.decompress_to_edgelist(tg)
    gw = torch.ones(gs.numel()) if gw is None else gw
    G = nx.Graph()
    G.add_nodes_from(range(80))
    G.add_weighted_edges_from(
        (a, b, x) for a, b, x in zip(gs.tolist(), gd.tolist(), gw.tolist()) if a != b)
    ref = (nx.maximum_spanning_tree if maximum else nx.minimum_spanning_tree)(G)
    assert abs(tw.astype(np.float64).sum() - ref.size(weight="weight")) <= 1e-4


def test_spanning_tree_requires_symmetric():
    g = ct.from_edgelist([0, 1], [1, 2], [1.0, 2.0], device=CPU)
    with pytest.raises(GraphError, match="symmetric"):
        ct.minimum_spanning_tree(g)


def test_spanning_tree_parallel_edges_as_jax():
    """A multigraph's parallel edges are summed by scipy's tocsr, in both."""
    src, dst, w = [0, 0, 1, 2, 2], [1, 1, 2, 0, 3], [1.0, 5.0, 2.0, 4.0, 1.0]
    jg, tg = _pair(src, dst, w, symmetrize=True, multi=True)
    for name in ("minimum_spanning_tree", "maximum_spanning_tree"):
        for a, b in zip(_host_tree(getattr(ct, name)(tg)), _host_tree(getattr(cg, name)(jg))):
            np.testing.assert_array_equal(a, b)


# -------------------------------------------------------------- hungarian


def _assignment_graph(nw, nt, seed, parallel=0, odd_workers=False):
    rng = np.random.default_rng(seed)
    vertices = rng.permutation(nw + nt).astype(np.int32) if odd_workers else \
        np.arange(nw + nt, dtype=np.int32)
    workers, tasks = vertices[:nw], vertices[nw:]
    cost = rng.random((nw, nt)).astype(np.float32)
    src, dst, w = np.repeat(workers, nt), np.tile(tasks, nw), cost.reshape(-1)
    if parallel:
        pick = rng.choice(len(src), parallel, replace=False)
        src, dst = np.concatenate([src, src[pick]]), np.concatenate([dst, dst[pick]])
        w = np.concatenate([w, rng.random(parallel).astype(np.float32) / 10])
    return src, dst, w, workers, nw + nt


@pytest.mark.parametrize("shape", [(6, 6, 0, False), (4, 7, 0, False), (7, 4, 0, False),
                                   (8, 8, 20, False), (5, 9, 10, True)])
def test_hungarian_equals_jax(shape):
    nw, nt, parallel, odd = shape
    src, dst, w, workers, v = _assignment_graph(nw, nt, nw * 10 + nt, parallel, odd)
    jg, tg = _pair(src, dst, w, num_vertices=v)
    cost, assign = ct.hungarian(tg, workers)
    jcost, jassign = cg.hungarian(jg, workers)
    assert isinstance(cost, float) and cost == jcost
    assert assign.dtype == torch.int32 and assign.device == torch.device(CPU)
    np.testing.assert_array_equal(assign.numpy(), jassign)
    # also from a tensor of workers
    cost2, assign2 = ct.hungarian(tg, torch.from_numpy(workers))
    assert cost2 == cost and torch.equal(assign2, assign)


def test_hungarian_matches_scipy():
    import scipy.optimize as spo

    src, dst, w, workers, v = _assignment_graph(5, 5, 0)
    tg = ct.from_edgelist(src, dst, w, num_vertices=v, device=CPU)
    total, assign = ct.hungarian(tg, workers)
    cost = w.reshape(5, 5)
    rows, cols = spo.linear_sum_assignment(cost)
    np.testing.assert_allclose(total, cost[rows, cols].sum(), rtol=1e-5)
    got = cost[np.arange(5), assign.numpy() - 5].sum()
    np.testing.assert_allclose(got, total, rtol=1e-5)


def test_hungarian_requires_weights():
    with pytest.raises(GraphError, match="weights"):
        ct.hungarian(ct.from_edgelist([0], [1], device=CPU), [0])


# ------------------------------------------------------------ force atlas 2


@pytest.fixture(scope="module")
def karate_pair():
    e = np.array(nx.karate_club_graph().edges(), dtype=np.int32)
    w = np.random.default_rng(0).random(len(e)).astype(np.float32) + 0.1
    return _pair(e[:, 0], e[:, 1], w, symmetrize=True)


OPTIONS = {
    "default": {},
    "lin_log": dict(lin_log_mode=True),
    "no_outbound": dict(outbound_attraction_distribution=False),
    "strong_gravity": dict(strong_gravity_mode=True),
    "edge_weight_influence": dict(edge_weight_influence=0.5),
    "knobs": dict(jitter_tolerance=0.7, scaling_ratio=3.0, gravity=0.5),
}
JAX_DEFAULTS = dict(outbound_attraction_distribution=True, lin_log_mode=False,
                    edge_weight_influence=1.0, jitter_tolerance=1.0, scaling_ratio=2.0,
                    strong_gravity_mode=False, gravity=1.0)


def _start(v, seed=7):
    return np.random.default_rng(seed).uniform(-50, 50, (v, 2)).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("opt", list(OPTIONS))
def test_fa2_each_step_matches_jax(opt, karate_pair):
    jg, tg = karate_pair
    o = dict(JAX_DEFAULTS, **OPTIONS[opt])
    fg = layout._fa2_graph(tg, o["edge_weight_influence"])
    pos = jnp.asarray(_start(tg.num_vertices))
    forces = jnp.zeros_like(pos)
    speed = jnp.asarray(1.0, jnp.float32)
    for _ in range(5):
        tpos, tforces, tspeed = layout._fa2_step(
            fg, torch.from_numpy(np.array(pos)), torch.from_numpy(np.array(forces)),
            torch.tensor(float(speed)), o["jitter_tolerance"], o["gravity"],
            o["scaling_ratio"], o["lin_log_mode"], o["outbound_attraction_distribution"],
            o["strong_gravity_mode"])
        pos, forces, speed, _ = jlayout._fa2_step(
            jg, pos, forces, speed, jnp.asarray(1.0, jnp.float32),
            *(jnp.asarray(o[k], jnp.float32) for k in (
                "jitter_tolerance", "edge_weight_influence", "gravity", "scaling_ratio")),
            o["lin_log_mode"], o["outbound_attraction_distribution"], o["strong_gravity_mode"])
        assert tspeed.dim() == 0
        assert _rel(tpos.numpy(), pos) <= TOL_FA2_STEP
        assert _rel(tforces.numpy(), forces) <= TOL_FA2_STEP
        assert abs(float(tspeed) - float(speed)) <= TOL_FA2_STEP * float(speed)


@pytest.mark.parametrize("steps", [1, 5])
@pytest.mark.parametrize("opt", list(OPTIONS))
def test_fa2_runs_match_jax(opt, steps, karate_pair):
    jg, tg = karate_pair
    start = _start(tg.num_vertices, seed=steps)
    got = ct.force_atlas2(tg, max_iter=steps, pos_list=start, **OPTIONS[opt])
    want = cg.force_atlas2(jg, max_iter=steps, pos_list=start, **OPTIONS[opt])
    assert got.dtype == torch.float32 and got.shape == (34, 2)
    assert _rel(got.numpy(), want) <= TOL_FA2_RUNS[steps]


def test_fa2_default_start_is_jax(karate_pair):
    jg, tg = karate_pair
    np.testing.assert_array_equal(ct.force_atlas2(tg, max_iter=0, seed=3).numpy(),
                                  cg.force_atlas2(jg, max_iter=0, seed=3))


class _Recorder:
    def __init__(self):
        self.calls = []

    def on_preprocess_end(self, pos):
        self.calls.append(("pre", pos))

    def on_epoch_end(self, pos):
        self.calls.append(("epoch", pos))

    def on_train_end(self, pos):
        self.calls.append(("end", pos))


def test_fa2_callback(karate_pair):
    _, tg = karate_pair
    rec = _Recorder()
    out = ct.force_atlas2(tg, max_iter=4, callback=rec)
    assert [c for c, _ in rec.calls] == ["pre"] + ["epoch"] * 4 + ["end"]  # max_iter + 2
    for _, pos in rec.calls:
        assert isinstance(pos, np.ndarray) and pos.dtype == np.float32 and pos.shape == (34, 2)
    np.testing.assert_array_equal(rec.calls[-1][1], out.numpy())
    np.testing.assert_array_equal(rec.calls[-2][1], out.numpy())


@pytest.mark.parametrize("block_rows", [1, 5, 33])
def test_fa2_blocked_repulsion_equals_unblocked(block_rows, karate_pair, monkeypatch):
    _, tg = karate_pair
    v = tg.num_vertices
    pos = torch.from_numpy(_start(v))
    deg = layout._fa2_graph(tg, 1.0).deg
    whole = layout._repulsion(pos, deg, 2.0)
    # the (V, V) form of the JAX step, in float64
    p = pos.double()
    diff = p[:, None, :] - p[None, :, :]
    rep = 2.0 * deg.double()[:, None] * deg.double()[None, :] / ((diff * diff).sum(-1) + 1e-9)
    rep = rep * (1 - torch.eye(v, dtype=torch.float64))
    ref = (rep[:, :, None] * diff).sum(1)
    assert ((whole.double() - ref).abs().max() / ref.abs().max()).item() <= 1e-6
    monkeypatch.setattr(layout, "REPULSION_BLOCK", block_rows * v)
    assert torch.equal(layout._repulsion(pos, deg, 2.0), whole)
    # a long run: finite, and the same with and without blocks
    blocked = ct.force_atlas2(tg, max_iter=100)
    monkeypatch.setattr(layout, "REPULSION_BLOCK", 1 << 24)
    assert torch.isfinite(blocked).all()
    assert torch.equal(blocked, ct.force_atlas2(tg, max_iter=100))
