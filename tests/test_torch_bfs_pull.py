"""BFS's pull level (prims/cuda/bfs.py) on the CPU: its plain version
against the min-plus level the port ran before it, level by level, on
skewed R-MAT graphs (symmetrized and directed), self-loops and parallel
edges, isolated vertices, several sources and a depth limit; bfs's dense
levels take the pull, whose plain version runs spmv_minplus's once a
level; and the heavy rows of ``_partition.pull_plan``, cached once per
adjacency. The kernels themselves run only on a card (chip_smoke.py holds
them to these plain versions there)."""

import collections

import numpy as np
import pytest
import torch

import cugraph_tpu_torch as ct
from cugraph_tpu_torch.algos import traversal
from cugraph_tpu_torch.prims.cuda import _partition, bfs_pull_level, spmv, spmv_minplus_reference
from cugraph_tpu_torch.prims.cuda.bfs import bfs_pull_level_reference
from cugraph_tpu_torch.utils import timer

INVALID = traversal.INVALID_DISTANCE


def _rmat(scale, edgefactor, seed):
    """numpy R-MAT (a, b, c = .57, .19, .19): skewed, with parallel edges."""
    rng = np.random.default_rng(seed)
    e = edgefactor << scale
    src = np.zeros(e, np.int64)
    dst = np.zeros(e, np.int64)
    for _ in range(scale):
        sb = rng.random(e) < 0.38
        db = rng.random(e) < np.where(sb, 0.19 / 0.38, 0.19 / 0.76)
        src, dst = (src << 1) | sb, (dst << 1) | db
    return src, dst, 1 << scale


def _loops_and_parallel(seed, v=600):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, v, 4000), rng.integers(0, v, 4000)
    loops = rng.integers(0, v, 200)
    again = rng.integers(0, 4000, 1500)  # each a repeat of an edge
    return (np.concatenate([src, loops, src[again]]), np.concatenate([dst, loops, dst[again]]),
            v)


def _isolated(seed, v=3000):
    """Edges among the even ids below v / 2 only: every odd id and the
    upper half have none."""
    rng = np.random.default_rng(seed)
    return 2 * rng.integers(0, v // 4, 6000), 2 * rng.integers(0, v // 4, 6000), v


GRAPHS = {  # name: (src, dst, v), symmetrize
    "rmat_sym": (lambda: _rmat(11, 16, 0), True),
    "rmat_directed": (lambda: _rmat(11, 16, 1), False),
    "loops_parallel": (lambda: _loops_and_parallel(2), False),
    "isolated": (lambda: _isolated(3), True),
}
SOURCES = [[0], [4, 17, 500]]


@pytest.fixture(scope="module", params=list(GRAPHS))
def graph(request):
    make, symmetrize = GRAPHS[request.param]
    src, dst, v = make()
    return ct.from_edgelist(src, dst, num_vertices=v, symmetrize=symmetrize, device="cpu")


def _start(v, sources):
    frontier = torch.zeros(v, dtype=torch.bool)
    frontier[sources] = True
    dist = torch.where(frontier, 0, INVALID).to(torch.int32)
    return frontier, frontier.clone(), dist, torch.full((v,), -1, dtype=torch.int32)


def _minplus_level(csc, frontier, visited, dist, pred, depth):
    """The dense level the pull replaces: min-plus over the CSC with x the
    ids on the frontier, +inf elsewhere, then the rows not yet visited."""
    ids = torch.arange(csc.num_majors, dtype=torch.float32)
    y = spmv_minplus_reference(csc, torch.where(frontier, ids, float("inf")), use_weights=False)
    new = torch.isfinite(y) & ~visited
    return (new, visited | new, torch.where(new, depth + 1, dist),
            torch.where(new, torch.where(new, y, 0.0).to(torch.int32), pred))


def _levels(g, sources, limit=None):
    """Every level of a BFS from ``sources`` by both, asserting them equal:
    new, visited, dist and pred. Returns the levels run."""
    csc = g.csc()
    frontier, visited, dist, pred = _start(g.num_vertices, sources)
    want = (visited.clone(), dist.clone(), pred.clone())
    depth = 0
    while bool(frontier.any()) and (limit is None or depth < limit):
        new_w, *want = _minplus_level(csc, frontier, *want, depth)
        new = bfs_pull_level_reference(csc, frontier, visited, dist, pred, depth)
        assert torch.equal(new, new_w)
        for got, w in zip((visited, dist, pred), want):
            assert torch.equal(got, w)
        frontier, depth = new, depth + 1
    return depth


@pytest.mark.parametrize("sources", SOURCES)
def test_pull_level_equals_minplus_level(graph, sources):
    assert _levels(graph, sources) >= 2


@pytest.mark.parametrize("limit", [1, 2])
def test_bfs_depth_limit_equals_minplus_levels(graph, limit):
    csc = graph.csc()
    frontier, visited, dist, pred = _start(graph.num_vertices, SOURCES[1])
    for depth in range(limit):
        frontier, visited, dist, pred = _minplus_level(csc, frontier, visited, dist, pred, depth)
    got_d, got_p = ct.bfs(graph, SOURCES[1], depth_limit=limit)
    assert torch.equal(got_d, dist) and torch.equal(got_p, pred)
    assert int(got_d[got_d != INVALID].max()) == limit


@pytest.mark.parametrize("sources", SOURCES)
def test_bfs_dense_levels_take_the_pull(graph, sources, monkeypatch):
    calls = []

    def counted(*args):
        calls.append(args[-1])
        return bfs_pull_level(*args)

    monkeypatch.setattr(traversal, "bfs_pull_level", counted)
    dist, _ = ct.bfs(graph, sources)
    assert calls == list(range(int(dist[dist != INVALID].max()) + 1))


@pytest.mark.parametrize("sources", SOURCES)
def test_dense_levels_run_the_minplus_plain_version(graph, sources, monkeypatch):
    """What is planted in spmv_minplus's plain version reaches bfs's dense
    levels on the CPU: one call a level, and its answer is bfs's."""
    calls = []

    def recorded(adj, x, **kw):
        calls.append(int(torch.isfinite(x).sum()))
        return spmv_minplus_reference(adj, x, **kw)

    monkeypatch.setattr(spmv, "spmv_minplus_reference", recorded)
    dist, _ = ct.bfs(graph, sources)
    levels = int(dist[dist != INVALID].max()) + 1
    assert calls == [int((dist == d).sum()) for d in range(levels)]
    monkeypatch.setattr(spmv, "spmv_minplus_reference", lambda adj, x, **kw: x.clone())
    got, _ = ct.bfs(graph, sources)  # y = x: no row is ever found
    assert torch.equal(got, torch.where(dist == 0, 0, INVALID).to(got.dtype))


def test_pull_plan_lists_the_heavy_rows_once(monkeypatch):
    src, dst, v = _rmat(11, 16, 5)
    csc = ct.from_edgelist(src, dst, num_vertices=v, symmetrize=True, device="cpu").csc()
    deg = csc.degrees()
    for heavy in (0, 16, _partition.PULL_HEAVY_DEGREE, int(deg.max())):
        plan = _partition.pull_plan(csc, heavy)
        rows = plan.heavy_rows
        assert rows.dtype == torch.int32 and plan.heavy_degree == heavy
        assert bool((rows[1:] > rows[:-1]).all())
        assert torch.equal(rows.long(), torch.arange(v)[deg > heavy])
    assert _partition.pull_plan(csc, int(deg.max())).heavy_rows.numel() == 0
    with pytest.raises(ValueError):
        _partition.pull_plan(csc, -1)
    built = []
    real = _partition.pull_plan
    monkeypatch.setattr(_partition, "pull_plan", lambda *a: built.append(a[1:]) or real(*a))
    monkeypatch.setattr(timer, "_setup_spans", collections.deque(maxlen=16))
    first = _partition.pull_plan_for(csc)
    assert _partition.pull_plan_for(csc) is first
    assert built == [(_partition.PULL_HEAVY_DEGREE,)]
    (kept,) = [s for s in timer.setup_spans() if s["name"] == "cgt/setup.bfs_pull_plan"]
    assert kept["counters"] == {"heavy_rows": int((deg > _partition.PULL_HEAVY_DEGREE).sum())}
    assert torch.equal(first.heavy_rows.long(),
                       torch.arange(v)[deg > _partition.PULL_HEAVY_DEGREE])
