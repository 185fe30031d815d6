"""Plain versions of spmv_sum / spmv_minplus, and the generic per-vertex
reduce they are checked against, against cugraph_tpu.

On CPU tensors the wrappers take their plain versions, which must agree
with the numpy oracles of tests/test_spmv3.py (sum: relative 1e-5; min:
bit-equal, +inf pattern included) and with the JAX package's keyed Pallas
engine run in interpret mode on TINY3 (sum: 2e-4, its hi/lo bf16 contract;
min: bit-equal). The graphs are those of tests/test_spmv3.py:47-56.

The v1 windowed pull SpMV (``cugraph_tpu/prims/pallas/spmv.py``, kernel
``_make_reduce_kernel``), run in interpret mode as tests/test_pallas_spmv.py
runs it, computes spmv_sum's function over the weighted CSC: they agree
within 1e-5 of each row's sum of |w * x|.

Column segments (prims/cuda/_partition.py:sweep_plan): the plan cuts a
CSC by its minors into ranges of a given width, each range's edges in the
CSC's order with their weights and offsets and tiles of their own, over
every major (dense) or, after the first range and below
_partition.SEGMENT_HYPERSPARSE_SHARE of them with an edge in the range,
over those alone (hypersparse, with their ids); one range is the CSC
itself. The rule (_partition.segment_count, applied by plan_for) gives
K = 1 while x fits its share of the L2 and ceil(x bytes / budget) above;
the plain versions run range by range and combined in range order (+ for
the sum, fmin for the min, the kernels' accumulate mode, the hypersparse
ranges into their rows alone) give spmv_sum's result within f32 rounding
and spmv_minplus' bit for bit, whatever the forms of the ranges.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import cugraph_tpu as cg
import cugraph_tpu_torch as ct
from cugraph_tpu import prims as jprims
from cugraph_tpu.prims.pallas.spmv import build_pull_layout, pull_spmv
from cugraph_tpu.prims.pallas.spmv3 import TINY3, build_keyed_layout, keyed_spmv_jit
from cugraph_tpu_torch import prims as tprims
from cugraph_tpu_torch.core.csr import CompressedAdj
from cugraph_tpu_torch.prims.cuda import (
    _partition,
    spmv_minplus,
    spmv_minplus_reference,
    spmv_sum,
    spmv_sum_reference,
)
from cugraph_tpu_torch.prims.cuda._partition import plan_for, sweep_plan, tiles_for
from cugraph_tpu_torch.utils.timer import setup_spans

GRAPHS = [  # v, e, skew, weighted
    (500, 4000, False, True),
    (300, 9000, True, True),  # heavy dsts + hub srcs
    (1000, 3000, False, False),
    (64, 200, False, True),  # single part
    (2500, 8000, False, True),  # multiple output windows
]


def _rand_graph(seed, v, e, skew, weighted):
    rng = np.random.default_rng(seed)
    if skew:
        srcs = (rng.zipf(1.5, e) % v).astype(np.int64)
        dsts = (rng.zipf(1.3, e) % v).astype(np.int64)
    else:
        srcs = rng.integers(0, v, e).astype(np.int64)
        dsts = rng.integers(0, v, e).astype(np.int64)
    wts = rng.normal(size=e).astype(np.float32) if weighted else None
    x = rng.normal(size=v).astype(np.float32)
    return srcs, dsts, wts, x


def _oracle_sum(dsts, srcs, wts, x, v):
    y = np.zeros(v, np.float64)
    w = np.ones(len(dsts)) if wts is None else wts.astype(np.float64)
    np.add.at(y, dsts, w * x[srcs].astype(np.float64))
    return y


def _oracle_min(dsts, srcs, wts, x, v):
    y = np.full(v, np.inf)
    w = np.zeros(len(dsts)) if wts is None else wts
    np.minimum.at(y, dsts, w + x[srcs])
    return y


def _rel_err(y, oracle):
    return np.max(np.abs(y - oracle) / np.maximum(np.abs(oracle), 1.0))


def _port(srcs, dsts, wts, x, v, reduce):
    g = ct.from_edgelist(srcs, dsts, wts, num_vertices=v, device="cpu")
    fn = spmv_sum if reduce == "sum" else spmv_minplus
    return fn(g.csc(), torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("i", range(len(GRAPHS)))
def test_spmv_sum_plain_matches_oracle(i):
    v, e, skew, weighted = GRAPHS[i]
    srcs, dsts, wts, x = _rand_graph(i, v, e, skew, weighted)
    y = _port(srcs, dsts, wts, x, v, "sum")
    assert y.dtype == np.float32
    assert _rel_err(y, _oracle_sum(dsts, srcs, wts, x, v)) < 1e-5


# interpret-mode runs take seconds each: the skewed, the single-part and
# the multi-window graphs
@pytest.mark.parametrize("i", [1, 3, 4])
def test_spmv_sum_plain_matches_keyed_interpret(i):
    v, e, skew, weighted = GRAPHS[i]
    srcs, dsts, wts, x = _rand_graph(i, v, e, skew, weighted)
    lay = build_keyed_layout(dsts, srcs, wts, v, TINY3)
    keyed = np.asarray(keyed_spmv_jit(lay, jnp.asarray(x), interpret=True))
    assert _rel_err(_port(srcs, dsts, wts, x, v, "sum"), keyed) < 2e-4


def _pull_graphs():
    """(srcs, dsts, weights, v): weighted, unweighted, one hub destination
    that splits into sub-windows, and destinations whose rows are empty."""
    rng = np.random.default_rng(11)
    hub_src = rng.integers(0, 300, 3200)
    hub_dst = np.concatenate([np.zeros(3000, np.int64), rng.integers(0, 300, 200)])
    return {
        "weighted": (rng.integers(0, 500, 3000), rng.integers(0, 500, 3000),
                     rng.normal(size=3000).astype(np.float32), 500),
        "unweighted": (rng.integers(0, 400, 2500), rng.integers(0, 400, 2500), None, 400),
        "hub": (hub_src, hub_dst, rng.random(3200).astype(np.float32), 300),
        "empty_rows": (rng.integers(0, 600, 1500), rng.integers(0, 250, 1500),
                       rng.random(1500).astype(np.float32), 600),
    }


@pytest.mark.parametrize("name", ["weighted", "unweighted", "hub", "empty_rows"])
def test_spmv_sum_plain_matches_v1_pull_interpret(name):
    srcs, dsts, wts, v = _pull_graphs()[name]
    g = ct.from_edgelist(srcs, dsts, wts, num_vertices=v, device="cpu")
    adj = g.csc()
    x = np.random.default_rng(12).normal(size=v).astype(np.float32)
    w = None if adj.weights is None else adj.weights.numpy()
    layout = build_pull_layout(adj.majors.numpy(), adj.minors.numpy(), w, v)
    v1 = np.asarray(pull_spmv(layout, jnp.asarray(x), interpret=True))
    got = spmv_sum(adj, torch.from_numpy(x)).numpy()
    size = _oracle_sum(dsts, srcs, None if wts is None else np.abs(wts), np.abs(x), v)
    assert np.all(np.abs(got - v1) <= 1e-5 * size)
    if name == "empty_rows":
        assert np.all(got[250:] == 0.0) and np.all(v1[250:] == 0.0)


@pytest.mark.parametrize("i", [0, 1, 4])
def test_spmv_minplus_plain_equals_oracle(i):
    v, e, skew, _ = GRAPHS[i]
    srcs, dsts, wts, x = _rand_graph(i, v, e, skew, True)
    y = _port(srcs, dsts, wts, x, v, "min")
    oracle = _oracle_min(dsts, srcs, wts, x, v).astype(np.float32)
    np.testing.assert_array_equal(y, oracle)  # +inf where no in-edge


def test_spmv_minplus_plain_equals_keyed_interpret():
    v, e, skew, _ = GRAPHS[1]
    srcs, dsts, wts, x = _rand_graph(1, v, e, skew, True)
    lay = build_keyed_layout(
        dsts, srcs, wts, v, TINY3, pad_weight=float("inf"), reduce="min"
    )
    keyed = np.asarray(keyed_spmv_jit(lay, jnp.asarray(x), interpret=True))
    np.testing.assert_array_equal(_port(srcs, dsts, wts, x, v, "min"), keyed)


def test_spmv_minplus_bfs_contract():
    """x = (id if in frontier else inf) over the unweighted CSC: y = the
    smallest in-frontier in-neighbour id, +inf where there is none
    (tests/test_spmv3.py:88-103)."""
    rng = np.random.default_rng(5)
    v, e = 400, 3000
    srcs, dsts = rng.integers(0, v, e), rng.integers(0, v, e)
    frontier = rng.random(v) < 0.1
    x = np.where(frontier, np.arange(v, dtype=np.float32), np.inf).astype(np.float32)
    g = ct.from_edgelist(srcs, dsts, num_vertices=v, device="cpu")
    y = spmv_minplus(g.csc(), torch.from_numpy(x), use_weights=False).numpy()
    oracle = _oracle_min(dsts, srcs, None, x, v).astype(np.float32)
    np.testing.assert_array_equal(y, oracle)
    lay = build_keyed_layout(
        dsts, srcs, np.zeros(e, np.float32), v, TINY3,
        pad_weight=float("inf"), reduce="min",
    )
    keyed = np.asarray(keyed_spmv_jit(lay, jnp.asarray(x), interpret=True))
    np.testing.assert_array_equal(y, keyed)


def test_spmv_empty_rows_zero_and_inf():
    """Vertices with no in-edges: 0 under sum, +inf under min."""
    rng = np.random.default_rng(6)
    v = 700
    srcs = rng.integers(0, v, 2000)
    dsts = rng.integers(0, v // 2, 2000)  # top half has no in-edge
    x = rng.normal(size=v).astype(np.float32)
    assert np.all(_port(srcs, dsts, None, x, v, "sum")[v // 2:] == 0.0)
    assert np.all(np.isposinf(_port(srcs, dsts, None, x, v, "min")[v // 2:]))


@pytest.mark.parametrize("direction", ["incoming", "outgoing"])
@pytest.mark.parametrize("op", ["PLUS", "MINIMUM", "MAXIMUM"])
def test_per_v_transform_reduce_matches_jax(direction, op):
    """The generic gather -> e_op -> reduce-by-major prim; vertices with
    no edge in that direction get the identity (0, +inf, -inf)."""
    v, e, skew, _ = GRAPHS[1]
    srcs, dsts, wts, x = _rand_graph(7, v, e, skew, True)
    xd = np.random.default_rng(8).normal(size=v).astype(np.float32)

    def e_op(s, d, sv, dv, w):
        return sv * w + dv

    name = f"per_v_transform_reduce_{direction}_e"
    jg = cg.from_edgelist(srcs, dsts, wts, num_vertices=v)
    want = np.asarray(getattr(jprims, name)(
        jg, e_op, reduce_op=getattr(jprims, op), src_values=x, dst_values=xd
    ))
    tg = ct.from_edgelist(srcs, dsts, wts, num_vertices=v, device="cpu")
    got = getattr(tprims, name)(
        tg, e_op, reduce_op=getattr(tprims, op),
        src_values=torch.from_numpy(x), dst_values=torch.from_numpy(xd),
    ).numpy()
    # min/max are exact; sums add f32 in another order
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------- column segments

# (graph of GRAPHS, "gap": sources avoiding the minors [200, 300), "kron": a
# Graph500 Kronecker graph, "kron_w" the same weighted, or "star": one hub
# joined both ways to every vertex, width): even ranges, an uneven last
# range, a range of one minor, an empty range; ranges whose rows are mostly
# empty (Kron's) and a first range whose every row has an edge (the star's)
SEGMENT_CASES = [(0, 250), (0, 167), (1, 75), (1, 299), (2, 128), (2, 999), (4, 600),
                 (4, 7), ("gap", 100), ("gap", 150), ("kron", 128), ("kron", 341),
                 ("kron_w", 100), ("star", 120), ("star", 1)]
# the share of the rows a later range must have an edge in to stay dense: 0
# keeps every range dense, 2 makes every range after the first hypersparse
SHARES = [0.0, _partition.SEGMENT_HYPERSPARSE_SHARE, 2.0]
IPT = _partition.SUM_ITEMS_PER_THREAD
MIB = 1 << 20


def _ranges(adj, width, share):
    return sweep_plan(adj, width, share, IPT).ranges


def _kron_edges(rng, scale, edge_factor=16, abc=(0.57, 0.19, 0.19)):
    """Graph500's Kronecker generator, ids permuted: (srcs, dsts)."""
    n = edge_factor << scale
    a, b, c = abc
    srcs = np.zeros(n, np.int64)
    dsts = np.zeros(n, np.int64)
    for bit in range(scale):
        r = rng.random(n)
        down = r >= a + b  # the quadrants c and d
        right = ((r >= a) & (r < a + b)) | (r >= a + b + c)  # b and d
        srcs |= down.astype(np.int64) << bit
        dsts |= right.astype(np.int64) << bit
    perm = rng.permutation(1 << scale)
    return perm[srcs], perm[dsts]


def _segment_graph(case):
    if case == "gap":
        rng = np.random.default_rng(21)
        v = 600
        srcs = rng.integers(0, v - 100, 5000)
        srcs = np.where(srcs >= 200, srcs + 100, srcs)  # no minor in [200, 300)
        dsts = (rng.random(5000) ** 2 * (v - 50)).astype(np.int64)  # rows empty at the top
        wts = rng.normal(size=5000).astype(np.float32)
        return ct.from_edgelist(srcs, dsts, wts, num_vertices=v, device="cpu").csc()
    if case in ("kron", "kron_w"):
        rng = np.random.default_rng(22)
        srcs, dsts = _kron_edges(rng, 10)
        wts = rng.random(srcs.size).astype(np.float32) if case == "kron_w" else None
        g = ct.from_edgelist(srcs, dsts, wts, num_vertices=1 << 10, symmetrize=True, device="cpu")
        return g.csc()
    if case == "star":
        v = 500
        others = np.arange(1, v)
        srcs = np.concatenate([others, np.zeros(v - 1, np.int64)])
        dsts = np.concatenate([np.zeros(v - 1, np.int64), others])
        wts = np.random.default_rng(23).normal(size=srcs.size).astype(np.float32)
        return ct.from_edgelist(srcs, dsts, wts, num_vertices=v, device="cpu").csc()
    v, e, skew, weighted = GRAPHS[case]
    srcs, dsts, wts, _ = _rand_graph(case, v, e, skew, weighted)
    return ct.from_edgelist(srcs, dsts, wts, num_vertices=v, device="cpu").csc()


def _majors(offsets):
    deg = (offsets[1:] - offsets[:-1]).long()
    return torch.repeat_interleave(torch.arange(deg.numel(), dtype=torch.int32), deg)


def _seg_majors(seg):
    """The major of each of the range's edges, dense or hypersparse."""
    local = _majors(seg.offsets)
    return local if seg.row_ids is None else seg.row_ids[local.long()]


def _as_adj(adj, seg):
    """The range as an adjacency over the rows it sweeps."""
    return CompressedAdj(seg.offsets, seg.minors, _majors(seg.offsets), seg.weights,
                         seg.num_rows, adj.num_minors, seg.num_edges)


def _plain_by_segments(adj, x, segs, reduce, use_weights=True):
    """The plain version over each range, combined in range order as the
    kernels' accumulate mode combines them: the first range (dense) writes
    every row, each later one combines into the rows it sweeps."""
    plain = spmv_sum_reference if reduce == "sum" else spmv_minplus_reference
    combine = torch.add if reduce == "sum" else torch.fmin
    y = None
    for seg in segs:
        part = plain(_as_adj(adj, seg), x, use_weights=use_weights)
        rows = torch.arange(adj.num_majors) if seg.row_ids is None else seg.row_ids.long()
        if y is None:
            y = part
        else:
            y[rows] = combine(y[rows], part)
    return y


@pytest.mark.parametrize("case,width", SEGMENT_CASES)
def test_segments_partition_the_edges(case, width):
    adj = _segment_graph(case)
    v, n = adj.num_majors, adj.num_minors
    for share in SHARES:
        segs = _ranges(adj, width, share)
        assert ([(s.lo, s.hi) for s in segs]
                == [(lo, min(lo + width, n)) for lo in range(0, n, width)])
        assert sum(s.num_edges for s in segs) == adj.num_edges
        for i, s in enumerate(segs):
            keep = (adj.minors >= s.lo) & (adj.minors < s.hi)
            counts = torch.bincount(adj.majors[keep].long(), minlength=v)
            nonempty = int((counts > 0).sum())
            # the first range dense whatever its share
            assert (s.row_ids is None) == (i == 0 or nonempty >= share * v)
            assert s.offsets.dtype == s.minors.dtype == torch.int32
            assert s.offsets.shape == (s.num_rows + 1,) and int(s.offsets[0]) == 0
            if s.row_ids is None:
                assert s.num_rows == v
                assert torch.equal(s.offsets[1:] - s.offsets[:-1], counts.int())
            else:  # exactly the majors with an edge here, ascending, each non-empty
                assert s.row_ids.dtype == torch.int32 and s.num_rows == nonempty
                assert torch.equal(s.row_ids.long(), torch.nonzero(counts).flatten())
                assert torch.equal(s.offsets[1:] - s.offsets[:-1], counts[counts > 0].int())
            assert int(s.offsets[-1]) == s.num_edges == s.minors.numel() == int(keep.sum())
            # the range's edges in the CSC's (major, minor) order, with their weights
            assert torch.equal(s.minors, adj.minors[keep])
            assert torch.equal(_seg_majors(s), adj.majors[keep])
            key = _seg_majors(s).long() * n + s.minors.long()
            assert bool((key[1:] >= key[:-1]).all())
            if adj.weights is None:
                assert s.weights is None
            else:
                assert torch.equal(s.weights, adj.weights[keep])
        # the ranges concatenated and put back in (major, minor) order are the CSC
        majors = torch.cat([_seg_majors(s) for s in segs])
        minors = torch.cat([s.minors for s in segs])
        order = torch.sort(majors.long() * n + minors.long(), stable=True).indices
        assert torch.equal(majors[order], adj.majors) and torch.equal(minors[order], adj.minors)
        if adj.weights is not None:
            assert torch.equal(torch.cat([s.weights for s in segs])[order], adj.weights)
        if case == "gap" and width == 100:  # the range [200, 300) holds no edge
            assert (segs[2].lo, segs[2].hi, segs[2].num_edges) == (200, 300, 0)
            assert share == 0.0 or segs[2].num_rows == 0


@pytest.mark.parametrize("reduce", ["sum", "min", "min_unweighted", "bfs"])
@pytest.mark.parametrize("case,width", SEGMENT_CASES)
def test_plain_by_segments_matches_unsegmented(case, width, reduce):
    """Every form of the ranges, walked as the wrapper walks them, gives
    the unsegmented result: 0 (sum) and +inf (min) exactly on the rows
    with no edge in any range."""
    adj = _segment_graph(case)
    v = adj.num_minors
    rng = np.random.default_rng(31)
    x = torch.from_numpy(rng.normal(size=v).astype(np.float32))
    empty = (adj.offsets[1:] == adj.offsets[:-1]).numpy()
    for share in SHARES:
        segs = _ranges(adj, width, share)
        if reduce == "sum":
            y = _plain_by_segments(adj, x, segs, "sum")
            want = spmv_sum_reference(adj, x.double())
            w = None if adj.weights is None else adj.weights.abs()
            size = spmv_sum_reference(dataclasses.replace(adj, weights=w), x.double().abs())
            assert bool(((y.double() - want).abs() <= 1e-5 * size).all())
            assert bool((y[size == 0] == 0).all())
            assert bool((y[empty] == 0).all())
            continue
        use_weights = reduce == "min"
        xm = x
        if reduce == "bfs":  # a BFS sweep's x: the id in the frontier, +inf elsewhere
            xm = torch.where(torch.from_numpy(np.random.default_rng(32).random(v) < 0.1),
                             torch.arange(v, dtype=torch.float32), float("inf"))
        y = _plain_by_segments(adj, xm, segs, "min", use_weights)
        want = spmv_minplus_reference(adj, xm, use_weights=use_weights)
        assert torch.equal(y, want)  # bit for bit, +inf pattern included
        assert bool(torch.isposinf(y[empty]).all())


@pytest.mark.parametrize("rows", ["all", "one", "below", "at"])
def test_segment_form_follows_the_share(rows):
    """A later range is hypersparse where fewer than
    SEGMENT_HYPERSPARSE_SHARE of the majors have an edge in it, else
    dense: of 40 majors, all of them, one, one fewer than the share and
    the share itself. The first range stays dense with its one row."""
    at = int(np.ceil(_partition.SEGMENT_HYPERSPARSE_SHARE * 40))
    n = {"all": 40, "one": 1, "below": at - 1, "at": at}[rows]
    dense = rows in ("all", "at")
    srcs = np.concatenate([[3], np.full(n, 30)])  # minors 3 and 30
    dsts = np.concatenate([[5], np.arange(n) * 40 // n])  # one row, then n distinct rows
    adj = ct.from_edgelist(srcs, dsts, num_vertices=40, device="cpu").csc()
    first, second = _ranges(adj, 20, _partition.SEGMENT_HYPERSPARSE_SHARE)
    assert first.row_ids is None and (first.num_rows, first.num_edges) == (40, 1)
    assert (second.row_ids is None) == dense
    assert second.num_rows == (40 if dense else n) and second.num_edges == n


def _segment_spans_since(t0):
    return [s for s in setup_spans()
            if s["name"] == "cgt/setup.spmv_segments" and s["start_s"] >= t0]


def test_segments_cached_under_a_setup_span(monkeypatch):
    """The one cache of an adjacency: plan_for builds the rule's plan at
    the first sweep, cutting its ranges under a set-up span that counts
    the rows the sweeps walk against K passes over every major, and the
    hypersparse ranges, and keeps it beside spmm_rows' tile plans; a
    plan of a forced width (sweep_plan) is built anew, under its own span,
    and kept nowhere."""
    # an L2 that gives the star (x of 2,000 bytes, 998 edges) K = 10
    monkeypatch.setattr(_partition, "SEGMENT_MIN_DEGREE", 1)
    monkeypatch.setattr(_partition, "_l2_bytes", lambda index: 466)
    adj = _segment_graph("star")
    share = _partition.SEGMENT_HYPERSPARSE_SHARE
    t0 = time.perf_counter()
    plan = plan_for(adj)
    assert plan_for(adj) is plan and len(_segment_spans_since(t0)) == 1
    tiles = tiles_for(adj, 64)
    assert tiles_for(adj, 64) is tiles and tiles_for(adj, 128) is not tiles
    assert plan_for(adj) is plan and "_plans" not in repr(adj)
    forced = sweep_plan(adj, 50, share, IPT)
    assert forced is not plan and plan_for(adj) is plan
    kept = _segment_spans_since(t0)
    assert len(kept) == 2
    # the star at width 50: range 0 holds the hub's row and every edge out
    # of vertex 0 (dense); each later range, the hub's row alone
    for span_, p in zip(kept, (plan, forced)):
        assert span_["counters"] == {"rows_swept": 500 + 9, "rows_dense": 10 * 500,
                                     "hypersparse_segments": 9}
        assert [r.num_rows for r in p.ranges] == [500] + [1] * 9
        assert [(r.lo, r.hi) for r in p.ranges] == [(lo, lo + 50) for lo in range(0, 500, 50)]
    # the cache neither enters equality nor survives dataclasses.replace
    other = dataclasses.replace(adj)
    assert other == adj and plan_for(other) is not plan
    with pytest.raises(ValueError):
        sweep_plan(adj, 0, share, IPT)


@pytest.mark.parametrize("extra", [0, 1, 1000])
def test_one_range_plan_is_the_adjacency(extra):
    """Where one range covers every minor (K = 1), the plan is one dense
    range over the adjacency's own tensors, no copy, and cuts nothing
    under the segments' span."""
    adj = _segment_graph(0)
    t0 = time.perf_counter()
    plan = sweep_plan(adj, adj.num_minors + extra, 2.0, IPT)
    (r,) = plan.ranges
    assert (r.lo, r.hi, r.row_ids, r.num_rows, r.num_edges) == (
        0, adj.num_minors, None, adj.num_majors, adj.num_edges)
    for mine, own in ((r.offsets, adj.offsets), (r.minors, adj.minors), (r.weights, adj.weights)):
        assert mine.data_ptr() == own.data_ptr()
    assert not _segment_spans_since(t0)


def test_rule_plan_of_the_graphs(monkeypatch):
    """plan_for on an H100's 50 MiB L2: K = 1 (the adjacency itself) at
    small graphs, and on an L2 cut to K = 3 at the same graph, ranges of
    ceil(V / 3) minors, later ones by the rule's share."""
    adj = _segment_graph(1)  # 300 vertices, 9,000 edges
    monkeypatch.setattr(_partition, "_l2_bytes", lambda index: 50 * MIB)
    (r,) = plan_for(adj).ranges
    assert r.offsets.data_ptr() == adj.offsets.data_ptr()
    monkeypatch.setattr(_partition, "_l2_bytes", lambda index: 931)  # a budget of 400 bytes
    adj = _segment_graph(1)
    plan = plan_for(adj)
    assert [(r.lo, r.hi) for r in plan.ranges] == [(0, 100), (100, 200), (200, 300)]
    assert plan.items_per_thread == IPT


@pytest.mark.parametrize("ipt", [IPT, 1])
@pytest.mark.parametrize("case,width", [(1, 75), ("kron", 128), ("star", 120)])
def test_plan_tiles_and_carries(case, width, ipt):
    """Each range carries the merge-path tiles of its own offsets at
    SUM_THREADS * ipt items a tile, and n_tiles, the rows of the carries
    the ranges share, is the most tiles of any range."""
    adj = _segment_graph(case)
    plan = sweep_plan(adj, width, _partition.SEGMENT_HYPERSPARSE_SHARE, ipt)
    items = _partition.SUM_THREADS * ipt
    assert plan.items_per_thread == ipt
    for r in plan.ranges:
        want = _partition.merge_path_tiles(r.offsets, r.num_edges, items)
        assert torch.equal(r.tile_row, want[0]) and torch.equal(r.tile_edge, want[1])
    assert plan.n_tiles == max(r.tile_row.numel() - 1 for r in plan.ranges)
    assert plan.n_tiles == max(-(-(r.num_rows + r.num_edges) // items) for r in plan.ranges)



@pytest.mark.parametrize("l2", [50 * MIB, 40 * MIB, 6 * MIB])
def test_segment_count_rule(l2):
    budget = int(l2 * _partition.SEGMENT_L2_SHARE)
    at = budget // 4  # x of exactly the budget
    dense = lambda n: _partition.SEGMENT_MIN_DEGREE * n  # noqa: E731
    assert _partition.segment_count(at, dense(at), at, l2) == 1
    assert _partition.segment_count(at - 1, dense(at), at, l2) == 1
    for n in (at + 1, 3 * at, 3 * at + 5, 10 * at):
        k = _partition.segment_count(n, dense(n), n, l2)
        assert k == -(-4 * n // budget) and k >= 2
        # too sparse to pay for K passes over the rows
        assert _partition.segment_count(n, dense(n) - 1, n, l2) == 1
    assert _partition.segment_count(0, 0, 0, l2) == 1


def test_segment_count_on_the_graphs_in_use():
    """With an H100's 50 MiB L2: K = 1 at RMAT scale 21 (chip_smoke.py's
    graphs), K = 3 on the benchmark's scale-24 graphs of degree 32."""
    l2 = 50 * MIB
    assert _partition.segment_count(1 << 21, 1 << 25, 1 << 21, l2) == 1
    assert _partition.segment_count(1 << 24, 520_757_134, 1 << 24, l2) == 3
