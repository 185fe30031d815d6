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

Column segments (prims/cuda/_partition.py:column_segments): the plan cuts
a CSC by its minors into ranges of a given width, each range's edges in
the CSC's order with their weights and offsets of their own; the rule
(spmv.segment_count) gives K = 1 while x fits its share of the L2 and
ceil(x bytes / budget) above; the plain versions run range by range and
combined in range order (+ for the sum, fmin for the min, the kernels'
accumulate mode) give spmv_sum's result within f32 rounding and
spmv_minplus' bit for bit.
"""

import dataclasses

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
    spmv,
    spmv_minplus,
    spmv_minplus_reference,
    spmv_sum,
    spmv_sum_reference,
)
from cugraph_tpu_torch.prims.cuda._partition import column_segments, segments_for
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

# (graph of GRAPHS, or "gap": sources avoiding the minors [200, 300), width):
# even ranges, an uneven last range, a range of one minor, an empty range
SEGMENT_CASES = [(0, 250), (0, 167), (1, 75), (1, 299), (2, 128), (2, 999), (4, 600),
                 (4, 7), ("gap", 100), ("gap", 150)]


def _segment_graph(case):
    if case == "gap":
        rng = np.random.default_rng(21)
        v = 600
        srcs = rng.integers(0, v - 100, 5000)
        srcs = np.where(srcs >= 200, srcs + 100, srcs)  # no minor in [200, 300)
        dsts = (rng.random(5000) ** 2 * (v - 50)).astype(np.int64)  # rows empty at the top
        wts = rng.normal(size=5000).astype(np.float32)
        return ct.from_edgelist(srcs, dsts, wts, num_vertices=v, device="cpu").csc()
    v, e, skew, weighted = GRAPHS[case]
    srcs, dsts, wts, _ = _rand_graph(case, v, e, skew, weighted)
    return ct.from_edgelist(srcs, dsts, wts, num_vertices=v, device="cpu").csc()


def _majors(offsets):
    deg = (offsets[1:] - offsets[:-1]).long()
    return torch.repeat_interleave(torch.arange(deg.numel(), dtype=torch.int32), deg)


def _as_adj(adj, seg):
    return CompressedAdj(seg.offsets, seg.minors, _majors(seg.offsets), seg.weights,
                         adj.num_majors, adj.num_minors, seg.num_edges)


def _plain_by_segments(adj, x, width, reduce, use_weights=True):
    """The plain version over each range, combined in range order as the
    kernels' accumulate mode combines them."""
    plain = spmv_sum_reference if reduce == "sum" else spmv_minplus_reference
    combine = torch.add if reduce == "sum" else torch.fmin
    y = None
    for seg in column_segments(adj, width):
        part = plain(_as_adj(adj, seg), x, use_weights=use_weights)
        y = part if y is None else combine(y, part)
    return y


@pytest.mark.parametrize("case,width", SEGMENT_CASES)
def test_segments_partition_the_edges(case, width):
    adj = _segment_graph(case)
    segs = column_segments(adj, width)
    v, n = adj.num_majors, adj.num_minors
    assert [(s.lo, s.hi) for s in segs] == [(lo, min(lo + width, n)) for lo in range(0, n, width)]
    assert sum(s.num_edges for s in segs) == adj.num_edges
    for s in segs:
        keep = (adj.minors >= s.lo) & (adj.minors < s.hi)
        assert s.offsets.dtype == s.minors.dtype == torch.int32
        assert s.offsets.shape == (v + 1,) and int(s.offsets[0]) == 0
        assert int(s.offsets[-1]) == s.num_edges == s.minors.numel() == int(keep.sum())
        # the range's edges in the CSC's (major, minor) order, with their weights
        assert torch.equal(s.minors, adj.minors[keep])
        assert torch.equal(_majors(s.offsets), adj.majors[keep])
        assert torch.equal(s.offsets[1:] - s.offsets[:-1],
                           torch.bincount(adj.majors[keep].long(), minlength=v).int())
        key = _majors(s.offsets).long() * n + s.minors.long()
        assert bool((key[1:] >= key[:-1]).all())
        if adj.weights is None:
            assert s.weights is None
        else:
            assert torch.equal(s.weights, adj.weights[keep])
    if case == "gap" and width == 100:  # the range [200, 300) holds no edge
        assert (segs[2].lo, segs[2].hi, segs[2].num_edges) == (200, 300, 0)


@pytest.mark.parametrize("reduce", ["sum", "min", "min_unweighted", "bfs"])
@pytest.mark.parametrize("case,width", SEGMENT_CASES)
def test_plain_by_segments_matches_unsegmented(case, width, reduce):
    adj = _segment_graph(case)
    v = adj.num_minors
    rng = np.random.default_rng(31)
    x = torch.from_numpy(rng.normal(size=v).astype(np.float32))
    if reduce == "sum":
        y = _plain_by_segments(adj, x, width, "sum")
        want = spmv_sum_reference(adj, x.double())
        w = None if adj.weights is None else adj.weights.abs()
        size = spmv_sum_reference(dataclasses.replace(adj, weights=w), x.double().abs())
        assert bool(((y.double() - want).abs() <= 1e-5 * size).all())
        assert bool((y[size == 0] == 0).all())
        return
    use_weights = reduce == "min"
    if reduce == "bfs":  # a BFS sweep's x: the id in the frontier, +inf elsewhere
        x = torch.where(torch.from_numpy(rng.random(v) < 0.1),
                        torch.arange(v, dtype=torch.float32), float("inf"))
    y = _plain_by_segments(adj, x, width, "min", use_weights)
    want = spmv_minplus_reference(adj, x, use_weights=use_weights)
    assert torch.equal(y, want)  # bit for bit, +inf pattern included


def test_segments_cached_under_a_setup_span():
    adj = _segment_graph(1)
    segs = segments_for(adj, 100)
    assert segments_for(adj, 100) is segs and segments_for(adj, 50) is not segs
    assert set(adj.segments) == {100, 50} and "segments" not in repr(adj)
    assert sum(s["name"] == "cgt/setup.spmv_segments" for s in setup_spans()) >= 2
    with pytest.raises(ValueError):
        column_segments(adj, 0)


MIB = 1 << 20


@pytest.mark.parametrize("l2", [50 * MIB, 40 * MIB, 6 * MIB])
def test_segment_count_rule(l2):
    budget = int(l2 * spmv.SEGMENT_L2_SHARE)
    at = budget // 4  # x of exactly the budget
    dense = lambda n: spmv.SEGMENT_MIN_DEGREE * n  # noqa: E731
    assert spmv.segment_count(at, dense(at), at, l2) == 1
    assert spmv.segment_count(at - 1, dense(at), at, l2) == 1
    for n in (at + 1, 3 * at, 3 * at + 5, 10 * at):
        k = spmv.segment_count(n, dense(n), n, l2)
        assert k == -(-4 * n // budget) and k >= 2
        # too sparse to pay for K passes over the rows
        assert spmv.segment_count(n, dense(n) - 1, n, l2) == 1
    assert spmv.segment_count(0, 0, 0, l2) == 1


def test_segment_count_on_the_graphs_in_use():
    """With an H100's 50 MiB L2: K = 1 at RMAT scale 21 (chip_smoke.py's
    graphs), K = 3 on the benchmark's scale-24 graphs of degree 32."""
    l2 = 50 * MIB
    assert spmv.segment_count(1 << 21, 1 << 25, 1 << 21, l2) == 1
    assert spmv.segment_count(1 << 24, 520_757_134, 1 << 24, l2) == 3
