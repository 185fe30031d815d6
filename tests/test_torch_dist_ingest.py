"""The streamed multi-card ingest (``dist/mg_graph.py:distribute_edgelist_chunks``)
on gloo meshes: with ``symmetrize=True`` each rank stores each distinct
ordered pair of its blocks once, as the single-shot
``distribute_edgelist(symmetrize=True)`` and a plain reference do, and
``mg_pagerank`` on that graph carries the single-device loop's spans.

The stream is a Graph500 Kronecker draw at scale 9 (0.57, 0.19, 0.19,
ids permuted, numpy) in chunks of uneven length, with parallel pairs
across every chunk boundary (a tuple repeated, and reversed, at the next
chunk's head) and self-loops, some repeated. The plain reference is numpy
alone: the distinct pairs of both directions of every tuple, each placed
on its rank by the 2D layout's contract (``dist/partition.py``), and
float64 PageRank over them. The ranks run in spawned processes
(``_torch_dist_worker.run_ingest``), one spawn a mesh.
"""

import functools

import numpy as np
import pytest

import _torch_dist_worker as worker
from cugraph_tpu_torch.dist.mg_algos import PAGERANK_LOOKAHEAD

SCALE = 9
V = 1 << SCALE
EDGE_FACTOR = 8
CUTS = [0, 700, 1500, 2600, 3300, EDGE_FACTOR * V]  # uneven chunks
LANE = 128
ALPHA, ITERATIONS = 0.85, 20
MESHES = [(2, 2), (2, 1)]

meshes = pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")


@functools.lru_cache(maxsize=None)
def _stream():
    """The chunks, [(src int32, dst int32, weight float32)]."""
    rng = np.random.default_rng(27)
    a, b, c = 0.57, 0.19, 0.19
    m = EDGE_FACTOR * V
    src = np.zeros(m, np.int64)
    dst = np.zeros(m, np.int64)
    for _ in range(SCALE):
        sbit = rng.random(m) < 1 - a - b
        dbit = rng.random(m) < np.where(sbit, (1 - a - b - c) / (1 - a - b), b / (a + b))
        src, dst = 2 * src + sbit, 2 * dst + dbit
    perm = rng.permutation(V)
    src, dst = perm[src], perm[dst]
    chunks = []
    for k, (lo, hi) in enumerate(zip(CUTS, CUTS[1:])):
        s, d = src[lo:hi], dst[lo:hi]
        if k:  # the last tuple of the chunk before, as drawn and reversed
            ps, pd = src[lo - 1], dst[lo - 1]
            s, d = np.concatenate([[ps, pd], s]), np.concatenate([[pd, ps], d])
        loops = np.array([k, k, 3], np.int64)  # (k, k) twice, (3, 3) in every chunk
        s, d = np.concatenate([s, loops]), np.concatenate([d, loops])
        w = (0.5 + rng.random(len(s))).astype(np.float32)
        chunks.append((s.astype(np.int32), d.astype(np.int32), w))
    return chunks


@functools.lru_cache(maxsize=None)
def _ranks(shape):
    return worker.spawn(worker.run_ingest, shape[0] * shape[1], shape, _stream(), V)


def _rank(shape, i, j):
    return _ranks(shape)[i * shape[1] + j]


@functools.lru_cache(maxsize=None)
def _pairs():
    """The reference's distinct ordered pairs (sorted keys u * V + v) and
    each one's smallest weight."""
    s = np.concatenate([c[0] for c in _stream()]).astype(np.int64)
    d = np.concatenate([c[1] for c in _stream()]).astype(np.int64)
    w = np.concatenate([c[2] for c in _stream()])
    keys = np.concatenate([s * V + d, d * V + s])
    ww = np.concatenate([w, w])
    uniq, inverse = np.unique(keys, return_inverse=True)
    wmin = np.full(len(uniq), np.inf, np.float32)
    np.minimum.at(wmin, inverse, ww)
    return uniq, wmin, len(keys)


def _reference_blocks(shape, i, j):
    """Rank (i, j)'s in_block and out_block of the reference's pairs, by
    the layout's contract: dst range q = dst // vp gives i = q % R and
    block b = q // R, src's column span gives j; major b * vp + dst % vp,
    minor src - j * R * vp."""
    rows, cols = shape
    vp = -(-V // (rows * cols))
    keys, wmin, _ = _pairs()
    u, v = keys // V, keys % V
    q = v // vp
    mine = (q % rows == i) & (u // (rows * vp) == j)
    major = (q // rows * vp + v % vp)[mine]
    minor = (u - j * rows * vp)[mine]
    w = wmin[mine]
    out = {}
    for name, hi, lo, n_hi in (("in_block", major, minor, cols * vp),
                               ("out_block", minor, major, rows * vp)):
        order = np.lexsort((lo, hi))
        out[name] = dict(offsets=np.searchsorted(hi[order], np.arange(n_hi + 1)).astype(np.int32),
                         minors=lo[order].astype(np.int32), majors=hi[order].astype(np.int32),
                         weights=w[order])
    return out


def _assert_blocks_equal(got, want, weights=True):
    for name in ("in_block", "out_block"):
        for key in ("offsets", "minors", "majors") + (("weights",) if weights else ()):
            a, b = got[name][key], want[name][key]
            assert (a is None) == (b is None), (name, key)
            if a is not None:
                assert a.dtype == b.dtype, (name, key)
                np.testing.assert_array_equal(a, b, err_msg=f"{name}.{key}")


def _every_rank(shape):
    return [(i, j) for i in range(shape[0]) for j in range(shape[1])]


@meshes
@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
def test_streamed_equals_single_shot(shape, weighted):
    """Rank by rank, bit for bit: blocks, block counts, num_edges, d_pad."""
    suffix = "_weighted" if weighted else ""
    for i, j in _every_rank(shape):
        r = _rank(shape, i, j)
        got, want = r["streamed" + suffix], r["single_shot" + suffix]
        _assert_blocks_equal(got, want)
        np.testing.assert_array_equal(got["block_counts"], want["block_counts"])
        for key in ("num_edges", "d_pad", "vp", "is_symmetric"):
            assert got[key] == want[key], key
        assert got["is_symmetric"] is True


@meshes
@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
def test_streamed_equals_plain_reference(shape, weighted):
    """Each rank holds the reference's distinct pairs of its blocks, in
    order; a weighted pair keeps its smallest weight."""
    for i, j in _every_rank(shape):
        got = _rank(shape, i, j)["streamed_weighted" if weighted else "streamed"]
        want = _reference_blocks(shape, i, j)
        _assert_blocks_equal(got, want, weights=weighted)
        if not weighted:
            assert got["in_block"]["weights"] is None


@meshes
def test_counts_are_the_coalesced_graphs(shape):
    """num_edges, block_counts and d_pad of the coalesced graph; the stream
    does repeat pairs, and the ranks' dropped pairs add up to them."""
    keys, _, emitted = _pairs()
    assert emitted - len(keys) > 0
    vp = _rank(shape, 0, 0)["streamed"]["vp"]
    counts, dropped = [], 0
    for i, j in _every_rank(shape):
        r = _rank(shape, i, j)
        got = r["streamed"]
        assert got["num_edges"] == len(keys)
        majors = _reference_blocks(shape, i, j)["in_block"]["majors"]
        np.testing.assert_array_equal(got["block_counts"],
                                      np.bincount(majors // vp, minlength=shape[1]))
        counts.append(len(majors))
        (coalesce,) = [s for s in r["setup_spans"] if s["name"] == "cgt/ingest.coalesce"]
        dropped += coalesce["counters"]["dropped_pairs"]
    assert sum(counts) == len(keys)
    assert dropped == emitted - len(keys)
    for i, j in _every_rank(shape):
        assert _rank(shape, i, j)["streamed"]["d_pad"] == -(-max(counts) // LANE) * LANE


@meshes
def test_multigraph_ingest_keeps_parallel_edges(shape):
    """symmetrize=False streams every tuple as stored, parallel edges kept,
    as the single-shot ingest of the concatenated chunks does."""
    tuples = sum(len(c[0]) for c in _stream())
    for i, j in _every_rank(shape):
        r = _rank(shape, i, j)
        _assert_blocks_equal(r["multigraph"], r["multigraph_single_shot"])
        assert r["multigraph"]["num_edges"] == tuples
        assert r["multigraph"]["d_pad"] == r["multigraph_single_shot"]["d_pad"]
        assert r["multigraph"]["is_symmetric"] is False


def _reference_pagerank(tol=0.0, max_iterations=ITERATIONS):
    """(scores, iterations) of float64 PageRank over the reference's pairs,
    stopping as ``mg_pagerank`` does: once the L1 change is at most V * tol."""
    keys, _, _ = _pairs()
    u, v = keys // V, keys % V
    deg = np.bincount(u, minlength=V).astype(np.float64)
    dangling = deg == 0
    inv = np.where(dangling, 0.0, 1.0 / np.where(dangling, 1.0, deg))
    pr, it, diff = np.full(V, 1.0 / V), 0, np.inf
    while diff > V * tol and it < max_iterations:
        agg = np.bincount(v, weights=(pr * inv)[u], minlength=V)
        new = ALPHA * (agg + pr[dangling].sum() / V) + (1.0 - ALPHA) / V
        diff, pr, it = np.abs(new - pr).sum(), new, it + 1
    return pr, it


@meshes
def test_pagerank_on_the_streamed_graph(shape):
    """Each rank's range of ``mg_pagerank`` on the streamed symmetric graph
    within 1e-5 relative of float64 PageRank over the reference's pairs."""
    want, _ = _reference_pagerank()
    rows, cols = shape
    for i, j in _every_rank(shape):
        scores, iterations = _rank(shape, i, j)["pagerank"]
        assert iterations == ITERATIONS
        vp = len(scores)
        lo = (j * rows + i) * vp
        hi = min(lo + vp, V)
        np.testing.assert_array_less(np.abs(scores[:hi - lo] - want[lo:hi]) / want[lo:hi], 1e-5)
        assert not scores[hi - lo:].any()


@meshes
def test_pagerank_spans(shape):
    """One call span, one step, one host read and one ``spmv_sum`` an
    iteration; a collective span a collective: each iteration's
    all-gather, reduce-scatter and two all-reduces, and the out-weight
    sums' reduce-scatter before the loop."""
    for i, j in _every_rank(shape):
        counts = _rank(shape, i, j)["span_counts"]
        assert counts == {
            "cgt/algorithms.pagerank": 1,
            "cgt/step.pagerank.iteration": ITERATIONS,
            "cgt/sync.pagerank.diff": ITERATIONS,
            "cgt/kernel.spmv_sum": ITERATIONS,
            "cgt/collective.all_gather": ITERATIONS,
            "cgt/collective.reduce_scatter": ITERATIONS + 1,
            "cgt/collective.all_reduce": 2 * ITERATIONS,
        }


@meshes
def test_ingest_set_up_spans(shape):
    """The coalescing, then both blocks' compression, each a set-up span,
    after the chunk loop: no chunk was drawn inside either."""
    for i, j in _every_rank(shape):
        r = _rank(shape, i, j)
        spans = [s for s in r["setup_spans"] if s["name"].startswith("cgt/ingest.")]
        assert [s["name"] for s in spans] == ["cgt/ingest.coalesce", "cgt/ingest.compress"]
        coalesce, compress = spans
        assert coalesce["end_s"] <= compress["start_s"]
        assert len(r["drawn"]) == 2 * len(_stream())
        assert max(r["drawn"]) <= coalesce["start_s"]
        assert coalesce["counters"]["dropped_pairs"] > 0
        # no device memory to count on the CPU
        assert "counters" not in compress and coalesce["device_s"] is None


@meshes
def test_pagerank_stopping_on_the_tolerance(shape):
    """A call that stops on the tolerance runs the iterations of the
    float64 loop with the same stop, and launches ``PAGERANK_LOOKAHEAD``
    more (queued before the last change was read, then dropped): that many
    more SpMVs and all-gathers, and twice as many more all-reduces, than
    steps."""
    _, want_it = _reference_pagerank(tol=1e-4, max_iterations=100)
    assert want_it + PAGERANK_LOOKAHEAD < 100
    for i, j in _every_rank(shape):
        r = _rank(shape, i, j)
        _, iterations = r["pagerank_tol"]
        assert iterations == want_it
        launched = iterations + PAGERANK_LOOKAHEAD
        counts = r["span_counts_tol"]
        assert counts["cgt/step.pagerank.iteration"] == counts["cgt/sync.pagerank.diff"] == iterations
        assert counts["cgt/kernel.spmv_sum"] == counts["cgt/collective.all_gather"] == launched
        assert counts["cgt/collective.all_reduce"] == 2 * launched
