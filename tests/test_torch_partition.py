"""The merge-path tile plan of spmv_sum, spmv_minplus and spmm_rows
(prims/cuda/_partition.py).

The plan is plain torch and runs here; the kernels that read it run only
on a card (chip_smoke.py holds them against their plain versions there).
These tests check the plan's invariants on graphs with a hub row, empty
rows at the start, in the middle and at the end, and rows that end exactly
on a tile boundary: every row and every edge lies in exactly one tile,
each tile holds items_per_tile items (the last one at most that), a hub
row spans about deg / items_per_tile tiles, and the diagonals do not wrap
when V + E passes 2^31. A numpy model of the kernels' carry rules (which
row goes straight to the output, which to carry slot 0 or 1, which tile
boundary combines a cut row's carries in tile order), for the sum and for
the min with its +inf identity, reproduces the float64 row sums and row
minima and writes every row exactly once; a row with no edges comes out
as the identity.
"""

import numpy as np
import pytest
import torch

from cugraph_tpu_torch.core.csr import CompressedAdj
from cugraph_tpu_torch.prims.cuda import _partition


def _offsets(degrees):
    return torch.from_numpy(np.concatenate([[0], np.cumsum(degrees)]).astype(np.int32))


def _adversarial_degrees(seed, v=400, hub=5000):
    """Empty first and last rows, a run of empty rows in the middle, one
    hub row and a long tail of short rows."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 6, v)
    deg[:3] = 0
    deg[-4:] = 0
    deg[150:170] = 0
    deg[7] = hub
    return deg


PLANS = [  # (seed, items_per_tile)
    (0, 64),
    (1, 97),  # V + E not a multiple of the tile
    (2, 256),
    (3, 1),
    (4, 5000),
]


@pytest.mark.parametrize("seed,k", PLANS)
def test_plan_covers_every_row_and_edge_once(seed, k):
    deg = _adversarial_degrees(seed)
    offsets = _offsets(deg)
    v, e = len(deg), int(deg.sum())
    rows, edges = (t.numpy().astype(np.int64) for t in _partition.merge_path_tiles(offsets, e, k))
    assert rows.dtype == edges.dtype and len(rows) == len(edges) == -(-(v + e) // k) + 1
    assert (rows[0], edges[0], rows[-1], edges[-1]) == (0, 0, v, e)
    assert (np.diff(rows) >= 0).all() and (np.diff(edges) >= 0).all()
    size = np.diff(rows) + np.diff(edges)
    assert (size[:-1] == k).all() and 0 < size[-1] <= k
    # the merge path: at each cut, the edge pointer lies inside the row in
    # progress, and every row before it has ended
    off = offsets.numpy().astype(np.int64)
    inner = rows[:-1]
    assert (off[inner] <= edges[:-1]).all() and (edges[:-1] <= off[inner + 1]).all()
    # each row's end marker lies in exactly one tile: the one whose row
    # range [rows[t], rows[t + 1]) holds it
    owner = np.searchsorted(rows, np.arange(v), side="right") - 1
    marker = off[1:] + np.arange(v)
    np.testing.assert_array_equal(owner, marker // k)


@pytest.mark.parametrize("k", [64, 256])
def test_hub_row_spans_many_tiles(k):
    deg = _adversarial_degrees(5, hub=1 << 14)
    offsets = _offsets(deg)
    e = int(deg.sum())
    rows, edges = (t.numpy() for t in _partition.merge_path_tiles(offsets, e, k))
    cut = (rows[:-1] == 7) & (rows[1:] == 7)  # tiles wholly inside the hub
    assert cut.sum() >= (1 << 14) // k - 2
    assert ((np.diff(edges)[cut]) == k).all()


def test_diagonals_are_int64():
    """V + E above 2^31: the diagonals and the searchsorted run in int64,
    and every start still fits int32."""
    big = 2**31 - 1
    offsets = torch.tensor([0, 2**30, big - 2, big - 2, big], dtype=torch.int32)
    k = 1 << 28
    rows, edges = _partition.merge_path_tiles(offsets, big, k)
    assert rows.dtype == edges.dtype == torch.int32
    total = 4 + big
    assert len(rows) == -(-total // k) + 1 and int(edges[-1]) == big and int(rows[-1]) == 4
    d = rows.long() + edges.long()
    assert torch.equal(d[:-1], torch.arange(len(rows) - 1, dtype=torch.int64) * k)
    assert (edges.long() >= 0).all() and (torch.diff(edges.long()) >= 0).all()


def test_plan_is_cached_on_the_adjacency():
    deg = _adversarial_degrees(6)
    offsets = _offsets(deg)
    e = int(deg.sum())
    adj = CompressedAdj(offsets, torch.zeros(e, dtype=torch.int32), torch.zeros(e, dtype=torch.int32),
                        None, len(deg), len(deg), e)
    a = _partition.tiles_for(adj, 64)
    assert _partition.tiles_for(adj, 64) is a
    assert _partition.tiles_for(adj, 128) is not a and set(adj.tile_plans) == {64, 128}
    # the cache neither enters equality nor survives dataclasses.replace
    import dataclasses

    other = dataclasses.replace(adj, weights=None)
    assert other.tile_plans == {} and "tile_plans" not in repr(adj)
    with pytest.raises(ValueError):
        _partition.merge_path_tiles(offsets, e, 0)


# the kernels' reductions (csrc/spmv.cu SumOp, MinPlusOp): identity and
# combine; np.minimum, like fminf on numbers, and it lets an unwritten
# (NaN) carry show
OPS = {"sum": (0.0, np.add), "min": (np.inf, np.minimum)}


def _kernel_model(offsets, vals, k, op="sum"):
    """The kernels' carry rules, one tile at a time, in float64: returns the
    output and how many times each row was written."""
    ident, combine = OPS[op]
    off = offsets.numpy().astype(np.int64)
    v, e = len(off) - 1, int(off[-1])
    rows, edges = (t.numpy().astype(np.int64) for t in
                   _partition.merge_path_tiles(offsets, e, k))
    n_tiles = len(rows) - 1
    y = np.full(v, np.nan)
    writes = np.zeros(v, np.int64)
    carry = np.full((n_tiles, 2), np.nan)
    for t in range(n_tiles):
        r0, r1, e0, e1 = rows[t], rows[t + 1], edges[t], edges[t + 1]
        head = off[r0] < e0  # the tile enters row r0 partway
        r, acc, has = r0, ident, False
        for j in range(e0, e1):
            while j >= off[r + 1]:  # rows that end before edge j
                if r == r0 and head:
                    carry[t, 0] = acc
                else:
                    y[r] = acc
                    writes[r] += 1
                r, acc, has = r + 1, ident, False
            acc, has = combine(acc, vals[j]), True
        while r < r1:
            if r == r0 and head:
                carry[t, 0] = acc
            else:
                y[r] = acc
                writes[r] += 1
            r, acc, has = r + 1, ident, False
        if has:
            carry[t, 0 if (r == r0 and head) else 1] = acc
    for t in range(1, n_tiles):  # the fix-up: one owner per cut row
        r = rows[t]
        if off[r] >= edges[t] or off[r] + r < rows[t - 1] + edges[t - 1]:
            continue
        last = (off[r + 1] + r) // k
        acc = carry[t - 1, 1]
        for tt in range(t, last + 1):
            acc = combine(acc, carry[tt, 0])
        y[r] = acc
        writes[r] += 1
    return y, writes


def _row_reduce(offsets, vals, op):
    ident, combine = OPS[op]
    bounds = zip(offsets[:-1].tolist(), offsets[1:].tolist())
    return np.array([combine.reduce(vals[a:b]) if b > a else ident for a, b in bounds])


@pytest.mark.parametrize("op", sorted(OPS))
@pytest.mark.parametrize("seed,k", PLANS + [(7, 2), (8, 18)])
def test_carry_rules_sum_every_row_once(seed, k, op):
    deg = _adversarial_degrees(seed, hub=700)
    offsets = _offsets(deg)
    vals = np.random.default_rng(seed).normal(size=int(deg.sum()))
    y, writes = _kernel_model(offsets, vals, k, op)
    assert (writes == 1).all()
    want = _row_reduce(offsets, vals, op)
    if op == "min":  # exact: a min rounds nothing
        np.testing.assert_array_equal(y, want)
    else:
        np.testing.assert_allclose(y, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("k", [1, 2, 7, 64, 1792])
def test_min_rows_without_edges_are_inf(k):
    """Empty rows first, in the middle (a run of them, and single ones
    between a hub's tiles and short rows) and last come out +inf, written
    once; every other row is its exact minimum."""
    deg = _adversarial_degrees(9, hub=3000)
    deg[8] = deg[10] = 0  # single empty rows right after the hub
    offsets = _offsets(deg)
    vals = np.random.default_rng(9).normal(size=int(deg.sum())) * 100
    y, writes = _kernel_model(offsets, vals, k, "min")
    assert (writes == 1).all()
    empty = deg == 0
    assert empty[[0, 8, 10, 150, len(deg) - 1]].all()
    assert np.isposinf(y[empty]).all() and np.isfinite(y[~empty]).all()
    np.testing.assert_array_equal(y, _row_reduce(offsets, vals, "min"))


def test_rows_ending_on_tile_boundaries():
    """Every row of 3 edges (4 items) with tiles of 4 and 8: each end
    marker is the last item of a tile; with tiles of 3, rows cut at every
    offset."""
    deg = np.full(50, 3)
    offsets = _offsets(deg)
    vals = np.arange(150, dtype=np.float64)
    for k in (4, 8, 3, 5):
        y, writes = _kernel_model(offsets, vals, k)
        assert (writes == 1).all()
        np.testing.assert_allclose(y, vals.reshape(50, 3).sum(1))
        y, writes = _kernel_model(offsets, -vals, k, "min")
        assert (writes == 1).all()
        np.testing.assert_array_equal(y, -vals.reshape(50, 3)[:, 2])
