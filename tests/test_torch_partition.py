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
as the identity. A numpy model of spmm_rows' narrow layout (its lane
groups, steps, open row and segmented scan, in the kernel's order, fed to
the same fix-up) writes every row once and matches the plain version.
"""

import numpy as np
import pytest
import torch

from cugraph_tpu_torch.core.csr import CompressedAdj
from cugraph_tpu_torch.prims.cuda import _partition, spmm_row


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
    _fixup_model(off, rows, edges, carry, y, writes, k, combine)
    return y, writes


def _fixup_model(off, rows, edges, carry, y, writes, k, combine):
    """The fix-up kernel: one owner per cut row, which combines slot 1 of
    the tile the row began in with slot 0 of each later tile, in order."""
    for t in range(1, len(rows) - 1):
        r = rows[t]
        if off[r] >= edges[t] or off[r] + r < rows[t - 1] + edges[t - 1]:
            continue
        last = (off[r + 1] + r) // k
        acc = carry[t - 1, 1]
        for tt in range(t, last + 1):
            acc = combine(acc, carry[tt, 0])
        y[r] = acc
        writes[r] += 1


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


# ------------------------------------------------- spmm_rows, narrow layout


def _narrow_model(offsets, minors, weights, x, lay):
    """csrc/spmm_row.cu:spmm_narrow_kernel in float32, every column at
    once (a column pass repeats the same arithmetic): each tile's empty
    rows written 0, its edges dealt to lay.groups groups a step, a step
    inside the open row added to each group's own sum, any other step
    through the segmented inclusive scan (shfl_up by d groups where the
    rows agree, until no segment is longer than d), the open row's sum (a butterfly over the groups, or one
    group's) added to the first segment, the last group of each segment
    that ends inside the step writing its row; the two carry slots, then
    the fix-up. Returns (y, writes per row, rows written as an empty row)."""
    off = offsets.numpy().astype(np.int64)
    v, e = len(off) - 1, int(off[-1])
    f = x.shape[1]
    majors = np.repeat(np.arange(v), np.diff(off))
    k = lay.items_per_tile
    rows, edges = (t.numpy().astype(np.int64) for t in
                   _partition.merge_path_tiles(offsets, e, k))
    n_tiles = len(rows) - 1
    groups = lay.groups
    gi = np.arange(groups)
    y = np.full((v, f), np.nan, np.float32)
    writes = np.zeros(v, np.int64)
    zeroed = np.zeros(v, np.int64)
    carry = np.full((n_tiles, 2, f), np.nan, np.float32)
    big = np.iinfo(np.int64).max
    for t in range(n_tiles):
        r0, r1, e0, e1 = rows[t], rows[t + 1], edges[t], edges[t + 1]
        head = off[r0] < e0

        def write(r, val):
            if r == r0 and head:
                carry[t, 0] = val
            elif r < r1:
                y[r] = val
                writes[r] += 1
            else:
                carry[t, 1] = val

        for r in range(r0, r1):
            if off[r] == off[r + 1]:
                y[r] = 0.0
                writes[r] += 1
                zeroed[r] += 1
        acc = np.zeros((groups, f), np.float32)
        open_row, open_has, holder = r0, head, 0

        def open_sum():
            if holder >= 0:
                return np.broadcast_to(acc[holder], (groups, f)).copy()
            tot = acc.copy()
            m = 1
            while m < groups:
                tot = tot + tot[gi ^ m]
                m <<= 1
            return tot

        for es in range(e0, e1, groups):
            eg = es + gi
            ok = eg < e1
            ec = np.minimum(eg, e - 1)
            rg = np.where(ok, majors[ec], big)
            wu = np.ones(groups, np.float32) if weights is None else weights[ec]
            p = np.where(ok[:, None], wu[:, None] * x[minors[ec]], np.float32(0))
            if (rg == open_row).all():
                acc = acc + p
                open_has, holder = True, -1
                continue
            tot = open_sum()
            d = 1
            while d < groups:
                rd = np.where(gi >= d, rg[gi - d], -1)
                pd = p[gi - d]
                same = (gi >= d) & (rd == rg) & ok
                if not same.any():  # no segment longer than d
                    break
                p = np.where(same[:, None], p + pd, p)
                d <<= 1
            p = np.where((rg == open_row)[:, None], p + tot, p)
            if rg[0] != open_row and open_has:
                write(open_row, tot[0])
            n = int(ok.sum())
            for g in range(n - 1):
                if rg[g + 1] != rg[g]:
                    write(rg[g], p[g])
            open_row = rg[n - 1]
            acc = np.where((gi == n - 1)[:, None], p, np.float32(0))
            holder, open_has = n - 1, True
        if open_has:
            write(open_row, open_sum()[0])
    _fixup_model(off, rows, edges, carry, y, writes, k, np.add)
    return y, writes, zeroed


def _spmm_case(deg, seed, f, weighted):
    """(offsets, minors, weights, x) of a CSC with these in-degrees, skewed
    sources, seeded normal weights and x."""
    rng = np.random.default_rng(seed)
    offsets = _offsets(deg)
    v, e = len(deg), int(deg.sum())
    minors = (rng.random(e) ** 3 * v).astype(np.int64)
    weights = rng.normal(size=e).astype(np.float32) if weighted else None
    x = rng.normal(size=(v, f)).astype(np.float32)
    return offsets, minors, weights, x


def _check_narrow(offsets, minors, weights, x, lay):
    """The model writes every row once, empty rows as 0, and matches
    spmm_rows_reference within 1e-5 of the row's sum of |w x|."""
    from cugraph_tpu_torch.core.csr import CompressedAdj

    off = offsets.numpy().astype(np.int64)
    v, e = len(off) - 1, int(off[-1])
    y, writes, zeroed = _narrow_model(offsets, minors, weights, x, lay)
    assert (writes == 1).all()
    np.testing.assert_array_equal(zeroed, np.diff(off) == 0)
    majors = np.repeat(np.arange(v), np.diff(off))
    adj = CompressedAdj(offsets, torch.from_numpy(minors.astype(np.int32)),
                        torch.from_numpy(majors.astype(np.int32)),
                        None if weights is None else torch.from_numpy(weights), v, v, e)
    ref = spmm_row.spmm_rows_reference(adj, torch.from_numpy(x)).numpy()
    wa = np.ones(e) if weights is None else np.abs(weights.astype(np.float64))
    terms = wa[:, None] * np.abs(x[minors].astype(np.float64))
    scale = np.zeros((v, x.shape[1]))
    np.add.at(scale, majors, terms)
    exact = np.zeros_like(scale)
    np.add.at(exact, majors, (1.0 if weights is None else weights[:, None].astype(np.float64))
              * x[minors].astype(np.float64))
    for want in (ref.astype(np.float64), exact):
        err = np.abs(y.astype(np.float64) - want)
        assert (err[scale == 0] == 0).all()
        assert (err / np.maximum(scale, 1e-30)).max() < 1e-5
    return y


NARROW_FS = [1, 2, 3, 8, 10, 16, 33, 64]


@pytest.mark.parametrize("f", NARROW_FS)
@pytest.mark.parametrize("k", [64, 1024, 4096])
def test_narrow_layout_model_sums_every_row_once(f, k):
    """Adversarial in-degrees (empty first, middle and last rows, a hub of
    3,000 edges over many tiles at 64 items), weighted and unweighted."""
    lay = spmm_row.spmm_layout(f)._replace(items_per_tile=k)
    assert lay.narrow
    deg = _adversarial_degrees(f * 10 + k, hub=3000)
    _check_narrow(*_spmm_case(deg, f + k, f, weighted=True), lay)
    if k == 64:
        _check_narrow(*_spmm_case(deg, f + k + 1, f, weighted=False), lay)


def _step_boundary_degrees(g, k, seed, n=160):
    """In-degrees built row by row so that every fourth row's last edge
    closes a step of g edges of the k-item tile that holds it (the step
    counted from the tile's first edge), between runs of empty rows, short
    rows and rows of g - 1 .. 2g + 1 edges; row 1 a hub of 20 g edges."""
    rng = np.random.default_rng(seed)
    deg, markers, edges = [0, 20 * g], [0, 20 * g + 1], 20 * g
    for i in range(n):
        pos = edges + len(deg)  # the row's first item
        d = [None, int(rng.integers(0, 3)), 0, int(rng.integers(g - 1, 2 * g + 2))][i % 4]
        if d is None:
            tile = pos // k
            e0 = tile * k - int(np.searchsorted(markers, tile * k))
            d = (e0 - edges) % g or g
            if pos + d > (tile + 1) * k:  # the row would leave its tile
                d = 1
        deg.append(d)
        edges += d
        markers.append(edges + len(deg) - 1)
    return np.array(deg + [0, 0])


@pytest.mark.parametrize("f", [8, 16, 1, 10])
@pytest.mark.parametrize("k", [33, 64, 100])
def test_narrow_layout_rows_ending_on_step_boundaries(f, k):
    """Rows whose last edge closes a step of the G groups (at least 8,
    counted on the plan), rows ending one edge before and after it, runs
    of empty rows, a hub across tiles; tiles of k items."""
    lay = spmm_row.spmm_layout(f)._replace(items_per_tile=k)
    g = lay.groups
    deg = _step_boundary_degrees(g, k, f * k)
    offsets = _offsets(deg)
    rows, edges = (t.numpy().astype(np.int64) for t in
                   _partition.merge_path_tiles(offsets, int(deg.sum()), k))
    ends = offsets.numpy()[1:].astype(np.int64)[deg > 0]
    tile = np.searchsorted(edges, ends - 1, side="right") - 1
    assert ((ends - edges[tile]) % g == 0).sum() >= 8
    _check_narrow(*_spmm_case(deg, f * k, f, weighted=True), lay)


def test_narrow_layout_butterfly_and_holder_agree():
    """A tile inside one hub row (every step the open row's: the butterfly
    over the groups) and short rows after it (one group holds the sum):
    both give the float64 sums within 1e-5, and the result is the same
    bits when run twice."""
    lay = spmm_row.spmm_layout(8)._replace(items_per_tile=256)
    deg = np.array([0, 1000, 3, 0, 17, 16, 15, 0])
    case = _spmm_case(deg, 5, 8, weighted=True)
    a = _check_narrow(*case, lay)
    b, _, _ = _narrow_model(*case, lay)
    np.testing.assert_array_equal(a, b)
