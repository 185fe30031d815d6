"""cumsum_flat and segment_sums_from_cumsum of cugraph_tpu_torch against
cugraph_tpu's two-level Pallas scan in interpret mode on the CPU.

Tolerance: each entry within 1e-5 of the float64 prefix of |x| at that
entry. Both packages sum in f32 in different orders (the TPU kernel adds
log-step partials and a sequential carry; torch.cumsum on the CPU keeps
a wider accumulator), so entries agree to the prefix's rounding, not bit
for bit. Lengths cross the TPU's 196,608-element tile and include 0.

The CUDA kernel (csrc/scan.cu) runs only on a card; a numpy model of its
arithmetic and of its decoupled look-back stands for it here: the f32
tree within each tile, f64 carries, and tiles that finish their
look-backs in seeded random orders, so each look-back reaches a different
depth. Every order must give the same bits, within the tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cugraph_tpu.prims.pallas import scan as jscan
from cugraph_tpu_torch.prims.cuda import (
    cumsum_flat,
    cumsum_flat_reference,
    segment_sums_from_cumsum,
)
from cugraph_tpu_torch.prims.cuda import scan as cscan

TOL = 1e-5


def _prefix_abs(x):
    return np.cumsum(np.abs(x.astype(np.float64)))


@pytest.mark.parametrize("n", [0, 1, 100, 65536, 3 * 65536 + 77])
def test_cumsum_flat_matches_jax(n):
    x = np.random.default_rng(n).uniform(-1, 1, n).astype(np.float32)
    want = np.asarray(jscan.cumsum_flat(jnp.asarray(x), interpret=True))
    got = cumsum_flat(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (n,)
    bound = TOL * _prefix_abs(x)
    assert (np.abs(got.numpy().astype(np.float64) - want) <= bound).all()
    exact = np.cumsum(x.astype(np.float64))
    assert (np.abs(got.numpy() - exact) <= bound).all()


@pytest.mark.parametrize("dtype", [torch.int32, torch.float64, torch.bfloat16])
def test_cumsum_flat_casts_to_f32(dtype):
    x = torch.arange(1000).to(dtype)
    got = cumsum_flat(x)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.cumsum(x.float().numpy()))
    assert torch.equal(cumsum_flat_reference(x), got)


def test_cumsum_flat_rejects_2d():
    with pytest.raises(ValueError, match="1-D"):
        cumsum_flat(torch.zeros(4, 4))


@pytest.mark.parametrize("v,e", [(50, 4000), (300, 20000)])
def test_segment_sums_from_cumsum_matches_jax(v, e):
    rng = np.random.default_rng(v)
    seg = np.sort(rng.integers(0, v, e))
    vals = rng.uniform(-1, 1, e).astype(np.float32)
    offsets = np.zeros(v + 1, np.int32)
    np.cumsum(np.bincount(seg, minlength=v), out=offsets[1:])
    jcum = jscan.cumsum_flat(jnp.asarray(vals), interpret=True)
    want = np.asarray(jscan.segment_sums_from_cumsum(jcum, jnp.asarray(offsets), v))
    got = segment_sums_from_cumsum(cumsum_flat(torch.from_numpy(vals)), torch.from_numpy(offsets), v)
    assert got.shape == (v,)
    # a difference of two prefixes carries their rounding: relative to the
    # largest prefix of |x|, not to the segment
    scale = TOL * _prefix_abs(vals)[-1]
    assert np.abs(got.numpy().astype(np.float64) - want).max() <= 2 * scale
    exact = np.zeros(v)
    np.add.at(exact, seg, vals.astype(np.float64))
    assert np.abs(got.numpy() - exact).max() <= 2 * scale


# ------------------------------------------------ the kernel's look-back

CHUNKS = cscan.ITEMS_PER_THREAD // 4  # float4 chunks a thread
WARPS = cscan.THREADS // 32


def _warp_scan(v):
    """Inclusive shuffle scan over the last axis (32 lanes), in f32, as
    warp_inclusive_scan: lane l adds lane l - o's value for o = 1 .. 16."""
    v = v.copy()
    for o in (1, 2, 4, 8, 16):
        v[..., o:] = v[..., o:] + v[..., :-o]
    return v


def _shift_lanes(v):
    """The exclusive scan from the inclusive one: lane l gets lane l - 1's
    value, lane 0 gets 0."""
    out = np.zeros_like(v)
    out[..., 1:] = v[..., :-1]
    return out


def _tile_tree(x):
    """(local f32 prefixes (tiles, TILE), f32 aggregates (tiles,)): each
    thread's float4 chunk j * THREADS + t in order, a warp scan of each
    j's chunk totals, then a warp scan of the 32 warp totals, j-major."""
    tiles = -(-len(x) // cscan.TILE)
    xp = np.zeros(tiles * cscan.TILE, np.float32)
    xp[: len(x)] = x
    c = np.add.accumulate(xp.reshape(tiles, CHUNKS, WARPS, 32, 4), axis=-1, dtype=np.float32)
    inc = _warp_scan(c[..., 3])
    w_inc = _warp_scan(inc[..., 31].reshape(tiles, CHUNKS * WARPS))
    w_off = _shift_lanes(w_inc).reshape(tiles, CHUNKS, WARPS, 1)
    off = w_off + _shift_lanes(inc)
    local = off[..., None] + c
    assert local.dtype == np.float32
    return local.reshape(tiles, cscan.TILE), w_inc[:, -1]


def _look_back(total, order):
    """Each tile's exclusive prefix in f64 when the tiles after tile 0
    finish in ``order``: tile t reads its predecessors 32 at a time, lane l
    the tile l + 1 back; those finished show their inclusive prefix (P),
    the others their aggregate; the nearest P ends the walk. A
    shuffle-down tree adds the lanes up to it, the windows add in order."""
    tiles = len(total)
    done = np.zeros(tiles, bool)
    incl = np.zeros(tiles)
    excl = np.zeros(tiles)
    done[0], incl[0] = True, float(total[0])
    lanes = np.arange(32)
    for t in order:
        ex, end = 0.0, t
        while True:
            p = end - 1 - lanes
            pc = np.maximum(p, 0)
            is_p = (p < 0) | done[pc]
            v = np.where(p < 0, 0.0, np.where(done[pc], incl[pc], total[pc].astype(np.float64)))
            if is_p.any():
                v[int(np.argmax(is_p)) + 1 :] = 0.0
            for o in (16, 8, 4, 2, 1):
                v[:o] = v[:o] + v[o : 2 * o]
            ex += v[0]
            if is_p.any():
                break
            end -= 32
        excl[t], incl[t], done[t] = ex, ex + float(total[t]), True
    return excl


def _model_scan(x, order):
    local, total = _tile_tree(x)
    excl = _look_back(total, order)
    return (local.astype(np.float64) + excl[:, None]).astype(np.float32).ravel()[: len(x)]


def _orders(tiles, seed):
    """Tiles 1 .. tiles - 1 finishing in order (every look-back one tile
    deep), in reverse (every look-back down to tile 0), and in two seeded
    random orders."""
    rest = np.arange(1, tiles)
    rng = np.random.default_rng(seed)
    return [rest, rest[::-1], rng.permutation(rest), rng.permutation(rest)]


@pytest.mark.parametrize("dist", ["uniform", "positive"])
@pytest.mark.parametrize(
    "whole,extra", [(0, cscan.TILE - 5), (1, 0), (1, 1), (2, 0), (36, 5), (129, 3), (400, 7)]
)
def test_look_back_same_bits_under_every_order(dist, whole, extra):
    """U[-1, 1) and (0, 1] inputs over whole tiles and a ragged one: the
    same bits whatever depth each look-back reached, each entry within TOL
    of the float64 prefix of |x|."""
    n = whole * cscan.TILE + extra
    rng = np.random.default_rng(n)
    x = (rng.uniform(-1, 1, n) if dist == "uniform" else 1.0 - rng.uniform(0, 1, n)).astype(np.float32)
    tiles = -(-n // cscan.TILE)
    ys = [_model_scan(x, order) for order in _orders(tiles, n)]
    for y in ys[1:]:
        np.testing.assert_array_equal(y.view(np.int32), ys[0].view(np.int32))
    exact = np.cumsum(x.astype(np.float64))
    assert (np.abs(ys[0] - exact) <= TOL * _prefix_abs(x)).all()


def test_look_back_all_ones_is_exact():
    """2^20 ones: every entry is i + 1 exactly, in any order."""
    n = 1 << 20
    x = np.ones(n, np.float32)
    want = np.arange(1, n + 1, dtype=np.float32)
    for order in _orders(n // cscan.TILE, 1)[1:3]:
        np.testing.assert_array_equal(_model_scan(x, order), want)


def test_tile_constants_match_the_kernel():
    """THREADS and ITEMS_PER_THREAD are csrc/scan.cu's kThreads and its
    float4 chunks (kChunks); the wrapper sizes the status words by TILE."""
    import re
    from pathlib import Path

    src = (Path(cscan.__file__).resolve().parents[2] / "csrc" / "scan.cu").read_text()
    threads = int(re.search(r"constexpr int kThreads = (\d+);", src).group(1))
    chunks = int(re.search(r"constexpr int kChunks = (\d+);", src).group(1))
    assert (threads, 4 * chunks) == (cscan.THREADS, cscan.ITEMS_PER_THREAD)
