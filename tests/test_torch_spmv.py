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
"""

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
from cugraph_tpu_torch.prims.cuda import spmv_minplus, spmv_sum

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
