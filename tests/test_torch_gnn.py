"""GNN aggregation and models of cugraph_tpu_torch against cugraph_tpu.

The flax parameters of the JAX models are carried over with
graphsage_from_flax / gcn_from_flax, and both packages see one numpy edge
list and one feature matrix. On the CPU both compute exact f32 (dense
matmul for V <= 8192, a gather and segment sum above), so outputs agree to
1e-5 (absolute, on L2-normalized rows or on O(1) aggregates).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cugraph_tpu as cg
import cugraph_tpu_torch as ct
from cugraph_tpu.gnn import GCN as JaxGCN
from cugraph_tpu.gnn import GraphSAGE as JaxGraphSAGE
from cugraph_tpu.gnn import spmm_aggregate as jax_aggregate
from cugraph_tpu_torch.gnn import gcn_from_flax, graphsage_from_flax, spmm_aggregate
from cugraph_tpu_torch.prims.cuda import spmm_rows


def _rmat_np(scale, num_edges, seed):
    rng = np.random.default_rng(seed)
    src = np.zeros(num_edges, np.int64)
    dst = np.zeros(num_edges, np.int64)
    for _ in range(scale):
        sb = rng.random(num_edges) < 0.38
        db = rng.random(num_edges) < np.where(sb, 0.19 / 0.38, 0.19 / 0.76)
        src, dst = (src << 1) | sb, (dst << 1) | db
    return src.astype(np.int32), dst.astype(np.int32), 1 << scale


def _both(scale, num_edges, seed, f=128):
    src, dst, v = _rmat_np(scale, num_edges, seed)
    x = np.random.default_rng(seed).normal(size=(v, f)).astype(np.float32)
    return (
        cg.from_edgelist(src, dst, num_vertices=v),
        ct.from_edgelist(src, dst, num_vertices=v, device="cpu"),
        x,
    )


@pytest.mark.parametrize(
    "scale,num_edges",
    [(12, 32768), (14, 65536)],  # entry()'s dense branch; the sparse branch
)
def test_graphsage_matches_flax(scale, num_edges):
    jg, tg, x = _both(scale, num_edges, scale)
    model = JaxGraphSAGE(hidden_features=128, out_features=64, num_layers=2)
    params = model.init(jax.random.PRNGKey(0), jg, jnp.asarray(x))
    want = np.asarray(model.apply(params, jg, jnp.asarray(x)))
    calls = spmm_rows.launches
    port = graphsage_from_flax(params, 128, 128, 64, 2, device="cpu")
    with torch.no_grad():
        got = port(tg, torch.from_numpy(x)).numpy()
    assert spmm_rows.launches == calls  # CPU tensors never launch
    assert got.shape == (tg.num_vertices, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("op", ["sum", "mean", "max"])
@pytest.mark.parametrize("scale", [12, 14])
def test_spmm_aggregate_matches_jax(op, scale):
    jg, tg, x = _both(scale, 4 << scale, 100 + scale, f=40)
    want = np.asarray(jax_aggregate(jg, jnp.asarray(x), op=op))
    got = spmm_aggregate(tg, torch.from_numpy(x), op=op).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_gcn_matches_flax():
    jg, tg, x = _both(12, 32768, 7, f=32)
    model = JaxGCN(hidden_features=32, out_features=16, num_layers=2)
    params = model.init(jax.random.PRNGKey(1), jg, jnp.asarray(x))
    want = np.asarray(model.apply(params, jg, jnp.asarray(x)))
    port = gcn_from_flax(params, 32, 32, 16, 2, device="cpu")
    with torch.no_grad():
        got = port(tg, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_sage_aggregate_and_bad_op():
    _, tg, x = _both(8, 2048, 3, f=8)
    xt = torch.from_numpy(x)
    out = ct.gnn.sage_aggregate(tg, xt)
    torch.testing.assert_close(out[:, :8], xt, rtol=0, atol=0)
    torch.testing.assert_close(out[:, 8:], spmm_aggregate(tg, xt), rtol=0, atol=0)
    with pytest.raises(ValueError):
        spmm_aggregate(tg, xt, op="median")
