"""Plain version of spmm_rows against cugraph_tpu and a bf16 numpy oracle.

"f32": against the JAX package's per_v_transform_reduce_incoming_e on the
CPU (exact f32 there), relative 1e-5. "bf16": against a numpy oracle whose
operands are rounded to bf16 (round to nearest even) and summed in float64,
relative 1e-5; products of two bf16 values are exact in f32, so only the
summation order differs. F = 128 and F = 40, weighted and unweighted.
"""

import numpy as np
import pytest
import torch

import cugraph_tpu as cg
import cugraph_tpu_torch as ct
from cugraph_tpu.prims.per_v import per_v_transform_reduce_incoming_e
from cugraph_tpu_torch.prims.cuda import spmm_rows


def _graph(seed, weighted, v=900, e=6000):
    rng = np.random.default_rng(seed)
    srcs = (rng.zipf(1.4, e) % v).astype(np.int32)  # skewed sources
    dsts = rng.integers(0, v, e).astype(np.int32)
    w = rng.normal(size=e).astype(np.float32) if weighted else None
    return srcs, dsts, w, v


def _round_bf16(a):
    """float32 -> nearest bf16 (ties to even), returned as float32."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) >> 16 << 16
    return bits.astype(np.uint32).view(np.float32)


def _rel_err(y, ref, scale):
    """|y - ref| over the row's sum of |w x| (the size of the terms)."""
    return np.max(np.abs(y - ref) / np.maximum(scale, 1e-30))


@pytest.mark.parametrize("f", [128, 40])
@pytest.mark.parametrize("weighted", [True, False])
def test_spmm_rows_f32_matches_jax(f, weighted):
    srcs, dsts, w, v = _graph(f + weighted, weighted)
    x = np.random.default_rng(f).normal(size=(v, f)).astype(np.float32)
    jg = cg.from_edgelist(srcs, dsts, w, num_vertices=v)
    want = np.asarray(per_v_transform_reduce_incoming_e(
        jg, lambda s, d, sv, dv, wt: sv if wt is None else sv * wt[:, None],
        src_values=x,
    ))
    tg = ct.from_edgelist(srcs, dsts, w, num_vertices=v, device="cpu")
    got = spmm_rows(tg.csc(), torch.from_numpy(x), precision="f32").numpy()
    wa = np.ones(len(srcs)) if w is None else np.abs(w.astype(np.float64))
    scale = np.zeros((v, f))
    np.add.at(scale, dsts, wa[:, None] * np.abs(x[srcs].astype(np.float64)))
    assert got.shape == (v, f) and got.dtype == np.float32
    assert _rel_err(got, want, scale) < 1e-5


@pytest.mark.parametrize("f", [128, 40])
@pytest.mark.parametrize("weighted", [True, False])
def test_spmm_rows_bf16_matches_rounded_oracle(f, weighted):
    srcs, dsts, w, v = _graph(10 + f + weighted, weighted)
    x = np.random.default_rng(f + 1).normal(size=(v, f)).astype(np.float32)
    xb = _round_bf16(x).astype(np.float64)
    wb = np.ones(len(srcs)) if w is None else _round_bf16(w).astype(np.float64)
    want = np.zeros((v, f))
    np.add.at(want, dsts, wb[:, None] * xb[srcs])
    scale = np.zeros((v, f))
    np.add.at(scale, dsts, np.abs(wb[:, None] * xb[srcs]))
    tg = ct.from_edgelist(srcs, dsts, w, num_vertices=v, device="cpu")
    got = spmm_rows(tg.csc(), torch.from_numpy(x), precision="bf16").numpy()
    assert _rel_err(got, want, scale) < 1e-5
    # the rounding is real: the f32 mode differs from the bf16 oracle
    f32 = spmm_rows(tg.csc(), torch.from_numpy(x), precision="f32").numpy()
    assert _rel_err(f32, want, scale) > 1e-4


def test_spmm_rows_use_weights_false_ignores_weights():
    srcs, dsts, w, v = _graph(3, True)
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(v, 16)).astype(np.float32))
    weighted = ct.from_edgelist(srcs, dsts, w, num_vertices=v, device="cpu")
    plain = ct.from_edgelist(srcs, dsts, num_vertices=v, device="cpu")
    torch.testing.assert_close(
        spmm_rows(weighted.csc(), x, use_weights=False), spmm_rows(plain.csc(), x),
        rtol=0, atol=0,
    )
    with pytest.raises(ValueError):
        spmm_rows(plain.csc(), x, precision="bf16_pair")
