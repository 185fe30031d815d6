"""Plain version of spmm_rows against cugraph_tpu and a bf16 numpy oracle.

"f32": against the JAX package's per_v_transform_reduce_incoming_e on the
CPU (exact f32 there), relative 1e-5. "bf16": against a numpy oracle whose
operands are rounded to bf16 (round to nearest even) and summed in float64,
relative 1e-5; products of two bf16 values are exact in f32, so only the
summation order differs. F = 128 (the kernel's wide layout), 40, 8 and 10
(its narrow one), weighted and unweighted. The layout each F takes.
"""

import numpy as np
import pytest
import torch

import cugraph_tpu as cg
import cugraph_tpu_torch as ct
from cugraph_tpu.prims.per_v import per_v_transform_reduce_incoming_e
from cugraph_tpu_torch.prims.cuda import spmm_row, spmm_rows


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


@pytest.mark.parametrize("f", [128, 40, 8, 10])
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


@pytest.mark.parametrize("f", [128, 40, 8, 10])
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


@pytest.mark.parametrize("f,lanes,vec", [
    (1, 1, 1), (2, 1, 2), (3, 4, 1), (4, 1, 4), (8, 2, 4), (10, 8, 2), (16, 4, 4),
    (32, 8, 4), (33, 32, 1), (40, 16, 4), (64, 16, 4),
])
def test_spmm_layout_narrow(f, lanes, vec):
    """Narrow up to NARROW_MAX_F: the fewest lanes (a power of two) whose
    widest aligned loads span F, capped at 32 (F = 33 takes two column
    passes of 32); G = 32 / L edges a step."""
    lay = spmm_row.spmm_layout(f)
    assert lay.narrow and (lay.lanes, lay.vec) == (lanes, vec)
    assert lay.groups * lay.lanes == 32
    assert lay.items_per_tile == spmm_row.NARROW_ITEMS_PER_TILE
    assert f % lay.vec == 0 and (lay.lanes * lay.vec >= f or lay.lanes == 32)


@pytest.mark.parametrize("f", [128, 129, 256, 1000])
def test_spmm_layout_wide_from_128(f):
    """F >= 128 keeps the wide layout: 32 lanes on one edge, float4 loads
    where F % 4 == 0, else four scalar loads a lane."""
    lay = spmm_row.spmm_layout(f)
    assert not lay.narrow and (lay.lanes, lay.groups) == (32, 1)
    assert lay.vec == (4 if f % 4 == 0 else 1)
    assert lay.items_per_tile == spmm_row.ITEMS_PER_TILE
    assert spmm_row.NARROW_MAX_F < 128


@pytest.mark.parametrize("f,vec", [(65, 1), (101, 1), (127, 1), (200, 4)])
def test_spmm_layout_wide_above_narrow_max(f, vec):
    """Every F above NARROW_MAX_F takes the wide layout: float4 loads
    (column passes of 128, the last partial at F = 200) or, F % 4 != 0,
    four scalar loads a lane."""
    lay = spmm_row.spmm_layout(f)
    assert f > spmm_row.NARROW_MAX_F
    assert not lay.narrow and (lay.lanes, lay.groups, lay.vec) == (32, 1, vec)


@pytest.mark.parametrize("align", [16, 8, 4])
def test_spmm_layout_narrow_has_a_kernel(align):
    """Every narrow layout is an instance that csrc/spmm_row.cu builds: a
    power of two of lanes up to 32, and never 32 lanes of float4 loads."""
    built = {(lanes, vec) for lanes in (1, 2, 4, 8, 16, 32) for vec in (4, 2, 1)} - {(32, 4)}
    for f in range(1, spmm_row.NARROW_MAX_F + 1):
        lay = spmm_row.spmm_layout(f, align)
        assert lay.narrow and (lay.lanes, lay.vec) in built, (f, lay)


def test_spmm_layout_alignment_lowers_vec():
    """x's data at an 8- or 4-byte offset takes narrower loads (more lanes
    an edge); F < 1 raises."""
    assert spmm_row.spmm_layout(8, 8)[:4] == (True, 4, 8, 2)
    assert spmm_row.spmm_layout(8, 4)[:4] == (True, 8, 4, 1)
    assert spmm_row.spmm_layout(128, 4).vec == 1
    with pytest.raises(ValueError):
        spmm_row.spmm_layout(0)
