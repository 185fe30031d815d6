"""assemble_chunks of cugraph_tpu_torch against cugraph_tpu's
spmv2._assemble_call (the sorted engine's chunk copy) in interpret mode on
the CPU, on TINY sorted layouts of small R-MAT graphs.

The rows that chunk_dst covers must be EQUAL (a copy rounds nothing). The
Pallas kernel leaves the other rows undefined; the port zero-fills them,
which is checked on its own.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cugraph_tpu.prims.pallas import spmv2
from cugraph_tpu_torch.prims.cuda import assemble_chunks, assemble_chunks_reference


def _rmat_np(scale, edgefactor, seed):
    rng = np.random.default_rng(seed)
    e = edgefactor << scale
    src = np.zeros(e, np.int64)
    dst = np.zeros(e, np.int64)
    for _ in range(scale):
        sb = rng.random(e) < 0.38
        db = rng.random(e) < np.where(sb, 0.19 / 0.38, 0.19 / 0.76)
        src, dst = (src << 1) | sb, (dst << 1) | db
    return src.astype(np.int32), dst.astype(np.int32), 1 << scale


@pytest.mark.parametrize("scale,weighted", [(8, False), (9, True)])
def test_assemble_matches_jax(scale, weighted):
    src, dst, v = _rmat_np(scale, 8, scale)
    rng = np.random.default_rng(scale)
    w = rng.random(len(src)).astype(np.float32) if weighted else None
    layout = spmv2.build_sorted_layout(dst, src, w, v, spmv2.TINY)
    ch, pr = layout.cfg.chunk_rows, layout.cfg.part_rows
    cs, cd = np.array(layout.chunk_src), np.array(layout.chunk_dst)
    assert len(np.unique(cs)) < len(cs)  # boundary chunks repeat
    binned = rng.standard_normal((layout.idx.shape[0], 128)).astype(np.float32)
    want = np.asarray(spmv2._assemble_call(layout, jnp.asarray(binned), True))
    out_rows = layout.n_parts * pr
    got = assemble_chunks(
        torch.from_numpy(binned), torch.from_numpy(cs), torch.from_numpy(cd), ch, out_rows
    )
    assert got.shape == want.shape == (out_rows, 128)
    rows = (cd[:, None] * ch + np.arange(ch)).ravel()
    np.testing.assert_array_equal(got.numpy()[rows], want[rows])
    uncovered = np.ones(out_rows, bool)
    uncovered[rows] = False
    assert uncovered.any() and (got.numpy()[uncovered] == 0).all()


def test_assemble_reference_repeats_and_zero_fill():
    binned = torch.arange(8 * 4 * 4, dtype=torch.float32).view(32, 4)
    cs = torch.tensor([3, 1, 1, 7])
    cd = torch.tensor([0, 1, 4, 5])
    out = assemble_chunks_reference(binned, cs, cd, 4, 28)
    assert torch.equal(assemble_chunks(binned, cs, cd, 4, 28), out)
    for s, d in zip(cs.tolist(), cd.tolist()):
        assert torch.equal(out[4 * d : 4 * d + 4], binned[4 * s : 4 * s + 4])
    assert not out[8:16].any() and not out[24:].any()


@pytest.mark.parametrize(
    "shape,rows,out_rows,match",
    [((30, 4), 4, 16, "multiples"), ((32, 4), 4, 18, "multiples"), ((32,), 4, 16, "2-D")],
)
def test_assemble_rejects_bad_shapes(shape, rows, out_rows, match):
    with pytest.raises(ValueError, match=match):
        assemble_chunks(torch.zeros(shape), torch.tensor([0]), torch.tensor([0]), rows, out_rows)


@pytest.mark.parametrize(
    "cs,cd", [([0, 8], [0, 1]), ([-1, 0], [0, 1]), ([0, 1], [0, 7]), ([0, 1], [-2, 1])]
)
def test_assemble_rejects_chunk_ids_outside_the_arrays(cs, cd):
    binned = torch.ones(32, 4)  # 8 chunks of 4 rows; 7 output chunks below
    for fn in (assemble_chunks, assemble_chunks_reference):
        with pytest.raises(ValueError, match="outside its array"):
            fn(binned, torch.tensor(cs), torch.tensor(cd), 4, 28)


def _index_model(cs, cd, in_chunks, out_chunks, order):
    """The card's index logic in numpy: the inverse filled by a 0xFF
    memset (every int32 -1), then each step, in ``order`` (blocks run in
    no order), writes its source chunk at its destination, or sets the
    bad-id flag; a copy block then reads one entry."""
    inv = np.frombuffer(b"\xff" * 4 * out_chunks, dtype=np.int32).copy()
    assert (inv == -1).all()
    flag = -1
    for i in order:
        if 0 <= cs[i] < in_chunks and 0 <= cd[i] < out_chunks:
            inv[cd[i]] = cs[i]
        else:
            flag = 1
    return inv, flag


def _model_assemble(binned, cs, cd, ch, out_rows, order):
    inv, flag = _index_model(cs, cd, binned.shape[0] // ch, out_rows // ch, order)
    if flag != -1:
        raise ValueError("assemble_chunks: a chunk id lies outside its array")
    chunks = binned.reshape(binned.shape[0] // ch, -1)
    out = np.where(inv[:, None] >= 0, chunks[np.maximum(inv, 0)], 0).astype(np.float32)
    return out.reshape(out_rows, binned.shape[1])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_index_model_matches_the_plain_version(seed):
    rng = np.random.default_rng(seed)
    ch, in_chunks, out_chunks = 4, 40, 56
    binned = rng.standard_normal((in_chunks * ch, 8)).astype(np.float32)
    cs = rng.integers(0, in_chunks, 45)  # sources repeat
    cd = rng.permutation(out_chunks)[:45]  # destinations unique; 11 uncovered
    want = assemble_chunks_reference(torch.from_numpy(binned), torch.from_numpy(cs),
                                     torch.from_numpy(cd), ch, out_chunks * ch).numpy()
    for order in (np.arange(45), np.arange(45)[::-1], rng.permutation(45)):
        np.testing.assert_array_equal(_model_assemble(binned, cs, cd, ch, out_chunks * ch, order),
                                      want)


def test_index_model_repeated_destination_and_empty_steps():
    ch = 2
    binned = np.arange(6 * ch * 3, dtype=np.float32).reshape(6 * ch, 3)
    chunks = binned.reshape(6, -1)
    cs, cd = np.array([1, 4, 5, 2]), np.array([3, 0, 3, 1])  # chunk 3 written twice
    outs = [_model_assemble(binned, cs, cd, ch, 5 * ch, order).reshape(5, -1)
            for order in (np.arange(4), np.arange(4)[::-1])]
    for out in outs:  # any one of the two steps wins, whole
        assert any((out[3] == chunks[s]).all() for s in (1, 5))
        np.testing.assert_array_equal(out[0], chunks[4])
        np.testing.assert_array_equal(out[1], chunks[2])
        assert not out[2].any() and not out[4].any()
    assert not (outs[0][3] == outs[1][3]).all()  # the order decides which
    plain = assemble_chunks(torch.from_numpy(binned), torch.from_numpy(cs), torch.from_numpy(cd),
                            ch, 5 * ch).numpy().reshape(5, -1)
    assert any((plain[3] == chunks[s]).all() for s in (1, 5))
    # no steps: every output row zero, in the model and the plain version
    none = np.zeros(0, np.int64)
    assert not _model_assemble(binned, none, none, ch, 4 * ch, []).any()
    empty = assemble_chunks(torch.from_numpy(binned), torch.from_numpy(none), torch.from_numpy(none),
                            ch, 4 * ch)
    assert empty.shape == (4 * ch, 3) and not empty.any()
    with pytest.raises(ValueError, match="outside its array"):
        _model_assemble(binned, np.array([6]), np.array([0]), ch, 4 * ch, [0])


def test_wide_ids_are_not_cut():
    """An int64 id past 2^31 stays outside the array: the card's kernel
    reads int64 ids as they are, and the plain version checks them."""
    binned = torch.ones(32, 4)
    for cs, cd in (([2**32], [0]), ([0], [2**32 + 1])):
        with pytest.raises(ValueError, match="outside its array"):
            assemble_chunks(binned, torch.tensor(cs, dtype=torch.int64),
                            torch.tensor(cd, dtype=torch.int64), 4, 28)
