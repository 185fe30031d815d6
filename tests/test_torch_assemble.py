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
