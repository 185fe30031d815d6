"""Generators of cugraph_tpu_torch against cugraph_tpu on the CPU.

- path, complete, 2-D and 3-D mesh: the same edges, in the same order;
- Erdős–Rényi: bit-equal at the same seed (both draw with numpy's
  default_rng(seed));
- mg_rmat_edgelist -> rmat_chunk_source -> distribute_edgelist_chunks on
  gloo 1 x 1 and 2 x 1 meshes (one process a rank, as
  tests/test_torch_dist.py runs them): the JAX function's shard shape,
  shards with distinct seeds and distinct edges, ids in range, every rank
  drawing the same shards, and each rank's in_block equal to its part of
  the single-device CSC of the concatenated shards.
"""

import numpy as np
import pytest
import torch

import _torch_dist_worker as worker
import cugraph_tpu as cg
import cugraph_tpu_torch as ct
from cugraph_tpu.dist import make_mesh as jax_make_mesh
from cugraph_tpu.generators import simple as jsimple
from cugraph_tpu_torch.dist import Partition2D
from cugraph_tpu_torch.generators.rmat import shard_seed

SIMPLE = {
    "path": (jsimple.path_graph_edgelist, (7,)),
    "path_1": (jsimple.path_graph_edgelist, (1,)),
    "complete": (jsimple.complete_graph_edgelist, (5,)),
    "mesh_2d": (jsimple.mesh_2d_edgelist, (4, 3)),
    "mesh_3d": (jsimple.mesh_3d_edgelist, (3, 2, 4)),
}


@pytest.mark.parametrize("name", list(SIMPLE))
def test_simple_generators_match_jax(name):
    jfn, args = SIMPLE[name]
    tfn = getattr(ct.simple_generators, jfn.__name__)
    js, jd = jfn(*args)
    ts, td = tfn(*args, device="cpu")
    assert ts.dtype == td.dtype == torch.int32
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_array_equal(td.numpy(), jd)


@pytest.mark.parametrize("directed", [False, True])
@pytest.mark.parametrize("seed", [0, 7])
def test_erdos_renyi_bit_equal(seed, directed):
    js, jd = jsimple.erdos_renyi_gnp_edgelist(60, 0.1, seed=seed, directed=directed)
    ts, td = ct.simple_generators.erdos_renyi_gnp_edgelist(60, 0.1, seed=seed, directed=directed,
                                                           device="cpu")
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_array_equal(td.numpy(), jd)
    assert len(js) > 0 and (ts != td).all()
    if not directed:
        assert (ts < td).all()


SCALE, NUM_EDGES, SEED = 8, 3000, 5


@pytest.mark.parametrize("shape", [(1, 1), (2, 1)])
def test_mg_rmat_shards_and_ingest(shape):
    n = shape[0] * shape[1]
    ranks = worker.spawn(worker.run_rmat_shards, n, shape, SCALE, NUM_EDGES, SEED)
    # the JAX function's array shape: the mesh's, then ceil(E / ranks)
    jsrc, _ = cg.mg_rmat_edgelist(jax_make_mesh(shape), SCALE, NUM_EDGES)
    assert ranks[0]["shape"] == tuple(jsrc.shape) == shape + (-(-NUM_EDGES // n),)
    # every rank drew the same shards, each from its own seed
    shards = ranks[0]["shards"]
    assert len(shards) == n and len({shard_seed(SEED, d) for d in range(n)}) == n
    for r in ranks[1:]:
        for (s, d), (s0, d0) in zip(r["shards"], shards):
            np.testing.assert_array_equal(s, s0)
            np.testing.assert_array_equal(d, d0)
    for d in range(1, n):
        assert not np.array_equal(shards[d][0], shards[0][0])
    src = np.concatenate([s for s, _ in shards]).astype(np.int64)
    dst = np.concatenate([d for _, d in shards]).astype(np.int64)
    assert src.min() >= 0 and max(src.max(), dst.max()) < 1 << SCALE
    # each shard is rmat_edgelist from its seed, on the CPU too
    for d, (s, t) in enumerate(shards):
        gen = torch.Generator().manual_seed(shard_seed(SEED, d))
        ws, wt = ct.rmat_edgelist(SCALE, -(-NUM_EDGES // n), generator=gen, scramble=True,
                                  device="cpu")
        np.testing.assert_array_equal(s, ws.numpy())
        np.testing.assert_array_equal(t, wt.numpy())
    # in_blocks: the single-device CSC of the shards, split by edge block
    csc = ct.from_edgelist(src, dst, num_vertices=1 << SCALE, store="in", device="cpu").csc()
    g_dst, g_src = csc.majors.numpy().astype(np.int64), csc.minors.numpy().astype(np.int64)
    part = Partition2D.create(shape[0], shape[1], 1 << SCALE)
    bi, bj, _ = part.edge_block(g_src, g_dst)
    covered = 0
    for r in ranks:
        blk, vp, i, j = r["in_block"], r["vp"], r["i"], r["j"]
        majors, minors = blk["majors"].astype(np.int64), blk["minors"].astype(np.int64)
        got_dst = (majors // vp * shape[0] + i) * vp + majors % vp
        got_src = minors + j * shape[0] * vp
        mine = (bi == i) & (bj == j)
        got = np.sort(got_dst * (1 << SCALE) + got_src)
        want = np.sort(g_dst[mine] * (1 << SCALE) + g_src[mine])
        np.testing.assert_array_equal(got, want)
        covered += len(got)
        if shape == (1, 1):
            for key in ("offsets", "minors", "majors"):
                np.testing.assert_array_equal(blk[key], getattr(csc, key).numpy())
    assert covered == len(src)
