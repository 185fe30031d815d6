"""cugraph_tpu_torch.dist's DCSR src-side arrays, ``dcsr_lookup``, MG
similarity and MG triangle counts, against the JAX ``dist/`` and the
port's single-device functions.

One spawn per mesh shape (gloo, (1,1), (2,1), (1,2)) runs
``_torch_dist_worker.run_similarity``; the JAX package runs the same
edges on a mesh of the same shape over its virtual CPU devices.
Tolerances:

- the DCSR arrays (unpadded, per rank), ``dcsr_lookup``, the members of
  ``_mg_intersection_members`` and the triangle counts: equal;
- the coefficients: within ``COEFF_ATOL`` of JAX's (its weighted
  neighbourhood sizes are f32 sums, the port's float64 rounded once), and
  equal to the port's single-device ones, which sum in the same float64;
- JAX's own scale-14 R-MAT edges (benchmarks/mg_triangle_tpu.py:42-52,
  symmetrized, self-loops dropped) count ``S14_TRIANGLES`` triangles, the
  count of a scipy sum(A^2 o A) / 6 on those edges, in under
  ``S14_SECONDS`` on a (1, 2) mesh.
"""

import functools

import jax
import numpy as np
import pytest

import _torch_dist_worker as worker
from cugraph_tpu.core import renumber as jax_renumber
from cugraph_tpu.core.convert import decompress_to_edgelist as jax_decompress
from cugraph_tpu.dist import distribute_edgelist as jax_distribute_edgelist
from cugraph_tpu.dist import make_mesh as jax_make_mesh
from cugraph_tpu.dist import mg_prims as jax_mg_prims
from cugraph_tpu.dist import mg_similarity as jax_mg_similarity
from cugraph_tpu.testing import karate_edgelist

SHAPES = [(1, 1), (2, 1), (1, 2)]
COEFF_ATOL = 1e-6
S14_TRIANGLES = 2_847_544
S14_SECONDS = 30.0
KINDS = ("jaccard", "sorensen", "overlap")

shapes = pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
graphs = pytest.mark.parametrize("graph", ["karate", "rmat"])


def _rmat_np(scale, num_edges, seed):
    rng = np.random.default_rng(seed)
    src = np.zeros(num_edges, np.int64)
    dst = np.zeros(num_edges, np.int64)
    for _ in range(scale):
        sb = rng.random(num_edges) < 0.38
        db = rng.random(num_edges) < np.where(sb, 0.19 / 0.38, 0.19 / 0.76)
        src, dst = (src << 1) | sb, (dst << 1) | db
    return src.astype(np.int32), dst.astype(np.int32), 1 << scale


def _pairs(rng, src, dst, v, n):
    """n seeded pairs: half the graph's edges, half random vertices."""
    e = rng.integers(0, len(src), n // 2)
    return (np.concatenate([src[e], rng.integers(0, v, n - n // 2)]).astype(np.int32),
            np.concatenate([dst[e], rng.integers(0, v, n - n // 2)]).astype(np.int32))


@functools.lru_cache(maxsize=None)
def _inputs():
    rng = np.random.default_rng(23)
    ks, kd, _ = karate_edgelist()
    rs, rd, rv = _rmat_np(9, 4000, 4)
    cases = {
        "karate": dict(src=ks, dst=kd, w=(0.5 + rng.random(len(ks))).astype(np.float32),
                       num_vertices=34),
        "rmat": dict(src=rs, dst=rd, w=(1.0 - rng.random(len(rs))).astype(np.float32),
                     num_vertices=rv),
    }
    for c in cases.values():
        c["v1"], c["v2"] = _pairs(rng, c["src"], c["dst"], c["num_vertices"], 64)
    return cases


@functools.lru_cache(maxsize=None)
def _s14_edges():
    """JAX's s14 R-MAT edges as benchmarks/mg_triangle_tpu.py builds them:
    scrambled, renumbered by degree, symmetrized; self-loops dropped."""
    import cugraph_tpu as cg

    src, dst = cg.rmat_edgelist(scale=14, num_edges=2**18, scramble=True)
    src, dst = np.asarray(src), np.asarray(dst)
    new_to_old = jax_renumber.compute_renumber_map(src, dst, 2**14)
    src, dst = jax_renumber.apply_renumber_map(new_to_old, src, dst)
    g = cg.from_edgelist(src, dst, num_vertices=2**14, symmetrize=True)
    s, d, _ = (np.asarray(a) for a in jax_decompress(g))
    keep = s != d
    return s[keep], d[keep], 2**14


@functools.lru_cache(maxsize=None)
def _port(shape):
    tri = _s14_edges() if shape == (1, 2) else None
    return worker.spawn(worker.run_similarity, shape[0] * shape[1], shape, _inputs(), tri)


@functools.lru_cache(maxsize=None)
def _jax(shape, graph):
    c = _inputs()[graph]
    mesh = jax_make_mesh(shape)
    mgg = jax_distribute_edgelist(mesh, c["src"], c["dst"], c["w"],
                                  num_vertices=c["num_vertices"], symmetrize=True)
    return mesh, mgg


def _same_on_every_rank(shape, pick):
    got = [pick(r) for r in _port(shape)]
    for other in got[1:]:
        np.testing.assert_array_equal(other, got[0])
    return got[0]


@shapes
@graphs
def test_dcsr_arrays_equal_jax_per_rank(shape, graph):
    """Each rank's DCSR arrays, derived from out_block, equal the JAX
    package's slice for that device, unpadded; d_pad is JAX's."""
    _, jg = _jax(shape, graph)
    nzd, off, dsts = (np.asarray(a) for a in (jg.src_nzd, jg.src_nzd_offsets, jg.src_csr_dsts))
    w = np.asarray(jg.src_csr_weights)
    for r in _port(shape):
        i, j = r["coords"]
        got = r[graph]["dcsr"]
        n = len(got["src_nzd"])
        e = int(got["src_nzd_offsets"][-1])
        np.testing.assert_array_equal(got["src_nzd"], nzd[i, j, :n])
        assert (nzd[i, j, n:] == jg.rows * jg.vp).all()  # the rest is JAX's padding
        np.testing.assert_array_equal(got["src_nzd_offsets"], off[i, j, : n + 1])
        np.testing.assert_array_equal(got["src_csr_dsts"], dsts[i, j, :e])
        np.testing.assert_array_equal(got["src_csr_weights"], w[i, j, :e])
        assert len(got["src_csr_dsts"]) == e
        assert r[graph]["d_pad"] == dsts.shape[-1]


@shapes
@graphs
def test_dcsr_lookup_equals_jax(shape, graph):
    """(lo, deg) of every span-local id, present or absent."""
    _, jg = _jax(shape, graph)
    for r in _port(shape):
        i, j = r["coords"]
        ids = np.arange(jg.rows * jg.vp, dtype=np.int32)
        lo, deg = (np.asarray(a) for a in jax_mg_prims.dcsr_lookup(
            jg.src_nzd[i, j], jg.src_nzd_offsets[i, j], ids))
        np.testing.assert_array_equal(r[graph]["lookup"][1], deg)
        np.testing.assert_array_equal(r[graph]["lookup"][0], lo)


@shapes
@graphs
@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
def test_coefficients_match_jax_and_single_device(shape, graph, weighted):
    mesh, jg = _jax(shape, graph)
    c = _inputs()[graph]
    for kind in KINDS:
        got = _same_on_every_rank(shape, lambda r: r[graph][f"{kind}_{weighted}"])
        want = np.asarray(jax_mg_similarity.mg_similarity(
            mesh, jg, (c["v1"], c["v2"]), kind, use_weight=weighted))
        np.testing.assert_allclose(got, want, rtol=0, atol=COEFF_ATOL, err_msg=kind)
        np.testing.assert_array_equal(got, _port(shape)[0][graph][f"sg_{kind}_{weighted}"],
                                      err_msg=kind)


@shapes
def test_intersection_members_equal_jax(shape):
    """The members in JAX's (n, n_dev * k) layout, and the counts."""
    mesh, jg = _jax(shape, "karate")
    c = _inputs()["karate"]
    inter = _same_on_every_rank(shape, lambda r: r["karate"]["members"][0])
    members = _same_on_every_rank(shape, lambda r: r["karate"]["members"][1])
    k = _port(shape)[0]["karate"]["members"][2]
    assert k == jax_mg_similarity._max_local_degree(jg)
    j_inter, j_members = (np.asarray(a) for a in jax_mg_similarity._mg_intersection_members(
        mesh, jg, c["v1"], c["v2"], k))
    np.testing.assert_array_equal(members, j_members)
    np.testing.assert_array_equal(inter, j_inter)


@shapes
def test_triangle_count_karate_equals_jax(shape):
    mesh, jg = _jax(shape, "karate")
    got = _same_on_every_rank(shape, lambda r: r["karate"]["triangles"])
    np.testing.assert_array_equal(got, jax_mg_similarity.mg_triangle_count(mesh, jg))


@shapes
@graphs
def test_triangle_count_equals_single_device(shape, graph):
    """Every batch size (7 oriented edges a round makes hundreds of
    rounds) gives the single-device counts."""
    for key in ("triangles", "triangles_small_batch"):
        got = _same_on_every_rank(shape, lambda r: r[graph][key])
        np.testing.assert_array_equal(got, _port(shape)[0][graph]["sg_triangles"], err_msg=key)


def test_triangle_count_of_jax_s14_edges():
    """The known MG triangle count of JAX's s14 edges, exactly."""
    for r in _port((1, 2)):
        total, seconds = r["tri_edges"]
        assert total == S14_TRIANGLES
        assert seconds < S14_SECONDS, seconds


@shapes
def test_similarity_ranks_launch_no_kernel(shape):
    for r in _port(shape):
        assert r["launches_before"] == r["launches_after"] == [0, 0, 0]


def test_jax_devices_cover_the_meshes():
    assert len(jax.devices()) >= max(r * c for r, c in SHAPES)
