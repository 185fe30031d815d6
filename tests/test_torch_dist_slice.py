"""cugraph_tpu_torch.dist's WCC, core number, path extraction, ring
PageRank, sorted-min prims and keyed exchanges, against the port's
single-device functions and the JAX ``dist/`` (community detection:
test_torch_dist_community.py).

One spawn per mesh shape (gloo, (1,1), (2,1), (1,2)) runs
``_torch_dist_worker.run_slice``; the JAX package runs the same inputs on
a mesh of the same shape over its virtual CPU devices. Tolerances:

- ``mg_wcc`` (the f32 min-plus sweeps and the int32 path forced by
  lowering ``MAX_VERTICES``), ``mg_core_number`` (all three degree types)
  and ``mg_extract_bfs_paths``: equal to the single-device functions;
- ring ``mg_pagerank`` against ``"all_gather"``: rtol ``RING_RTOL``, atol
  ``RING_ATOL`` (the JAX test's, test_dist_extra.py:215);
- ``frontier_push_by_dst_sorted`` and ``per_v_outgoing_sorted_min``:
  equal to the generic prims (exact f32 minima);
- the keyed exchanges: equal to the JAX functions, buffers, found flags
  and overflow counts.
"""

import functools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import _torch_dist_worker as worker
import cugraph_tpu_torch as ct
from cugraph_tpu.dist import make_mesh as jax_make_mesh
from cugraph_tpu.dist import mg_prims as jax_mg_prims
from cugraph_tpu.testing import karate_edgelist
from cugraph_tpu_torch.algos import traversal

SHAPES = [(1, 1), (2, 1), (1, 2)]
RING_RTOL, RING_ATOL = 1e-4, 1e-7
EXCHANGE_CAPACITY = 64

shapes = pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
graphs = pytest.mark.parametrize("graph", ["karate", "rmat", "islands"])


def _rmat_np(scale, num_edges, seed):
    rng = np.random.default_rng(seed)
    src = np.zeros(num_edges, np.int64)
    dst = np.zeros(num_edges, np.int64)
    for _ in range(scale):
        sb = rng.random(num_edges) < 0.38
        db = rng.random(num_edges) < np.where(sb, 0.19 / 0.38, 0.19 / 0.76)
        src, dst = (src << 1) | sb, (dst << 1) | db
    return src.astype(np.int32), dst.astype(np.int32), 1 << scale


@functools.lru_cache(maxsize=None)
def _inputs():
    rng = np.random.default_rng(31)
    ks, kd, _ = karate_edgelist()
    rs, rd, rv = _rmat_np(9, 3000, 3)
    # two islands and isolated vertices (test_dist_extra.py's mg_wcc graph)
    isl_s = np.concatenate([rng.integers(0, 90, 700), rng.integers(100, 200, 700)])
    isl_d = np.concatenate([rng.integers(0, 90, 700), rng.integers(100, 200, 700)])
    cases = {
        "karate": dict(src=ks, dst=kd, w=(0.5 + rng.random(len(ks))).astype(np.float32),
                       num_vertices=34, symmetrize=True, sources=[0]),
        "rmat": dict(src=rs, dst=rd, w=None, num_vertices=rv, symmetrize=False, sources=[0, 5]),
        "islands": dict(src=isl_s, dst=isl_d, w=rng.integers(1, 5, 1400).astype(np.float32),
                        num_vertices=220, symmetrize=False, sources=[3]),
    }
    for c in cases.values():
        v = c["num_vertices"]
        c["destinations"] = rng.integers(0, v, 12)
        c["frontier"] = rng.random(v) < 0.3
        c["frontier_values"] = (rng.random(v) * 10).astype(np.float32)

    v = 34
    shape_keys = {}
    for shape in SHAPES:
        keys = rng.integers(0, 6, (shape[0], shape[1], 16)).astype(np.int32) * 5  # repeats
        valid = rng.random((shape[0], shape[1], 16)) < 0.8
        shape_keys[shape] = (keys, valid)
    exchange = dict(src=ks, dst=kd, num_vertices=v, capacity=EXCHANGE_CAPACITY,
                    values=rng.random(v).astype(np.float32),
                    labels=rng.integers(0, v, v).astype(np.int32),
                    weights=rng.random(v).astype(np.float32), shape_keys=shape_keys)
    return cases, exchange


@functools.lru_cache(maxsize=None)
def _port(shape):
    cases, exchange = _inputs()
    ex = dict(exchange)
    ex["keys"], ex["valid"] = ex.pop("shape_keys")[shape]
    return worker.spawn(worker.run_slice, shape[0] * shape[1], shape, cases, ex)


def _same_on_every_rank(shape, pick):
    got = [pick(r) for r in _port(shape)]
    for other in got[1:]:
        for a, b in zip(jax.tree.leaves(other), jax.tree.leaves(got[0])):
            np.testing.assert_array_equal(a, b)
    return got[0]


@functools.lru_cache(maxsize=None)
def _sg(graph):
    c = _inputs()[0][graph]
    return ct.from_edgelist(c["src"], c["dst"], c["w"], num_vertices=c["num_vertices"],
                            symmetrize=c["symmetrize"], device="cpu")


# --------------------------------------------------------- WCC, cores


@shapes
@graphs
@pytest.mark.parametrize("branch", ["f32", "int32"])
def test_mg_wcc_equals_single_device(shape, graph, branch):
    got = _same_on_every_rank(shape, lambda r: r[graph][f"wcc_{branch}"])
    want = ct.weakly_connected_components(_sg(graph)).numpy()
    np.testing.assert_array_equal(got, want)
    if graph == "islands":
        assert len(np.unique(got)) > 2


@shapes
@graphs
@pytest.mark.parametrize("degree_type", ["incoming", "outgoing", "incoming_outgoing"])
def test_mg_core_number_equals_single_device(shape, graph, degree_type):
    got = _same_on_every_rank(shape, lambda r: r[graph][f"core_{degree_type}"])
    np.testing.assert_array_equal(got, ct.core_number(_sg(graph), degree_type).numpy())
    assert got.max() > 1


# ------------------------------------------------- paths, ring, prims


@shapes
@graphs
def test_mg_extract_bfs_paths_equals_single_device(shape, graph, monkeypatch):
    c = _inputs()[0][graph]
    g = _sg(graph)
    paths, max_len = _same_on_every_rank(shape, lambda r: r[graph]["paths"])
    dist, pred = ct.bfs(g, c["sources"])
    want, want_len = ct.extract_bfs_paths(g, dist, pred, c["destinations"])
    assert max_len == want_len and max_len > 1
    np.testing.assert_array_equal(paths, want.numpy())
    # mg_sssp's predecessors follow the single-device sweep branch's rule
    monkeypatch.setattr(traversal, "SSSP_SWEEP_MIN_EDGES", 0)
    dist, pred = ct.sssp(g, c["sources"][0])
    want, _ = ct.extract_bfs_paths(g, dist, pred, c["destinations"])
    np.testing.assert_array_equal(
        _same_on_every_rank(shape, lambda r: r[graph]["sssp_paths"]), want.numpy())


@shapes
@graphs
def test_ring_pagerank_matches_all_gather(shape, graph):
    ring = _same_on_every_rank(shape, lambda r: r[graph]["pagerank_ring"])
    full = _same_on_every_rank(shape, lambda r: r[graph]["pagerank_all_gather"])
    np.testing.assert_allclose(ring, full, rtol=RING_RTOL, atol=RING_ATOL)
    print(f"ring vs all_gather {shape} {graph}: max |diff| {np.abs(ring - full).max():.3e}")
    for r in _port(shape):
        assert r[graph]["row_all_gathers"]["ring"] == 0
        assert r[graph]["row_all_gathers"]["all_gather"] > 0
        assert r[graph]["bad_mode_raised"]


@shapes
@graphs
def test_sorted_min_prims_equal_the_generic_prims(shape, graph):
    touched, reduced, g_touched, g_reduced = _same_on_every_rank(shape, lambda r: r[graph]["push"])
    np.testing.assert_array_equal(touched, g_touched)
    np.testing.assert_array_equal(reduced[touched], g_reduced[g_touched])
    assert not np.isfinite(reduced[~touched]).any() and touched.any()
    up, g_up = _same_on_every_rank(shape, lambda r: r[graph]["outgoing_min"])
    np.testing.assert_array_equal(up, g_up)


@shapes
def test_no_kernel_launch_on_cpu_ranks(shape):
    for r in _port(shape):
        assert r["launches_before"] == r["launches_after"] == [0, 0, 0]


# ------------------------------------------------------ keyed exchanges


def _jax_per_device(shape, body, *arrays):
    """Run ``body`` on every device of a JAX mesh of ``shape``, on each
    device's slice of the (R, C, n) ``arrays``; (R, C, ...) results."""
    mesh = jax_make_mesh(shape)
    spec = P("row", "col", None)

    @jax.jit
    @partial(shard_map, mesh=mesh, in_specs=(spec,) * len(arrays), out_specs=spec,
             check_vma=False)
    def run(*locals_):
        outs = body(*[a[0, 0] for a in locals_])
        return tuple(jnp.atleast_1d(o)[None, None] for o in outs)

    sharding = NamedSharding(mesh, spec)
    return [np.asarray(o) for o in run(*[jax.device_put(a, sharding) for a in arrays])]


def _jax_exchange(shape, name):
    _, ex = _inputs()
    keys, valid = ex["shape_keys"][shape]
    v = ex["num_vertices"]
    vp = -(-v // (shape[0] * shape[1]))

    def local(a):  # a (V,) array as (R, C, vp) range slices, q = j * R + i
        pad = np.zeros(shape[0] * shape[1] * vp, a.dtype)
        pad[:v] = a
        return pad.reshape(shape[1], shape[0], vp).transpose(1, 0, 2)

    cap = ex["capacity"]
    if name in ("collect", "collect_unique"):
        fn = (jax_mg_prims.collect_values_for_keys if name == "collect"
              else jax_mg_prims.collect_values_for_unique_keys)
        return _jax_per_device(shape, lambda k, ok, x: fn(k, ok, x, vp, cap),
                               keys, valid, local(ex["values"]))
    if name == "shuffle":
        def body(k, ok):
            k2, items, v2, ov = jax_mg_prims.shuffle_to_vertex_owners(
                k, {"x": k.astype(jnp.float32) * 0.5}, ok, vp, cap)
            return k2, items["x"], v2, ov
        return _jax_per_device(shape, body, keys, valid)
    if name == "overflow":
        def body(k):
            k2, items, v2, ov = jax_mg_prims.shuffle_to_vertex_owners(
                jnp.zeros(8, jnp.int32), {"x": jnp.arange(8, dtype=jnp.float32)},
                jnp.ones(8, bool), vp, 2)
            return k2, items["x"], v2, ov
        return _jax_per_device(shape, body, keys)
    gid = np.arange(shape[0] * shape[1] * vp)
    return _jax_per_device(
        shape, lambda lab, k, m: jax_mg_prims.cluster_weight_sums(lab, k, m, vp, cap),
        local(ex["labels"]), local(ex["weights"]), local(gid < v))


@shapes
@pytest.mark.parametrize("name", ["collect", "collect_unique", "shuffle", "overflow", "sigma"])
def test_keyed_exchange_matches_jax(shape, name):
    want = _jax_exchange(shape, name)
    for r in _port(shape):
        i, j = r["coords"]
        got = r["exchange"][name]
        assert len(got) == len(want)
        for a, b in zip(got, want):
            b = np.asarray(b)[i, j]
            np.testing.assert_array_equal(np.reshape(a, b.shape), b)
        if name == "overflow":
            assert got[-1] > 0
        else:
            assert got[-1] == 0
        if name in ("collect", "collect_unique"):
            _, ex = _inputs()
            keys, valid = ex["shape_keys"][shape]
            out, found = got[0], got[1]
            np.testing.assert_array_equal(found, valid[i, j])
            np.testing.assert_array_equal(out[found], ex["values"][keys[i, j][found]])
