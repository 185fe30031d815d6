"""cugraph_tpu_torch.dist.mg_sampling against the JAX ``dist/`` on the
same uniforms.

The JAX sampler draws its uniforms inside from a PRNG key; the port draws
them from a ``torch.Generator``. So the test draws JAX's uniforms as
``cugraph_tpu/dist/mg_sampling.py`` does (a split of the key a hop, then
``jax.random.uniform`` of (sizes[h], k); (n, 1) a walk step) and feeds
them to the port's ``_sample_with_uniforms`` and ``_walk_with_uniforms``
in the ranks of ``_torch_dist_worker.run_sampling`` (gloo, one spawn a
mesh shape). Both methods, with and without replacement, on a weighted
karate and an unweighted R-MAT graph, symmetrized: sources,
destinations, hops, weights and edge ids equal to JAX's, and the walks
equal. A shuffle capacity of 1 overflows, is doubled until it holds, and
gives the same edges. The public entry points, drawing from a generator
seeded 7, give the same draw on the three mesh shapes, each of one row or
one column, where a vertex's slots follow its global dst order.
"""

import functools

import jax
import numpy as np
import pytest

import _torch_dist_worker as worker
from cugraph_tpu.dist import distribute_edgelist as jax_distribute_edgelist
from cugraph_tpu.dist import make_mesh as jax_make_mesh
from cugraph_tpu.dist import mg_sampling as jax_mg_sampling
from cugraph_tpu.testing import karate_edgelist

SHAPES = [(1, 1), (2, 1), (1, 2)]
KEY = 11
WALK_KEY = 5
WALK_DEPTH = 5
KEYS = ("sources", "destinations", "weights", "edge_ids", "hop")

shapes = pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
graphs = pytest.mark.parametrize("graph", ["karate", "rmat"])
replacement = pytest.mark.parametrize("repl", [False, True], ids=["distinct", "replace"])


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
def _graphs():
    rng = np.random.default_rng(17)
    ks, kd, _ = karate_edgelist()
    rs, rd, rv = _rmat_np(8, 2000, 6)
    return {
        "karate": dict(src=ks, dst=kd, w=(0.5 + rng.random(len(ks))).astype(np.float32),
                       num_vertices=34, seeds=np.array([0, 5, 33, 11, 2], np.int32),
                       fanouts=[4, 3]),
        "rmat": dict(src=rs, dst=rd, w=None, num_vertices=rv,
                     seeds=rng.integers(0, rv, 9).astype(np.int32), fanouts=[5, 2]),
    }


def _jax_uniforms(n_seeds, fanouts, n_dev, key):
    """The uniforms JAX's mg_uniform_neighbor_sample draws from ``key``."""
    rng_key = jax.random.PRNGKey(key)
    n_pad = max(-(-n_seeds // n_dev) * n_dev, n_dev)
    sizes = [n_pad]
    for k in fanouts:
        sizes.append(sizes[-1] * k)
    us = []
    for h, k in enumerate(fanouts):
        rng_key, sub = jax.random.split(rng_key)
        us.append(np.asarray(jax.random.uniform(sub, (sizes[h], k))))
    return us


def _jax_walk_uniforms(n, depth, key):
    rng_key = jax.random.PRNGKey(key)
    us = []
    for _ in range(depth):
        rng_key, sub = jax.random.split(rng_key)
        us.append(np.asarray(jax.random.uniform(sub, (n, 1))))
    return us


def _cases(shape):
    n_dev = shape[0] * shape[1]
    cases = {}
    for name, g in _graphs().items():
        c = dict(g)
        # the same key both ways: with and without replacement draw alike
        us = _jax_uniforms(len(g["seeds"]), g["fanouts"], n_dev, KEY)
        c["us"] = {False: us, True: us}
        c["walk_us"] = _jax_walk_uniforms(len(g["seeds"]), WALK_DEPTH, WALK_KEY)
        cases[name] = c
    return cases


@functools.lru_cache(maxsize=None)
def _port(shape):
    return worker.spawn(worker.run_sampling, shape[0] * shape[1], shape, _cases(shape))


@functools.lru_cache(maxsize=None)
def _jax_graph(shape, graph):
    g = _graphs()[graph]
    mesh = jax_make_mesh(shape)
    return mesh, jax_distribute_edgelist(mesh, g["src"], g["dst"], g["w"],
                                         num_vertices=g["num_vertices"], symmetrize=True)


@functools.lru_cache(maxsize=None)
def _jax_sample(shape, graph, method, repl):
    mesh, mgg = _jax_graph(shape, graph)
    g = _graphs()[graph]
    return jax_mg_sampling.mg_uniform_neighbor_sample(
        mesh, mgg, g["seeds"], g["fanouts"], rng_key=jax.random.PRNGKey(KEY),
        with_replacement=repl, method=method)


def _equal_results(got, want):
    for k in KEYS:
        if want[k] is None:
            assert got[k] is None, k
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@shapes
@graphs
@replacement
@pytest.mark.parametrize("method", ["replicate", "shuffle"])
def test_mg_sample_fed_jax_uniforms_equals_jax(shape, graph, repl, method):
    want = _jax_sample(shape, graph, method, repl)
    assert len(want["sources"]) > 0
    for r in _port(shape):
        _equal_results(r[graph][(method, repl)], want)


@shapes
@graphs
@replacement
def test_shuffle_capacity_overflow_retries_to_the_same_edges(shape, graph, repl):
    for r in _port(shape):
        _equal_results(r[graph][("shuffle_cap1", repl)], r[graph][("replicate", repl)])


@shapes
@graphs
def test_mg_random_walks_fed_jax_uniforms_equal_jax(shape, graph):
    mesh, mgg = _jax_graph(shape, graph)
    g = _graphs()[graph]
    want = jax_mg_sampling.mg_random_walks(mesh, mgg, g["seeds"], WALK_DEPTH,
                                           rng_key=jax.random.PRNGKey(WALK_KEY))
    for r in _port(shape):
        np.testing.assert_array_equal(r[graph]["walks"], want)


@graphs
@replacement
def test_same_generator_seed_same_draw_on_every_mesh(graph, repl):
    """Edges, weights and hops (the edge ids name each rank's storage)."""
    first = _port(SHAPES[0])[0][graph]
    for shape in SHAPES:
        for r in _port(shape):
            got = r[graph][("generator", repl)]
            for k in ("sources", "destinations", "weights", "hop"):
                want = first[("generator", repl)][k]
                if want is None:
                    assert got[k] is None
                else:
                    np.testing.assert_array_equal(got[k], want, err_msg=k)
            np.testing.assert_array_equal(r[graph]["generator_walks"], first["generator_walks"])


@graphs
def test_generator_draw_is_a_valid_sample(graph):
    """The generator's draw: each sampled edge an edge of the graph, its
    weight the edge's, distinct slots and min(fanout, degree) a seed
    without replacement; walks step along edges."""
    g = _graphs()[graph]
    edges = {}
    for s, d, w in zip(g["src"], g["dst"], g["w"] if g["w"] is not None else [None] * len(g["src"])):
        for a, b in ((s, d), (d, s)):
            edges.setdefault((int(a), int(b)), set()).add(None if w is None else float(w))
    deg = {}
    for a, _ in edges:
        deg[a] = deg.get(a, 0) + 1
    r = _port((1, 1))[0][graph]
    for repl in (False, True):
        res = r[("generator", repl)]
        for i, (s, d) in enumerate(zip(res["sources"], res["destinations"])):
            assert (int(s), int(d)) in edges
            if res["weights"] is not None:
                assert float(res["weights"][i]) in edges[(int(s), int(d))]
        hop0 = res["hop"] == 0
        for s in g["seeds"]:
            got = res["destinations"][hop0 & (res["sources"] == s)]
            want = min(g["fanouts"][0], deg.get(int(s), 0)) if not repl else (
                g["fanouts"][0] if deg.get(int(s), 0) else 0)
            assert len(got) == want * int((g["seeds"] == s).sum())
            if not repl and (g["seeds"] == s).sum() == 1:
                assert len(set(got.tolist())) == len(got)
    for row in r["generator_walks"]:
        for a, b in zip(row[:-1], row[1:]):
            if b >= 0:
                assert (int(a), int(b)) in edges
            else:
                assert deg.get(int(a), 0) == 0 or a < 0


@shapes
def test_sampling_ranks_launch_no_kernel(shape):
    for r in _port(shape):
        assert r["launches_before"] == r["launches_after"] == [0, 0, 0]
