"""cugraph_tpu_torch.dist.mg_community against the port's single-device
functions and the JAX ``dist/mg_community`` on meshes of the same shape.

One spawn per mesh shape (gloo, (1,1), (2,1), (1,2)) runs
``_torch_dist_worker.run_community`` on two symmetrized graphs: karate
(unweighted) and test_dist_extra.py:1127's weighted random graph (V =
180, E = 1200). Tolerances:

- ``mg_modularity``: within ``Q_TOL`` of the single-device ``modularity``
  on the same labels (labels past V and negative ones included) and of
  the JAX ``mg_modularity`` (labels in [0, V));
- ``mg_louvain`` and ``mg_leiden`` in both cluster states: Q within
  ``Q_TOL`` of JAX's on the same mesh shape and of ``modularity`` on
  their own labels; on karate the labels equal JAX's (every weight sum is
  an integer there, so each move is decided on equal scores), and
  ``mg_leiden``'s equal the single-device ``leiden``'s. On the weighted
  graph f32 sums in another order may break a near tie another way, so
  Q is held, not the labels.
"""

import functools

import jax
import numpy as np
import pytest

import _torch_dist_worker as worker
import cugraph_tpu as cg
import cugraph_tpu_torch as ct
from cugraph_tpu.dist import distribute_graph as jax_distribute_graph
from cugraph_tpu.dist import make_mesh as jax_make_mesh
from cugraph_tpu.dist import mg_community as jax_mg_community
from cugraph_tpu.dist.mg_graph import shard_vertex_values as jax_shard
from cugraph_tpu.testing import karate_edgelist

SHAPES = [(1, 1), (2, 1), (1, 2)]
Q_TOL = 1e-6

shapes = pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")


@functools.lru_cache(maxsize=None)
def _inputs():
    ks, kd, _ = karate_edgelist()
    rng = np.random.default_rng(61)  # test_dist_extra.py:1127's weighted random graph
    n, e = 180, 1200
    rnd = dict(src=rng.integers(0, n, e), dst=rng.integers(0, n, e),
               w=rng.random(e).astype(np.float32), num_vertices=n)
    clubs = np.array([0 if u < 17 else 1 for u in range(34)], np.int64)
    return {
        "karate": dict(src=ks, dst=kd, w=None, num_vertices=34,
                       labels={"halves": clubs, "shifted": clubs + 100, "negative": clubs - 7,
                               "singletons": np.arange(34)}),
        "random": dict(rnd, labels={"mod7": np.arange(n) % 7}),
    }


@functools.lru_cache(maxsize=None)
def _port(shape):
    return worker.spawn(worker.run_community, shape[0] * shape[1], shape, _inputs())


def _same_on_every_rank(shape, pick):
    got = [pick(r) for r in _port(shape)]
    for other in got[1:]:
        for a, b in zip(jax.tree.leaves(other), jax.tree.leaves(got[0])):
            np.testing.assert_array_equal(a, b)
    return got[0]


@functools.lru_cache(maxsize=None)
def _jax_community(shape, graph, algo):
    c = _inputs()[graph]
    mesh = jax_make_mesh(shape)
    g = cg.from_edgelist(c["src"], c["dst"], c["w"], num_vertices=c["num_vertices"],
                         symmetrize=True)
    mgg = jax_distribute_graph(mesh, g)
    if algo == "modularity":
        return {name: jax_mg_community.mg_modularity(mesh, mgg, jax_shard(mesh, mgg, lab))
                for name, lab in c["labels"].items() if 0 <= lab.min() and lab.max() < len(lab)}
    # JAX's hypersparse state gives its dense state's labels and Q (its own
    # test_mg_louvain_hypersparse_cluster_state) at 30-70 s a run on the
    # CPU, so both of the port's states are held to JAX's dense run
    return getattr(jax_mg_community, f"mg_{algo}")(mesh, mgg, cluster_state="dense")


def _sg_community(graph):
    c = _inputs()[graph]
    return ct.from_edgelist(c["src"], c["dst"], c["w"], num_vertices=c["num_vertices"],
                            symmetrize=True, device="cpu")


@shapes
@pytest.mark.parametrize("graph", ["karate", "random"])
def test_mg_modularity_matches_single_device(shape, graph):
    got = _same_on_every_rank(shape, lambda r: r["community"][graph]["modularity"])
    g = _sg_community(graph)
    for name, lab in _inputs()[graph]["labels"].items():
        assert abs(got[name] - ct.modularity(g, lab)) <= Q_TOL, name
    for name, q in _jax_community(shape, graph, "modularity").items():
        assert abs(got[name] - q) <= Q_TOL, name


@shapes
@pytest.mark.parametrize("graph", ["karate", "random"])
@pytest.mark.parametrize("algo", ["louvain", "leiden"])
@pytest.mark.parametrize("state", ["dense", "hypersparse"])
def test_mg_louvain_leiden_match_jax(shape, graph, algo, state):
    labels, q, device, levels = _same_on_every_rank(
        shape, lambda r: r["community"][graph][f"{algo}_{state}"])
    assert device == "cpu" and labels.dtype == np.int32  # a tensor on the mesh's device
    assert levels >= 1
    g = _sg_community(graph)
    assert abs(ct.modularity(g, labels) - q) <= Q_TOL
    j_labels, j_q = _jax_community(shape, graph, algo)
    assert abs(q - j_q) <= Q_TOL
    if graph == "karate":
        assert q > 0.35
        np.testing.assert_array_equal(labels, np.asarray(j_labels))
        if algo == "leiden":  # and the single-device leiden's (test_dist_extra.py:1114)
            np.testing.assert_array_equal(labels, ct.leiden(g)[0].numpy())


@shapes
@pytest.mark.parametrize("graph", ["karate", "random"])
def test_one_level_dense_equals_hypersparse(shape, graph):
    """The owner-held Sigma (keyed exchanges) makes the moves of the dense
    one: the same labels and move counts, no overflow."""
    dense = _same_on_every_rank(shape, lambda r: r["community"][graph]["level_dense"])
    hyper = _same_on_every_rank(shape, lambda r: r["community"][graph]["level_hypersparse"])
    np.testing.assert_array_equal(dense[0], hyper[0])
    assert dense[1] == hyper[1] > 0 and dense[2] == hyper[2] == 0


@shapes
def test_mg_decompress_roundtrip(shape):
    s, d, w = _same_on_every_rank(shape, lambda r: r["community"]["random"]["edges"])
    g = _sg_community("random")
    csr = g.csr()
    want = sorted(zip(csr.majors.tolist(), csr.minors.tolist(), csr.weights.tolist()))
    assert sorted(zip(s.tolist(), d.tolist(), w.tolist())) == want


@shapes
def test_no_kernel_launch_on_cpu_ranks(shape):
    for r in _port(shape):
        assert r["launches_before"] == r["launches_after"] == [0, 0, 0]
