"""cugraph_tpu_torch.dist.mg_centrality against the JAX ``dist/`` and the
port's single-device betweenness.

One spawn per mesh shape (gloo, (1,1), (2,1), (1,2)) runs
``_torch_dist_worker.run_centrality``: every rank holds the same
single-device graph and takes its slice of the sources. Tolerances, as
max |got - want| / max |want|:

- exact betweenness (every normalized x endpoints) and exact edge
  betweenness (on [:num_edges]; the JAX package pads its edge slots):
  within ``JAX_REL`` of JAX's ``mg_*`` on a mesh of the same shape (f32
  sums in another order);
- sampled (k = 8, seed 3): within ``SG_REL`` of the port's single-device
  result on the same sources, which sums the same f32 terms, rank by
  rank here.
"""

import functools

import jax
import networkx as nx
import numpy as np
import pytest

import _torch_dist_worker as worker
import cugraph_tpu as cg
from cugraph_tpu.dist import make_mesh as jax_make_mesh
from cugraph_tpu.dist import mg_centrality as jax_mg_centrality

SHAPES = [(1, 1), (2, 1), (1, 2)]
JAX_REL = 1e-5
SG_REL = 1e-6

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


@functools.lru_cache(maxsize=None)
def _cases():
    e = np.array(nx.karate_club_graph().edges(), dtype=np.int32)
    rs, rd, rv = _rmat_np(7, 1000, 8)
    return {
        "karate": dict(src=e[:, 0], dst=e[:, 1], num_vertices=34, symmetrize=True),
        "rmat": dict(src=rs, dst=rd, num_vertices=rv, symmetrize=False),
    }


@functools.lru_cache(maxsize=None)
def _port(shape):
    return worker.spawn(worker.run_centrality, shape[0] * shape[1], shape, _cases())


@functools.lru_cache(maxsize=None)
def _jax(shape, graph):
    c = _cases()[graph]
    g = cg.from_edgelist(c["src"], c["dst"], num_vertices=c["num_vertices"],
                         symmetrize=c["symmetrize"])
    return jax_make_mesh(shape), g


def _close(got, want, rel):
    want = np.asarray(want)
    err = np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)
    assert err <= rel, err


@shapes
@graphs
@pytest.mark.parametrize("endpoints", [False, True])
@pytest.mark.parametrize("normalized", [False, True])
def test_mg_betweenness_exact_matches_jax(shape, graph, normalized, endpoints):
    mesh, g = _jax(shape, graph)
    want = jax_mg_centrality.mg_betweenness_centrality(
        mesh, g, normalized=normalized, endpoints=endpoints)
    for r in _port(shape):
        _close(r[graph][("bc", normalized, endpoints)], want, JAX_REL)


@shapes
@graphs
def test_mg_edge_betweenness_exact_matches_jax(shape, graph):
    mesh, g = _jax(shape, graph)
    want = np.asarray(jax_mg_centrality.mg_edge_betweenness_centrality(mesh, g))
    for r in _port(shape):
        got = r[graph]["ebc"]
        assert got.shape == (g.num_edges,)
        _close(got, want[: g.num_edges], JAX_REL)


@shapes
@graphs
def test_mg_betweenness_sampled_matches_single_device(shape, graph):
    """k = 8 sources from the single-device rule on every mesh."""
    for r in _port(shape):
        _close(r[graph]["bc_k8"], r[graph]["sg_bc_k8"], SG_REL)
        _close(r[graph]["ebc_k8"], r[graph]["sg_ebc_k8"], SG_REL)


@shapes
@graphs
def test_mg_betweenness_ranks_launch_no_kernel_on_the_cpu(shape, graph):
    """The sweeps run spmv_sum's plain version on CPU tensors."""
    for r in _port(shape):
        assert r[graph]["launches"] == [0, 0, 0]


def test_jax_devices_cover_the_meshes():
    assert len(jax.devices()) >= max(r * c for r, c in SHAPES)
