"""GNN training on cugraph_tpu_torch against cugraph_tpu: the neighbor
loaders, a GraphSAGE loss and its gradients on a sampled block, and one
Adam step.

- Loader: fed the same sampled result, both packages' ``_build_block``
  give the same block, exactly; with take-all fanouts (no draw) whole
  loaders give the same blocks; the shuffle order comes from numpy's
  ``default_rng(seed)`` in both; ``LinkNeighborLoader``'s seeds are equal.
- Trainer: the flax parameters carried over with ``graphsage_from_flax``;
  the cross-entropy over a block's seeds and every parameter gradient
  within 1e-5 relative of JAX's ``value_and_grad`` (both exact f32 on the
  CPU), on the dense path and on the sparse path (``DENSE_MAX_VERTICES``
  patched to 0 in both packages); ``torch.optim.Adam`` and
  ``optax.adam`` fed the same gradients within 1e-6 (absolute).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import cugraph_tpu as cg
import cugraph_tpu.prims.dense_spmm as jax_dense
import cugraph_tpu_torch as ct
import cugraph_tpu_torch.prims.dense_spmm as port_dense
from cugraph_tpu.gnn import GraphSAGE as JaxGraphSAGE
from cugraph_tpu.gnn import LinkNeighborLoader as JaxLinkNeighborLoader
from cugraph_tpu.gnn import NeighborLoader as JaxNeighborLoader
from cugraph_tpu.testing import karate_edgelist
from cugraph_tpu_torch.gnn import LinkNeighborLoader, NeighborLoader, graphsage_from_flax

F, HIDDEN, CLASSES = 16, 16, 4
TOL_REL = 1e-5
TOL_ADAM = 1e-6


def _rmat_np(scale, num_edges, seed):
    rng = np.random.default_rng(seed)
    src = np.zeros(num_edges, np.int64)
    dst = np.zeros(num_edges, np.int64)
    for _ in range(scale):
        sb = rng.random(num_edges) < 0.38
        db = rng.random(num_edges) < np.where(sb, 0.19 / 0.38, 0.19 / 0.76)
        src, dst = (src << 1) | sb, (dst << 1) | db
    return src.astype(np.int32), dst.astype(np.int32), 1 << scale


def _graphs(name):
    """(JAX graph, port graph) of one edge list."""
    if name == "karate":
        src, dst, _ = karate_edgelist()
        return (cg.from_edgelist(src, dst, symmetrize=True),
                ct.from_edgelist(src, dst, symmetrize=True, device="cpu"))
    src, dst, v = _rmat_np(9, 4096, 3)
    w = np.random.default_rng(3).random(len(src)).astype(np.float32) + 0.5
    return (cg.from_edgelist(src, dst, w, num_vertices=v),
            ct.from_edgelist(src, dst, w, num_vertices=v, device="cpu"))


def _assert_same_block(got, want):
    assert got.num_seeds == want.num_seeds
    np.testing.assert_array_equal(got.n_ids.numpy(), want.n_ids)
    np.testing.assert_array_equal(got.seed_ids.numpy(), want.seed_ids)
    assert got.graph.num_vertices == want.graph.num_vertices
    assert got.graph.num_edges == want.graph.num_edges
    e = want.graph.num_edges
    for kind in ("csr", "csc"):
        a, b = getattr(got.graph, kind)(), getattr(want.graph, kind)()
        np.testing.assert_array_equal(a.offsets.numpy(), np.asarray(b.offsets))
        for key in ("minors", "majors", "weights"):
            ours, theirs = getattr(a, key), getattr(b, key)
            if theirs is None:
                assert ours is None
            else:
                np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs)[:e])


# ---------------------------------------------------------------- loader


@pytest.mark.parametrize("graph", ["karate", "rmat"])
@pytest.mark.parametrize("fanouts", [[4, 3], [2, 2, 2]])
def test_build_block_matches_jax(graph, fanouts):
    """One sampled result (the JAX sampler's draws) through both packages'
    _build_block: the same compact ids, seeds first, and the same CSR/CSC."""
    jg, tg = _graphs(graph)
    batch = np.random.default_rng(7).choice(tg.num_vertices, 12, replace=False).astype(np.int32)
    res = cg.uniform_neighbor_sample(jg, batch, fanouts, rng_key=jax.random.PRNGKey(5))
    want = JaxNeighborLoader(jg, batch, fanouts)._build_block(batch, res)
    tres = {k: None if a is None else torch.from_numpy(np.asarray(a)) for k, a in res.items()}
    got = NeighborLoader(tg, batch, fanouts)._build_block(torch.from_numpy(batch), tres)
    _assert_same_block(got, want)
    np.testing.assert_array_equal(got.n_ids[: got.num_seeds].numpy(), batch)


@pytest.mark.parametrize("graph", ["karate", "rmat"])
def test_take_all_loader_matches_jax(graph):
    """fanouts [-1, -1] draw nothing, so every block of the two loaders is
    the same, batch after batch."""
    jg, tg = _graphs(graph)
    seeds = np.arange(0, tg.num_vertices, 3, dtype=np.int32)[:40]
    size = len(seeds) // 3 + 1
    want = list(JaxNeighborLoader(jg, seeds, [-1, -1], batch_size=size))
    got = list(NeighborLoader(tg, seeds, [-1, -1], batch_size=size))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        _assert_same_block(a, b)


def test_shuffle_order_matches_jax():
    """shuffle=True: the same batches in the same order, and in the next
    epoch the next permutation of numpy's generator."""
    jg, tg = _graphs("karate")
    seeds = np.arange(34, dtype=np.int32)
    for seed in (0, 7):
        jloader = JaxNeighborLoader(jg, seeds, [2], batch_size=5, shuffle=True, seed=seed)
        loader = NeighborLoader(tg, seeds, [2], batch_size=5, shuffle=True, seed=seed)
        assert len(loader) == len(jloader) == 7
        for _ in range(2):
            got = [b.seed_ids.numpy() for b in loader]
            want = [b.seed_ids for b in jloader]
            assert len(got) == len(want)
            for x, y in zip(got, want):
                np.testing.assert_array_equal(x, y)
            assert sorted(np.concatenate(got).tolist()) == list(range(34))


def test_loader_blocks_are_graph_edges_and_seeded():
    """Drawn fanouts: every block edge is a graph edge under n_ids, the
    seeds take compact ids [0, num_seeds), and the same generator seed
    gives the same blocks."""
    _, tg = _graphs("rmat")
    edges = set(zip(tg.csr().majors.tolist(), tg.csr().minors.tolist()))
    seeds = np.arange(100, dtype=np.int32)

    def blocks():
        gen = torch.Generator().manual_seed(11)
        return list(NeighborLoader(tg, seeds, [5, 3], batch_size=32, generator=gen))

    first, again = blocks(), blocks()
    assert sum(b.num_seeds for b in first) == 100
    for b, c in zip(first, again):
        _assert_same_block(b, _as_jax_like(c))
        np.testing.assert_array_equal(b.n_ids[: b.num_seeds].numpy(), b.seed_ids.numpy())
        csr = b.graph.csr()
        gs, gd = b.n_ids[csr.majors.long()], b.n_ids[csr.minors.long()]
        assert set(zip(gs.tolist(), gd.tolist())) <= edges


def _as_jax_like(block):
    """A port block with numpy id maps, for _assert_same_block."""
    import types

    return types.SimpleNamespace(num_seeds=block.num_seeds, n_ids=block.n_ids.numpy(),
                                 seed_ids=block.seed_ids.numpy(), graph=block.graph)


def test_link_loader_seeds_match_jax():
    jg, tg = _graphs("karate")
    pairs = np.array([[5, 0], [33, 2], [0, 16], [2, 9]], dtype=np.int32)
    want = JaxLinkNeighborLoader(jg, pairs, [-1], batch_size=3)
    got = LinkNeighborLoader(tg, pairs, [-1], batch_size=3)
    np.testing.assert_array_equal(got.seeds.numpy(), want.seeds)
    np.testing.assert_array_equal(got.edge_pairs.numpy(), want.edge_pairs)
    for a, b in zip(got, want):
        _assert_same_block(a, b)


def test_duplicate_seeds_raise():
    """A batch that holds a seed twice has no compact map with the seeds at
    [0, batch): the port raises ValueError, as the JAX package's numpy
    assignment does (a shape mismatch). Where that assignment happens to
    broadcast (exactly one non-seed id past the batch) the JAX map is not
    a permutation; the port raises there too."""
    jg, tg = _graphs("karate")
    batch = np.array([3, 5, 3], dtype=np.int32)
    res = cg.uniform_neighbor_sample(jg, batch, [-1])
    with pytest.raises(ValueError):
        JaxNeighborLoader(jg, batch, [-1])._build_block(batch, res)
    tres = {k: None if a is None else torch.from_numpy(np.asarray(a)) for k, a in res.items()}
    with pytest.raises(ValueError, match="more than once"):
        NeighborLoader(tg, batch, [-1])._build_block(torch.from_numpy(batch), tres)
    with pytest.raises(ValueError, match="more than once"):
        list(NeighborLoader(tg, batch, [-1], batch_size=3))
    # the broadcast case: a seed of out-degree 2, twice
    deg = np.asarray(jg.out_degrees())
    v2 = int(np.flatnonzero(deg == 2)[0])
    batch = np.array([v2, v2], dtype=np.int32)
    res = cg.uniform_neighbor_sample(jg, batch, [-1])
    block = JaxNeighborLoader(jg, batch, [-1])._build_block(batch, res)
    e = block.graph.num_edges
    # the JAX block sends the seed's two distinct neighbours to one compact id
    assert len(np.unique(np.asarray(block.graph.csr().minors)[:e])) < len(
        np.unique(np.asarray(res["destinations"])))
    with pytest.raises(ValueError, match="more than once"):
        list(NeighborLoader(tg, batch, [-1], batch_size=2))


# --------------------------------------------------------------- trainer


@functools.lru_cache(maxsize=None)
def _block_and_data():
    """A sampled block of the R-MAT graph (its weights ride along), seeded
    features and labels of its vertices."""
    jg, tg = _graphs("rmat")
    batch = np.arange(0, 64, 2, dtype=np.int32)
    res = cg.uniform_neighbor_sample(jg, batch, [5, 3], rng_key=jax.random.PRNGKey(2))
    jblock = JaxNeighborLoader(jg, batch, [5, 3])._build_block(batch, res)
    tres = {k: None if a is None else torch.from_numpy(np.asarray(a)) for k, a in res.items()}
    tblock = NeighborLoader(tg, batch, [5, 3])._build_block(torch.from_numpy(batch), tres)
    rng = np.random.default_rng(17)
    v = tg.num_vertices
    feats = rng.normal(size=(v, F)).astype(np.float32)
    labels = rng.integers(0, CLASSES, v).astype(np.int32)
    return jblock, tblock, feats[jblock.n_ids], labels[jblock.n_ids]


@functools.lru_cache(maxsize=None)
def _flax_sage():
    """The flax GraphSAGE and its parameters, initialised once on the
    block (the parameters do not depend on the aggregation's path)."""
    jblock, _, x, _ = _block_and_data()
    model = JaxGraphSAGE(hidden_features=HIDDEN, out_features=CLASSES, num_layers=2)
    return model, model.init(jax.random.PRNGKey(3), jblock.graph, jnp.asarray(x))


def _jax_loss_fn(model, block):
    def loss_fn(params, x, y):
        out = model.apply(params, block.graph, x)
        seed_mask = (jnp.arange(out.shape[0]) < block.num_seeds).astype(jnp.float32)
        per_node = optax.softmax_cross_entropy_with_integer_labels(out, y)
        return jnp.sum(per_node * seed_mask) / jnp.maximum(jnp.sum(seed_mask), 1.0)

    return loss_fn


def _port_loss(model, block, x, y):
    out = model(block.graph, x)
    return torch.nn.functional.cross_entropy(out[: block.num_seeds], y[: block.num_seeds])


def _port_grads(model):
    """The module's gradients as the flax tree's numpy leaves (kernel (in,
    out), bias)."""
    out = {}
    for i, conv in enumerate(model.convs):
        for name, lin in (("self", conv.lin_self), ("nbr", conv.lin_nbr)):
            out[(f"conv{i}", name, "kernel")] = lin.weight.grad.numpy().T
            out[(f"conv{i}", name, "bias")] = lin.bias.grad.numpy()
    return out


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


@pytest.mark.parametrize("path", ["dense", "sparse"])
def test_sage_loss_and_gradients_match_jax(path, monkeypatch):
    if path == "sparse":
        monkeypatch.setattr(jax_dense, "DENSE_MAX_VERTICES", 0)
        monkeypatch.setattr(port_dense, "DENSE_MAX_VERTICES", 0)
    jblock, tblock, x, y = _block_and_data()
    assert tblock.graph.num_vertices > 100 and tblock.graph.num_edges > 100
    model, params = _flax_sage()
    loss, grads = jax.jit(jax.value_and_grad(_jax_loss_fn(model, jblock)))(
        params, jnp.asarray(x), jnp.asarray(y))
    port = graphsage_from_flax(params, F, HIDDEN, CLASSES, 2, device="cpu")
    got = _port_loss(port, tblock, torch.from_numpy(x), torch.from_numpy(y).long())
    got.backward()
    assert abs(got.item() - float(loss)) <= TOL_REL * abs(float(loss))
    want = grads["params"]
    for (conv, part, leaf), g in _port_grads(port).items():
        w = np.asarray(want[conv][part][leaf])
        assert g.shape == w.shape and np.abs(w).max() > 0
        assert _rel(g, w) <= TOL_REL, (conv, part, leaf)


def test_adam_step_matches_optax():
    """Two steps of torch.optim.Adam and optax.adam (lr 1e-3) from the same
    flax parameters, each fed the same gradients: the port's at its
    current parameters, carried into the flax tree."""
    _, tblock, x, y = _block_and_data()
    _, params = _flax_sage()
    port = graphsage_from_flax(params, F, HIDDEN, CLASSES, 2, device="cpu")
    tx = optax.adam(1e-3)
    state = tx.init(params)
    opt = torch.optim.Adam(port.parameters(), lr=1e-3)

    @jax.jit
    def step(params, state, grads):
        updates, state = tx.update(grads, state)
        return optax.apply_updates(params, updates), state

    for _ in range(2):
        opt.zero_grad()
        _port_loss(port, tblock, torch.from_numpy(x), torch.from_numpy(y).long()).backward()
        tree = {}
        for (conv, part, leaf), g in _port_grads(port).items():
            tree.setdefault(conv, {}).setdefault(part, {})[leaf] = jnp.asarray(g)
        params, state = step(params, state, {"params": tree})
        opt.step()
        for i, conv in enumerate(port.convs):
            for name, lin in (("self", conv.lin_self), ("nbr", conv.lin_nbr)):
                p = params["params"][f"conv{i}"][name]
                np.testing.assert_allclose(lin.weight.detach().numpy(),
                                           np.asarray(p["kernel"]).T, rtol=0, atol=TOL_ADAM)
                np.testing.assert_allclose(lin.bias.detach().numpy(), np.asarray(p["bias"]),
                                           rtol=0, atol=TOL_ADAM)


def test_training_on_blocks_lowers_the_loss():
    """The minibatch loop on the CPU: loader -> block -> GraphSAGE ->
    cross-entropy -> backward -> Adam; 10 steps on one block lower its
    loss, and every loss of a pass over the loader is finite."""
    _, tg = _graphs("rmat")
    rng = np.random.default_rng(23)
    feats = torch.from_numpy(rng.normal(size=(tg.num_vertices, F)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, CLASSES, tg.num_vertices))
    model = ct.gnn.GraphSAGE(F, HIDDEN, CLASSES, 2, device="cpu")
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    loader = NeighborLoader(tg, np.arange(96), [5, 3], batch_size=32, shuffle=True)
    for block in loader:
        ids = block.n_ids.long()
        loss = _port_loss(model, block, feats[ids], labels[ids])
        opt.zero_grad()
        loss.backward()
        opt.step()
        assert torch.isfinite(loss)
    ids = block.n_ids.long()
    first = _port_loss(model, block, feats[ids], labels[ids]).item()
    for _ in range(10):
        loss = _port_loss(model, block, feats[ids], labels[ids])
        opt.zero_grad()
        loss.backward()
        opt.step()
    assert _port_loss(model, block, feats[ids], labels[ids]).item() < first
