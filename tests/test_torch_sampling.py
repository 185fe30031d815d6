"""Sampling of cugraph_tpu_torch against cugraph_tpu on the CPU.

The two packages draw from different generators (torch's Philox, JAX's
threefry), so:
- EXACT parity where the draw cannot matter: Floyd's take-all for a
  degree <= K, fanout = -1 after compress, and walks (uniform, biased,
  node2vec) on graphs where every out-degree is <= 1, sinks padded with -1;
- structure and distribution elsewhere, as tests/test_sampling.py holds
  the JAX package: every sampled edge exists, slots without replacement
  are distinct, a chi-square test of Floyd's draw against the uniform
  (p = 0.001), node2vec returns more often as p falls;
- the same generator seed gives the same result twice, and the walks do
  not depend on how many chunks their rows are expanded in.
"""

import importlib

import networkx as nx
import numpy as np
import pytest
import torch
from scipy import stats

import cugraph_tpu as cg
import cugraph_tpu_torch as ct
from cugraph_tpu.prims.random_select import per_v_random_select_outgoing_e as jselect
from cugraph_tpu_torch.prims import per_v_random_select_outgoing_e as tselect

# the module (the package exports its function of the same name)
twalks = importlib.import_module("cugraph_tpu_torch.sampling.random_walks")

import jax


def _karate(weighted=False):
    e = np.array(nx.karate_club_graph().edges(), dtype=np.int32)
    w = np.random.default_rng(4).random(len(e)).astype(np.float32) + 0.1 if weighted else None
    return (cg.from_edgelist(e[:, 0], e[:, 1], w, num_vertices=34, symmetrize=True),
            ct.from_edgelist(e[:, 0], e[:, 1], w, num_vertices=34, symmetrize=True, device="cpu"))


def _rmat(scale=12, weighted=False):
    rng = np.random.default_rng(scale)
    e = 8 << scale
    src = np.zeros(e, np.int64)
    dst = np.zeros(e, np.int64)
    for _ in range(scale):
        sb = rng.random(e) < 0.38
        db = rng.random(e) < np.where(sb, 0.19 / 0.38, 0.19 / 0.76)
        src, dst = (src << 1) | sb, (dst << 1) | db
    w = rng.random(e).astype(np.float32) + 0.1 if weighted else None
    return ct.from_edgelist(src.astype(np.int32), dst.astype(np.int32), w, num_vertices=1 << scale,
                            device="cpu")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _edges(g):
    adj = g.csr()
    return set(zip(adj.majors.tolist(), adj.minors.tolist()))


def test_take_all_matches_jax():
    jg, tg = _karate(weighted=True)
    deg = np.asarray(jg.out_degrees())
    verts = np.concatenate([np.arange(34), [-1, 3]]).astype(np.int32)
    k = 5
    js, jd, jw, jv = (np.asarray(a) for a in jselect(jg, jax.random.PRNGKey(0), verts, k))
    ts, td, tw, tv = (a.numpy() for a in tselect(tg, _gen(0), torch.from_numpy(verts), k))
    np.testing.assert_array_equal(tv, jv)
    small = np.where(verts >= 0, deg[np.maximum(verts, 0)] <= k, True)
    np.testing.assert_array_equal(td[small][tv[small]], jd[small][jv[small]])
    np.testing.assert_array_equal(tw[small][tv[small]], jw[small][jv[small]])
    np.testing.assert_array_equal(ts[tv], js[jv])
    assert not tv[verts < 0].any()


@pytest.mark.parametrize("with_replacement", [False, True])
def test_valid_edges_and_distinct_slots(with_replacement):
    _, tg = _karate()
    edges = _edges(tg)
    deg = tg.out_degrees().numpy()
    verts = torch.arange(34, dtype=torch.int32).repeat(20)
    s, d, w, valid = tselect(tg, _gen(1), verts, 4, with_replacement=with_replacement)
    assert w is None and s.shape == d.shape == valid.shape == (680, 4)
    for i in range(verts.numel()):
        got = d[i][valid[i]].tolist()
        v = int(verts[i])
        assert len(got) == (min(deg[v], 4) if not with_replacement else (4 if deg[v] else 0))
        assert all((v, x) in edges for x in got)
        if not with_replacement:
            assert len(set(got)) == len(got)


@pytest.mark.parametrize("k", [1, 2, 5])
def test_floyd_is_uniform(k):
    """Vertex 33 of karate has degree 17: each neighbour is in a K-subset
    with probability K / 17, and every pair equally often for K = 2."""
    _, tg = _karate()
    trials = 4000
    _, d, _, valid = tselect(tg, _gen(7 + k), torch.full((trials,), 33, dtype=torch.int32), k)
    assert bool(valid.all())
    nbrs = sorted({x for (u, x) in _edges(tg) if u == 33})
    counts = np.array([(d == x).sum().item() for x in nbrs])
    assert counts.sum() == trials * k
    chi2 = ((counts - trials * k / len(nbrs)) ** 2 / (trials * k / len(nbrs))).sum()
    assert chi2 < stats.chi2.ppf(0.999, len(nbrs) - 1)
    if k == 2:
        pairs = {}
        for a, b in d.sort(1).values.tolist():
            pairs[(a, b)] = pairs.get((a, b), 0) + 1
        n_pairs = len(nbrs) * (len(nbrs) - 1) // 2
        obs = np.array(list(pairs.values()) + [0] * (n_pairs - len(pairs)))
        exp = trials / n_pairs
        assert ((obs - exp) ** 2 / exp).sum() < stats.chi2.ppf(0.999, n_pairs - 1)


@pytest.mark.parametrize("weighted", [False, True])
def test_all_neighbors_matches_jax_after_compress(weighted):
    jg, tg = _karate(weighted)
    starts = [0, 33, 5]
    want = cg.uniform_neighbor_sample(jg, starts, [-1, -1])
    got = ct.uniform_neighbor_sample(tg, starts, [-1, -1])
    for key in ("sources", "destinations", "hop"):
        np.testing.assert_array_equal(got[key].numpy(), want[key])
    if weighted:
        np.testing.assert_array_equal(got["weights"].numpy(), want["weights"])
    else:
        assert got["weights"] is None and want["weights"] is None
    deg = tg.out_degrees().numpy()
    assert (got["hop"] == 0).sum() == deg[starts].sum()


def test_all_neighbors_padded_rows_match_jax():
    """compress=False lays a fanout -1 hop out as a padded tile (the
    frontier's widest row, where JAX takes the graph's): each row's valid
    slots are the JAX row's, in order."""
    jg, tg = _karate(weighted=True)
    starts = [0, 33, -1, 5]
    (js, jd, jw, jv), = cg.uniform_neighbor_sample(jg, starts, [-1], compress=False)
    (ts, td, tw, tv), = ct.uniform_neighbor_sample(tg, starts, [-1], compress=False)
    deg = tg.out_degrees().numpy()
    assert td.shape == (4, deg[[0, 33, 5]].max())
    for r in range(4):
        jm, tm = np.asarray(jv[r]), tv[r].numpy()
        np.testing.assert_array_equal(td[r].numpy()[tm], np.asarray(jd[r])[jm])
        np.testing.assert_array_equal(tw[r].numpy()[tm], np.asarray(jw[r])[jm])
        np.testing.assert_array_equal(ts[r].numpy()[tm], np.asarray(js[r])[jm])
    assert not tv[2].any()


@pytest.mark.parametrize("budget", [None, 7])
def test_all_neighbors_same_in_both_modes_and_chunkings(monkeypatch, budget):
    """A fanout -1 hop between random hops: compress=True gives the valid
    slots of compress=False at the same seed, and expanding the rows a few
    edges at a time changes nothing."""
    g = _rmat(10, weighted=True)
    starts = torch.arange(0, 1024, 41, dtype=torch.int32)
    fanouts = [3, -1, 2]
    want = ct.uniform_neighbor_sample(g, starts, fanouts, generator=_gen(5))
    if budget is not None:
        mod = importlib.import_module("cugraph_tpu_torch.sampling.uniform_neighbor_sample")
        monkeypatch.setattr(mod, "PAIR_BUDGET", budget)
    got = ct.uniform_neighbor_sample(g, starts, fanouts, generator=_gen(5))
    per_hop = ct.uniform_neighbor_sample(g, starts, fanouts, generator=_gen(5), compress=False)
    for key in ("sources", "destinations", "weights", "hop"):
        assert torch.equal(got[key], want[key])
    for key, i in (("sources", 0), ("destinations", 1), ("weights", 2)):
        assert torch.equal(torch.cat([p[i][p[3]] for p in per_hop]), want[key])
    h = want["hop"]
    # hop 1 is every out-edge of the hop-0 destinations, in their order
    d0 = want["destinations"][h == 0].long()
    deg = g.out_degrees().long()
    assert torch.equal(want["sources"][h == 1].long(), d0.repeat_interleave(deg[d0]))
    assert set(zip(want["sources"].tolist(), want["destinations"].tolist())) <= _edges(g)


@pytest.mark.parametrize("with_replacement", [False, True])
def test_neighbor_sample_structure_and_seed(with_replacement):
    g = _rmat(12, weighted=True)
    edges = _edges(g)
    starts = torch.arange(0, 4096, 37, dtype=torch.int32)
    run = lambda: ct.uniform_neighbor_sample(  # noqa: E731
        g, starts, [5, 3], with_replacement=with_replacement, generator=_gen(3))
    got, again = run(), run()
    for key in ("sources", "destinations", "weights", "hop"):
        assert torch.equal(got[key], again[key])
    s, d, h = got["sources"], got["destinations"], got["hop"]
    assert all(e in edges for e in zip(s.tolist(), d.tolist()))
    deg = g.out_degrees()
    n0 = int(deg[starts.long()].clamp(max=5).sum()) if not with_replacement else \
        5 * int((deg[starts.long()] > 0).sum())
    assert int((h == 0).sum()) == n0
    # hop 1 sources are exactly hop 0 destinations, each expanded once
    hop1_src = s[h == 1]
    assert set(hop1_src.tolist()) <= set(d[h == 0].tolist())
    assert int((h == 1).sum()) <= 3 * int((h == 0).sum())
    per_hop = ct.uniform_neighbor_sample(g, starts, [5, 3], with_replacement=with_replacement,
                                         generator=_gen(3), compress=False)
    assert [tuple(p[1].shape) for p in per_hop] == [(starts.numel(), 5), (starts.numel() * 5, 3)]
    assert torch.equal(per_hop[1][0][per_hop[1][3]], hop1_src)


def _functional_graph(weighted):
    """Every out-degree <= 1: 0->1->2->3->4 (4 a sink), the cycle 5->6->7->5,
    8 and 9 isolated."""
    src = np.array([0, 1, 2, 3, 5, 6, 7], np.int32)
    dst = np.array([1, 2, 3, 4, 6, 7, 5], np.int32)
    w = np.array([0.5, 1.5, 2.0, 0.25, 3.0, 0.75, 1.25], np.float32) if weighted else None
    return (cg.from_edgelist(src, dst, w, num_vertices=10),
            ct.from_edgelist(src, dst, w, num_vertices=10, device="cpu"))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mode", ["uniform", "biased", "node2vec"])
def test_walks_match_jax_where_out_degree_at_most_one(mode, weighted):
    jg, tg = _functional_graph(weighted)
    starts = [0, 2, 4, 5, 8, 3]
    if mode == "node2vec":
        want = cg.node2vec(jg, starts, 6, p=0.5, q=2.0)
        got = ct.node2vec(tg, starts, 6, p=0.5, q=2.0)
    else:
        want = cg.random_walks(jg, starts, 6, biased=mode == "biased")
        got = ct.random_walks(tg, starts, 6, biased=mode == "biased")
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    walks = got[0].numpy()
    assert walks[2].tolist() == [4] + [-1] * 6 and walks[3, 3] == 5
    dead = walks[:, 1:] < 0
    assert (got[1].numpy()[dead] == 0).all()
    assert (np.diff(dead.astype(int), axis=1) >= 0).all()  # -1 stays -1


@pytest.mark.parametrize("mode", ["uniform", "biased", "node2vec"])
def test_walk_steps_are_edges_and_seeded(mode):
    g = _rmat(12, weighted=True)
    adj = g.csr()
    weights = {}  # (u, v) -> the weights of its parallel edges
    for u, v, w in zip(adj.majors.tolist(), adj.minors.tolist(), adj.weights.tolist()):
        weights.setdefault((u, v), set()).add(w)
    starts = torch.arange(0, 4096, 29, dtype=torch.int32)
    if mode == "node2vec":
        run = lambda: ct.node2vec(g, starts, 10, p=1.0, q=0.5, generator=_gen(5))  # noqa: E731
    else:
        run = lambda: ct.random_walks(g, starts, 10, biased=mode == "biased",  # noqa: E731
                                      generator=_gen(5))
    walks, ws = run()
    again = run()
    assert torch.equal(walks, again[0]) and torch.equal(ws, again[1])
    assert walks.shape == (starts.numel(), 11) and ws.shape == (starts.numel(), 10)
    for row, wrow in zip(walks.tolist(), ws.tolist()):
        for t, (a, b) in enumerate(zip(row[:-1], row[1:])):
            if b < 0:
                assert all(x < 0 for x in row[t + 1:]) and all(x == 0 for x in wrow[t:])
                break
            assert wrow[t] in weights[(a, b)]  # an edge, with its weight


@pytest.mark.parametrize("mode", ["biased", "node2vec"])
def test_walks_do_not_depend_on_the_chunking(mode, monkeypatch):
    g = _rmat(10, weighted=True)
    starts = torch.arange(0, 1024, 3, dtype=torch.int32)

    def run():
        if mode == "node2vec":
            return ct.node2vec(g, starts, 8, p=0.5, q=2.0, generator=_gen(9))
        return ct.random_walks(g, starts, 8, biased=True, generator=_gen(9))

    want = run()
    monkeypatch.setattr(twalks, "CANDIDATE_BUDGET", 5)
    got = run()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_node2vec_return_rate_moves_with_p():
    _, tg = _karate()
    starts = torch.arange(34, dtype=torch.int32).repeat(30)

    deg = tg.out_degrees().numpy().astype(float)

    def return_rate(p):
        walks, _ = ct.node2vec(tg, starts, 12, p=p, q=1.0, generator=_gen(2))
        w = walks.numpy()
        # returns, and what a uniform walk would expect: 1 / deg(current)
        return (w[:, 2:] == w[:, :-2]).mean(), (1 / deg[w[:, 1:-1]]).mean()

    (low, _), (mid, uniform), (high, _) = return_rate(0.25), return_rate(1.0), return_rate(4.0)
    assert low > mid > high
    # p = q = 1 is the uniform walk
    assert abs(mid - uniform) < 0.02


def test_biased_walk_follows_the_weights():
    src, dst = np.array([0, 0], np.int32), np.array([1, 2], np.int32)
    g = ct.from_edgelist(src, dst, np.array([100.0, 0.001], np.float32), device="cpu")
    walks, ws = ct.random_walks(g, torch.zeros(500, dtype=torch.int32), 1, biased=True,
                                generator=_gen(0))
    assert (walks[:, 1] == 1).float().mean() > 0.99
    assert torch.equal(ws[:, 0], torch.where(walks[:, 1] == 1, 100.0, 0.001))
