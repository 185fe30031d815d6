"""The generators: the same seed gives the same tuples, another seed other
ones, and Kron is skewed where Urand is not; the same of the chunked
draws of a cell across cards."""

import hashlib
import json

import pytest
import torch
from pb_helpers import BENCH, SEED

import port_bench.gen
from port_bench.gen import kronecker, uniform


def config(name, scale=12):
    c = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    c["scale"] = scale
    return c


@pytest.mark.parametrize("gen,name", [(kronecker, "gap-kron-s24"), (uniform, "gap-urand-s24")])
def test_same_seed_same_edges(gen, name):
    c = config(name)
    cpu = torch.device("cpu")
    s1, d1 = gen.edges(c, SEED, cpu)
    s2, d2 = gen.edges(c, SEED, cpu)
    s3, _ = gen.edges(c, SEED + 1, cpu)
    assert torch.equal(s1, s2) and torch.equal(d1, d2)
    assert not torch.equal(s1, s3)
    n = 1 << c["scale"]
    assert s1.numel() == c["edge_factor"] * n and s1.dtype == torch.int32
    assert int(torch.minimum(s1, d1).min()) >= 0 and int(torch.maximum(s1, d1).max()) < n


def test_kron_skewed_urand_flat():
    cpu = torch.device("cpu")
    degs = {}
    for gen, name in ((kronecker, "gap-kron-s24"), (uniform, "gap-urand-s24")):
        c = config(name, scale=14)
        s, d = gen.edges(c, SEED, cpu)
        deg = torch.bincount(torch.cat([s, d]).long(), minlength=1 << 14).double()
        degs[name] = deg
    kron, urand = degs["gap-kron-s24"], degs["gap-urand-s24"]
    # Kron: hubs of thousands and many vertices without a tuple; Urand: Poisson(32)
    assert kron.max() > 20 * kron.mean() and (kron == 0).double().mean() > 0.2
    assert urand.max() < 3 * urand.mean() and (urand == 0).sum() == 0
    # Kron's ids are scrambled: the hubs are not the low ids
    top = torch.topk(kron, 16).indices
    assert int(top.min()) > 16


# sha256 of edges()' (src, dst) bytes at scale 10 on the CPU for SEED: the
# tuples that the cells on one card have drawn since the benchmark began
EDGES_SHA256 = {
    "gap-kron-s24": "7a0fd47b2e5eae9fe36272c7053f37bf75534796fb617e6c102bf68a3cc73357",
    "gap-urand-s24": "cce966e38f376c65a44c308b68e2c8a637f6dcceead475e36d1d5bec3967b5e6",
}


@pytest.mark.parametrize("gen,name", [(kronecker, "gap-kron-s24"), (uniform, "gap-urand-s24")])
def test_edges_are_the_same_tuples(gen, name):
    s, d = gen.edges(config(name, scale=10), SEED, torch.device("cpu"))
    digest = hashlib.sha256(s.numpy().tobytes() + d.numpy().tobytes()).hexdigest()
    assert digest == EDGES_SHA256[name]


@pytest.mark.parametrize("gen,name", [(kronecker, "gap-kron-s24"), (uniform, "gap-urand-s24")])
def test_edge_chunks(monkeypatch, gen, name):
    """The same seed gives the same chunks, another seed other ones; every
    chunk but the last holds CHUNK_TUPLES tuples, all of them in range."""
    monkeypatch.setattr(port_bench.gen, "CHUNK_TUPLES", 3000)
    c = config(name)
    cpu = torch.device("cpu")
    first = list(gen.edge_chunks(c, SEED, cpu))
    again = list(gen.edge_chunks(c, SEED, cpu))
    other = list(gen.edge_chunks(c, SEED + 1, cpu))
    n = 1 << c["scale"]
    assert [s.numel() for s, _ in first] == [3000] * 21 + [c["edge_factor"] * n - 63000]
    assert all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) for a, b in zip(first, again))
    assert not torch.equal(first[0][0], other[0][0])
    assert not torch.equal(first[0][0], first[1][0])  # each chunk draws its own tuples
    s, d = torch.cat([s for s, _ in first]), torch.cat([d for _, d in first])
    assert s.dtype == torch.int32 and int(torch.minimum(s, d).min()) >= 0
    assert int(torch.maximum(s, d).max()) < n
    deg = torch.bincount(torch.cat([s, d]).long(), minlength=n).double()
    if gen is kronecker:  # skewed as edges() is, and scrambled by one permutation
        assert deg.max() > 20 * deg.mean() and int(torch.topk(deg, 16).indices.min()) > 16
    else:
        assert deg.max() < 3 * deg.mean()


# sha256 of the harness's tuples at scale 10 for SEED (its "edges" stream)
# and of the port's stored graph of them (offsets, minors, majors), taken
# before configurations could name weights: an unweighted configuration
# draws and stores the same graph since
STORED_SHA256 = {
    "gap-kron-s24": "6ec0eaf8f0fe6a27b73068dd5ea1ace1470bbf2d5599aef47ed8abbee1590ed3",
    "gap-urand-s24": "82f27a0af7c4a6a9b79770e1b82f2e3f5d25754fbe61bf5949c36d42317e53ba",
}


@pytest.mark.parametrize("gen,name", [(kronecker, "gap-kron-s24"), (uniform, "gap-urand-s24")])
def test_unweighted_stored_graph_unchanged(gen, name):
    import cugraph_tpu_torch as port
    from port_bench import harness

    src, dst, weight = harness.cell_edges(gen, config(name, scale=10), SEED, torch.device("cpu"))
    assert weight is None
    g = port.from_edgelist(src, dst, weight, num_vertices=1 << 10, symmetrize=True,
                           device="cpu")
    adj = g.csr()
    assert adj.weights is None
    h = hashlib.sha256()
    for t in (src, dst, adj.offsets, adj.minors, adj.majors):
        h.update(t.numpy().tobytes())
    assert h.hexdigest() == STORED_SHA256[name]


def test_weights_drawn_beside_the_same_tuples():
    """A weighted configuration draws its unweighted twin's tuples, and one
    whole weight in [low, high] a tuple, the same for the same seed."""
    from port_bench import harness

    cpu = torch.device("cpu")
    plain = harness.cell_edges(kronecker, config("gap-kron-s24", scale=10), SEED, cpu)
    w1 = harness.cell_edges(kronecker, config("gap-kron-s24w", scale=10), SEED, cpu)
    w2 = harness.cell_edges(kronecker, config("gap-kron-s24w", scale=10), SEED, cpu)
    other = harness.cell_edges(kronecker, config("gap-kron-s24w", scale=10), SEED + 1, cpu)
    assert torch.equal(plain[0], w1[0]) and torch.equal(plain[1], w1[1])
    w = w1[2]
    assert w.dtype == torch.float32 and w.numel() == plain[0].numel()
    assert torch.equal(w, w2[2]) and not torch.equal(w, other[2])
    assert torch.equal(w, w.round()) and int(w.min()) == 1 and int(w.max()) == 255
    counts = torch.bincount(w.long(), minlength=256)[1:].double()
    assert counts.min() > 0.5 * counts.mean()  # uniform over [1, 255]
