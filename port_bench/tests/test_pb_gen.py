"""The generators: the same seed gives the same tuples, another seed other
ones, and Kron is skewed where Urand is not."""

import json

import pytest
import torch
from pb_helpers import BENCH, SEED

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
