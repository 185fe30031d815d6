"""GAP's Urand: ``edge_factor * 2**scale`` tuples whose two ends are drawn
uniformly from the ``2**scale`` vertices, in plain torch on the device from
the seed; ``edge_chunks`` draws each chunk from a generator of its own
seed."""

from __future__ import annotations

import torch

from . import chunk_seed, chunk_sizes


def edges(config: dict, seed: int, device: torch.device):
    n = 1 << int(config["scale"])
    m = int(config["edge_factor"]) * n
    gen = torch.Generator(device=device).manual_seed(seed)
    src = torch.randint(0, n, (m,), generator=gen, device=device, dtype=torch.int32)
    dst = torch.randint(0, n, (m,), generator=gen, device=device, dtype=torch.int32)
    return src, dst


def edge_chunks(config: dict, seed: int, device: torch.device):
    n = 1 << int(config["scale"])
    gen = torch.Generator(device=device)
    for k, m in enumerate(chunk_sizes(int(config["edge_factor"]) * n)):
        gen.manual_seed(chunk_seed(seed, k))
        src = torch.randint(0, n, (m,), generator=gen, device=device, dtype=torch.int32)
        dst = torch.randint(0, n, (m,), generator=gen, device=device, dtype=torch.int32)
        yield src, dst
