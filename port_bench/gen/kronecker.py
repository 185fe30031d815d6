"""The Graph500 Kronecker generator (GAP's Kron), in plain torch on the
device from the seed.

Each of the ``edge_factor * 2**scale`` tuples draws its ``scale`` bit pairs
in parallel: the source bit is 1 with probability C + D, the destination
bit 1 with probability B / (A + B) after a source bit 0 and D / (C + D)
after a 1 (Graph500's ``kronecker_generator``). Vertex ids are then
scrambled by a random permutation drawn from the same generator, as
Graph500 and GAP permute their labels.
"""

from __future__ import annotations

import torch


def edges(config: dict, seed: int, device: torch.device):
    scale = int(config["scale"])
    n = 1 << scale
    m = int(config["edge_factor"]) * n
    a, b, c = (float(config["params"][k]) for k in ("a", "b", "c"))
    d = 1.0 - a - b - c
    gen = torch.Generator(device=device).manual_seed(seed)
    p_src1 = c + d
    p_dst1 = (b / (a + b), d / (c + d))  # after a source bit 0, after a 1
    src = torch.zeros(m, dtype=torch.int32, device=device)
    dst = torch.zeros_like(src)
    for _ in range(scale):
        sbit = torch.rand(m, generator=gen, device=device) < p_src1
        thresh = torch.where(sbit, p_dst1[1], p_dst1[0])
        dbit = torch.rand(m, generator=gen, device=device) < thresh
        del thresh
        src.mul_(2).add_(sbit)
        dst.mul_(2).add_(dbit)
        del sbit, dbit
    perm = torch.randperm(n, generator=gen, device=device, dtype=torch.int32)
    return perm.index_select(0, src), perm.index_select(0, dst)
