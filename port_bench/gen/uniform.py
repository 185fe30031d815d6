"""GAP's Urand: ``edge_factor * 2**scale`` tuples whose two ends are drawn
uniformly from the ``2**scale`` vertices, in plain torch on the device from
the seed."""

from __future__ import annotations

import torch


def edges(config: dict, seed: int, device: torch.device):
    n = 1 << int(config["scale"])
    m = int(config["edge_factor"]) * n
    gen = torch.Generator(device=device).manual_seed(seed)
    src = torch.randint(0, n, (m,), generator=gen, device=device, dtype=torch.int32)
    dst = torch.randint(0, n, (m,), generator=gen, device=device, dtype=torch.int32)
    return src, dst
