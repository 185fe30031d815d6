"""Edge weights, one a generated tuple, drawn on the device from the seed as
a configuration's ``weights`` names them:

- ``{"distribution": "uniform_int", "low": 1, "high": 255, "dtype":
  "float32"}``: whole numbers uniform in [low, high], held in ``dtype``
  (GAP's weights for its synthetic graphs: uniform in [1, 255]).

A configuration without ``weights`` has none (``draw`` returns None).
"""

from __future__ import annotations

import torch

DISTRIBUTIONS = ("uniform_int",)


def draw(config: dict, count: int, seed: int, device: torch.device):
    """``count`` weights of ``config``'s ``weights`` from ``seed``, on
    ``device``; None where the configuration names no weights."""
    spec = config.get("weights")
    if spec is None:
        return None
    kind = spec["distribution"]
    if kind not in DISTRIBUTIONS:
        raise ValueError(f"unknown weight distribution {kind!r}; known: {DISTRIBUTIONS}")
    dtype = getattr(torch, spec["dtype"])
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(int(spec["low"]), int(spec["high"]) + 1, (count,), generator=gen,
                         device=device, dtype=dtype)
