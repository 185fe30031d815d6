"""per_v_random_select_outgoing_e, the neighbor-sampling primitive.

Counterpart of ``cugraph_tpu/prims/random_select.py`` (ref:
cpp/src/prims/per_v_random_select_transform_outgoing_e.cuh). For each
frontier vertex, K outgoing edges drawn uniformly, with or without
replacement, as one (N, K) draw: without replacement by Floyd's algorithm
over the K slots, which gives exact uniform K-subsets for any degree with
no rejection loop. The draws come from a ``torch.Generator`` and follow
the JAX package's rule, not its bits.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.csr import Graph


def per_v_random_select_outgoing_e(
    g: Graph,
    generator: Optional[torch.Generator],
    vertices: torch.Tensor,
    fanout: int,
    *,
    with_replacement: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """Sample up to ``fanout`` outgoing edges per vertex.

    vertices: (N,) ids on the graph's device; entries < 0 are padding.
    generator: a ``torch.Generator`` on the graph's device (None: one
    seeded 0). Returns (srcs, dsts, weights or None, valid), all
    (N, fanout). Without replacement, a vertex of degree <= fanout takes
    all its edges, slot i edge i, and the slots past its degree are
    invalid; padding vertices give invalid slots (srcs 0 there, as in the
    JAX package).
    """
    adj = g.csr()
    dev = adj.offsets.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    vertices = vertices.to(device=dev, dtype=torch.int64).reshape(-1)
    n, k = vertices.numel(), int(fanout)
    v_safe = vertices.clamp(min=0)
    starts = adj.offsets[v_safe].to(torch.int64)
    degs = adj.offsets[v_safe + 1].to(torch.int64) - starts
    v_ok = vertices >= 0
    slot = torch.arange(k, dtype=torch.int64, device=dev)[None, :]

    if with_replacement:
        u = torch.rand(n, k, generator=generator, device=dev)
        sel = torch.minimum((u * degs[:, None].to(u.dtype)).to(torch.int64),
                            (degs[:, None] - 1).clamp(min=0))
        valid = (v_ok & (degs > 0))[:, None].expand(n, k)
    else:
        # Floyd: for slot i, j = d - K + i; t uniform in [0, j]; take t
        # unless an earlier slot took it, else j
        sel = torch.full((n, k), -1, dtype=torch.int64, device=dev)
        for i in range(k):
            jpos = (degs - k + i).clamp(min=0)
            u = torch.rand(n, generator=generator, device=dev)
            t = torch.minimum((u * (jpos + 1).to(u.dtype)).to(torch.int64), jpos)
            dup = (sel[:, :i] == t[:, None]).any(1)
            sel[:, i] = torch.where(dup, jpos, t)
        # degree <= K: take all (slot i -> edge i)
        sel = torch.where(degs[:, None] <= k, slot, sel)
        valid = v_ok[:, None] & (slot < torch.clamp(degs, max=k)[:, None])

    eidx = (starts[:, None] + sel).clamp(0, max(adj.num_edges - 1, 0))
    if adj.num_edges == 0:
        dsts = torch.zeros((n, k), dtype=adj.minors.dtype, device=dev)
        weights = None if adj.weights is None else torch.zeros((n, k), device=dev)
    else:
        dsts = adj.minors[eidx]
        weights = None if adj.weights is None else adj.weights[eidx]
    srcs = v_safe.to(adj.minors.dtype)[:, None].expand(n, k).contiguous()
    return srcs, dsts, weights, valid
