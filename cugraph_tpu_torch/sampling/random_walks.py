"""Random walks: uniform, biased by edge weight, and node2vec.

Counterpart of ``cugraph_tpu/sampling/random_walks.py`` (ref:
cpp/src/sampling/random_walks.cuh, the legacy implementation with
node2vec's p/q at :274-280). Every walker takes its step at once; a
walker that reaches a sink, or a row whose weights total zero, stops, and
its walk is padded with -1 (its edge weights with 0).

Uniform walks draw one index into the current row. Biased and node2vec
steps take an inverse CDF over each walker's row, weighted by the edge
weights (node2vec: times 1/p back to the previous vertex, 1 to a
neighbour of it, 1/q elsewhere), with one uniform draw per walker. The
JAX package builds a (walkers, max_degree) tile for it; at RMAT scale 21
the largest out-degree would make that tile tens of GB. Here each walker
expands only its own row, ``CANDIDATE_BUDGET`` slots at a time
(``ragged_chunks``), and the CDF is a float64 prefix sum over the chunk,
cut at each walker's first slot.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.csr import Graph
from ..prims.intersection import edge_keys, edge_multiplicity, ragged_chunks
from ..utils.device import as_tensor
from ..utils.dtypes import VERTEX_DTYPE, WEIGHT_DTYPE

CANDIDATE_BUDGET = 1 << 24  # row slots expanded at once


def _starts(g: Graph, start_vertices) -> torch.Tensor:
    return as_tensor(start_vertices, VERTEX_DTYPE, g.device).reshape(-1)


def _generator(g: Graph, generator: Optional[torch.Generator]) -> torch.Generator:
    return torch.Generator(device=g.device).manual_seed(0) if generator is None else generator


def _uniform_step(g: Graph, cur: torch.Tensor, generator: torch.Generator):
    adj = g.csr()
    safe = cur.to(torch.int64).clamp(min=0)
    lo = adj.offsets[safe].to(torch.int64)
    deg = adj.offsets[safe + 1].to(torch.int64) - lo
    u = torch.rand(cur.shape, generator=generator, device=cur.device)
    pick = torch.minimum((u * deg.to(u.dtype)).to(torch.int64), deg - 1)
    alive = (cur >= 0) & (deg > 0)
    if adj.num_edges == 0:
        return torch.full_like(cur, -1), torch.zeros(cur.shape, dtype=WEIGHT_DTYPE, device=cur.device)
    eidx = (lo + pick).clamp(0, adj.num_edges - 1)
    nxt = torch.where(alive, adj.minors[eidx], -1)
    w = adj.weights[eidx] if adj.weights is not None else torch.ones(cur.shape, dtype=WEIGHT_DTYPE,
                                                                       device=cur.device)
    return nxt, torch.where(alive, w, 0.0)


def _weighted_step(g, cur, prev, generator, factors, biased, keys):
    """One biased or node2vec step: (next vertex or -1, edge weight or 0).
    factors: node2vec's (1/p, 1/q), or None."""
    adj = g.csr()
    dev = cur.device
    offsets = adj.offsets.to(torch.int64)
    safe = cur.to(torch.int64).clamp(min=0)
    lo, deg = offsets[safe], offsets[safe + 1] - offsets[safe]
    counts = torch.where(cur >= 0, deg, 0)
    u = torch.rand(cur.shape, generator=generator, device=dev)  # one draw a walker
    nxt = torch.full_like(cur, -1)
    ew = torch.zeros(cur.shape, dtype=WEIGHT_DTYPE, device=dev)
    for i0, i1, owner, rank in ragged_chunks(counts, CANDIDATE_BUDGET):
        eidx = lo[owner] + rank
        cand = adj.minors[eidx]
        if biased and adj.weights is not None:
            w = adj.weights[eidx]
        else:
            w = torch.ones(eidx.shape, dtype=WEIGHT_DTYPE, device=dev)
        if factors is not None:
            # node2vec factors (ref random_walks.cuh:274-280): back to prev
            # 1/p, a neighbour of prev 1, elsewhere 1/q; none on the first step
            pv = prev[owner].to(torch.int64)
            is_nbr = edge_multiplicity(keys, adj.num_minors, pv.clamp(min=0), cand) > 0
            factor = torch.where(cand == pv, factors[0], torch.where(is_nbr, 1.0, factors[1]))
            w = w * torch.where(pv >= 0, factor, 1.0).to(WEIGHT_DTYPE)
        # each walker's CDF over its row: a float64 prefix over the chunk,
        # less the prefix before the walker's first slot
        csum = torch.cumsum(w.to(torch.float64), 0)
        n_w = i1 - i0
        first = torch.zeros(n_w, dtype=torch.int64, device=dev)
        first[1:] = torch.cumsum(counts[i0:i1], 0)[:-1]
        last = first + counts[i0:i1] - 1
        has = counts[i0:i1] > 0
        first_c, last_c = first.clamp(max=csum.numel() - 1), last.clamp(min=0)
        base = torch.where(first > 0, csum[(first - 1).clamp(min=0)], 0.0)
        total = torch.where(has, csum[last_c] - base, 0.0)
        target = base + u[i0:i1].to(torch.float64) * total
        pick = torch.searchsorted(csum, target).clamp(min=first_c, max=last_c)
        alive = has & (total > 0)
        eid = eidx[pick]
        nxt[i0:i1] = torch.where(alive, cand[pick], -1)
        if adj.weights is not None:
            ew[i0:i1] = torch.where(alive, adj.weights[eid], 0.0)
        else:
            ew[i0:i1] = alive.to(WEIGHT_DTYPE)
    return nxt, ew


def _walk(g, starts, generator, max_depth, p, q, biased):
    """(walks (N, max_depth + 1), weights (N, max_depth)) of one walk per
    start."""
    factors = keys = None
    if p is not None:
        # 1/p and 1/q in float32, as the JAX package divides them
        one = torch.tensor(1.0, dtype=WEIGHT_DTYPE)
        factors = (float(one / torch.tensor(p, dtype=WEIGHT_DTYPE)),
                   float(one / torch.tensor(q, dtype=WEIGHT_DTYPE)))
        keys = edge_keys(g.csr())
    cur, prev = starts, torch.full_like(starts, -1)
    steps, ws = [starts], []
    for _ in range(int(max_depth)):
        if p is None and not biased:
            nxt, w = _uniform_step(g, cur, generator)
        else:
            nxt, w = _weighted_step(g, cur, prev, generator, factors, biased, keys)
        steps.append(nxt)
        ws.append(w)
        cur, prev = nxt, cur
    walks = torch.stack(steps, 1)
    weights = torch.stack(ws, 1) if ws else torch.zeros((starts.numel(), 0), dtype=WEIGHT_DTYPE,
                                                        device=starts.device)
    return walks, weights


def random_walks(
    g: Graph,
    start_vertices,
    max_depth: int,
    *,
    use_padding: bool = True,
    generator: Optional[torch.Generator] = None,
    biased: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Uniform (or, with ``biased``, edge-weight-biased) random walks.

    Returns (walks (N, max_depth + 1) int32 padded with -1 after a sink,
    edge weights (N, max_depth), 0 after a sink; 1 a step on an unweighted
    graph). generator: a ``torch.Generator`` on the graph's device (None:
    one seeded 0). ``use_padding`` is the JAX signature's; walks are
    always padded. ref: cugraph.random_walks."""
    return _walk(g, _starts(g, start_vertices), _generator(g, generator), max_depth,
                 None, None, biased)


def node2vec(
    g: Graph,
    start_vertices,
    max_depth: int,
    p: float = 1.0,
    q: float = 1.0,
    *,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """node2vec second-order walks, biased by edge weight, with return
    parameter p and in-out parameter q. Returns as ``random_walks``.
    ref: sampling/random_walks.cuh node2vec_selector, python
    cugraph/sampling/node2vec.py."""
    return _walk(g, _starts(g, start_vertices), _generator(g, generator), max_depth,
                 float(p), float(q), True)
