"""PageRank by hand, in float64, and the comparison that judges the port's
scores.

The iteration is the one ``pagerank(g, alpha, max_iterations, tol=0.0)``
promises: pr' = alpha * (A^T (pr / deg) + (dangling mass) / V) +
(1 - alpha) / V from pr = 1 / V, with deg the stored out-degree and a
vertex of degree 0 dangling, for exactly ``max_iterations`` steps.
"""

from __future__ import annotations

import torch

from .graph import CHUNK, RefGraph


def scores(ref: RefGraph, alpha: float, iterations: int, store=None) -> torch.Tensor:
    """The scores after ``iterations`` steps, in float64; with ``store``
    (the control), the vertex vectors are held in that dtype between steps
    and the sums are taken in float32."""
    v = ref.num_vertices
    acc = torch.float64 if store is None else torch.float32
    keep = (lambda x: x) if store is None else (lambda x: x.to(store).to(acc))
    deg = ref.degrees().to(acc)
    dangling = deg == 0
    inv = torch.where(dangling, 0.0, 1.0 / torch.where(dangling, 1.0, deg))
    pr = keep(torch.full((v,), 1.0 / v, dtype=acc, device=deg.device))
    for _ in range(iterations):
        msg = keep(pr * inv)
        agg = torch.zeros_like(pr)
        for i in range(0, ref.num_edges, CHUNK):
            agg.index_add_(0, ref.dst[i:i + CHUNK], msg.index_select(0, ref.src[i:i + CHUNK]))
        lost = pr[dangling].sum()
        pr = keep(alpha * (agg + lost / v) + (1.0 - alpha) / v)
    return pr


def check(ref: RefGraph, samples, notes, params: dict, limits: dict) -> dict:
    """{name: (reading, limit)}: the largest relative error of a sampled
    query's score against the float64 scores, over every vertex; and the
    count of queries that did not run exactly ``max_iterations`` steps."""
    want = scores(ref, params["alpha"], params["max_iterations"])
    err = 0.0
    for _, got in samples:
        err = max(err, float(((got.double() - want).abs() / want).max()))
    off = sum(it != params["max_iterations"] for it in notes)
    return {
        "pagerank_rel_err": (err, limits["pagerank_rel_err"]),
        "pagerank_iterations_off": (off, limits["pagerank_iterations_off"]),
    }


def control(ref: RefGraph, args, params: dict):
    """The control in the program's place: (result, note) for each query,
    the scores held in bfloat16 (the step below the float32 the port
    states)."""
    pr = scores(ref, params["alpha"], params["max_iterations"], store=torch.bfloat16)
    return [(pr, params["max_iterations"]) for _ in args]
