"""Link analysis: PageRank (and personalized PageRank) and HITS.

Counterpart of ``cugraph_tpu/algos/link_analysis.py`` (``pagerank``,
``_pagerank_jit``, ``hits``, ``_hits_jit``; ref:
cpp/src/link_analysis/pagerank_impl.cuh power iteration :209-295, dangling
handling :218, convergence :287, and hits_impl.cuh). Each PageRank
iteration is one ``pull_aggregate``, and each HITS iteration one
``pull_aggregate`` and one ``push_aggregate``: the ``spmv_sum`` kernel over
the CSC and the CSR on the card. The convergence test reads the L1 diff on
the host once per iteration. ``pagerank`` marks its call, each iteration
and each blocking read with spans (``utils/timer.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.csr import Graph
from ..prims.cuda import pull_aggregate, push_aggregate
from ..utils.device import as_tensor
from ..utils.dtypes import WEIGHT_DTYPE
from ..utils.error import expects, expects_vertex_ids
from ..utils.timer import span, spanned


@spanned("cgt/algorithms.pagerank")
def pagerank(
    g: Graph,
    alpha: float = 0.85,
    personalization: Optional[Tuple[object, object]] = None,
    max_iterations: int = 100,
    tol: float = 1.0e-6,
    nstart=None,
    fail_on_nonconvergence: bool = False,
) -> Tuple[torch.Tensor, int]:
    """PageRank scores (sum to 1) on the graph's device. Returns
    (scores (V,) float32, iterations).

    personalization: (vertex_ids, values) restricting the reset vector.
    The loop runs while ``diff > V * tol`` and ``it < max_iterations``,
    with diff the L1 change of one iteration (NetworkX/cuGraph semantics).
    """
    v = g.num_vertices
    expects(v > 0, "empty graph")
    dev = g.device
    if personalization is not None:
        ids = as_tensor(personalization[0], torch.int64, dev).reshape(-1)
        with span("cgt/sync.pagerank.personalization"):
            expects_vertex_ids(ids, v, "personalization")
        reset = torch.zeros(v, dtype=WEIGHT_DTYPE, device=dev).index_add_(
            0, ids, as_tensor(personalization[1], WEIGHT_DTYPE, dev).reshape(-1)
        )
        total = reset.sum()
        reset = reset / torch.where(total > 0, total, 1.0)
    else:
        reset = torch.full((v,), 1.0 / v, dtype=WEIGHT_DTYPE, device=dev)
    if nstart is not None:
        pr = as_tensor(nstart, WEIGHT_DTYPE, dev)
        pr = pr / pr.sum()
    else:
        pr = torch.full((v,), 1.0 / v, dtype=WEIGHT_DTYPE, device=dev)
    out_wsum = g.out_weight_sums()
    dangling = out_wsum <= 0
    inv_out = torch.where(dangling, 0.0, 1.0 / torch.where(dangling, 1.0, out_wsum))

    diff, it = float("inf"), 0
    while diff > v * tol and it < max_iterations:
        with span("cgt/step.pagerank.iteration"):
            agg = pull_aggregate(g, pr * inv_out)
            # dangling mass is redistributed by the reset vector (ref :218)
            dangling_sum = torch.where(dangling, pr, 0.0).sum()
            new = alpha * (agg + dangling_sum * reset) + (1.0 - alpha) * reset
            l1 = (new - pr).abs().sum()  # ref :278 L1 diff
            with span("cgt/sync.pagerank.diff"):
                diff = float(l1)
            pr, it = new, it + 1
    if fail_on_nonconvergence:
        expects(diff <= v * tol, "PageRank failed to converge")
    return pr, it


def hits(
    g: Graph,
    max_iterations: int = 100,
    tol: float = 1.0e-5,
    nstart=None,
    normalized: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """HITS hubs and authorities on the graph's device. Returns (hubs,
    authorities, iterations).

    Each iteration pulls authorities from hubs over the in-edges and pushes
    hubs back from authorities over the out-edges, each step divided by its
    max (floored at 1e-30); the loop runs while the L1 change of the hubs
    exceeds ``tol``. normalized: both vectors are divided by their sums.
    """
    v = g.num_vertices
    dev = g.device
    if nstart is not None:
        h = as_tensor(nstart, WEIGHT_DTYPE, dev)
    else:
        h = torch.full((v,), 1.0 / v, dtype=WEIGHT_DTYPE, device=dev)
    a = torch.zeros(v, dtype=WEIGHT_DTYPE, device=dev)
    diff, it = float("inf"), 0
    while diff > tol and it < max_iterations:
        # ref hits_impl.cuh: authority = A^T hub, hub = A authority
        a = pull_aggregate(g, h)
        a = a / a.max().clamp(min=1e-30)
        h_new = push_aggregate(g, a)
        h_new = h_new / h_new.max().clamp(min=1e-30)
        diff = float((h_new - h).abs().sum())
        h, it = h_new, it + 1
    if normalized:
        h = h / h.sum().clamp(min=1e-30)
        a = a / a.sum().clamp(min=1e-30)
    return h, a, it
