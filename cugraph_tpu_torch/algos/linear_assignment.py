"""Hungarian linear assignment.

Counterpart of ``cugraph_tpu/algos/linear_assignment.py`` (ref:
cpp/src/linear_assignment/hungarian.cu, Date/Nagi via raft::lap). It runs
on the host by design, as in the JAX package: the (workers, tasks) cost
matrix is filled in numpy exactly as there, then
``scipy.optimize.linear_sum_assignment`` solves it. The dense matrix is
inherent to the formulation: len(workers) x len(tasks) host memory.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..core.convert import decompress_to_edgelist
from ..core.csr import Graph
from ..utils.dtypes import VERTEX_DTYPE
from ..utils.error import expects

# the cost of a (worker, task) pair with no edge
NO_EDGE_COST = 1e9


def hungarian(g: Graph, workers) -> Tuple[float, torch.Tensor]:
    """Optimal assignment of ``workers`` (a vertex subset) to the other
    vertices that are edge destinations (the tasks), minimizing the total
    edge weight. Returns (cost, assignment): assignment[i] is the task
    vertex of workers[i], an int32 tensor on the graph's device. Where a
    (worker, task) pair has parallel edges, the last one in CSR order sets
    the cost, as in the JAX package."""
    import scipy.optimize as spo

    expects(g.weighted, "hungarian requires edge weights")
    if isinstance(workers, torch.Tensor):
        workers = workers.cpu().numpy()
    workers = np.asarray(workers, dtype=np.int32)
    src, dst, w = (a.cpu().numpy() for a in decompress_to_edgelist(g))
    tasks = np.setdiff1d(np.unique(dst), workers)
    cost = np.full((len(workers), len(tasks)), NO_EDGE_COST)
    ws = np.sort(workers)
    ts = np.sort(tasks)
    wi = np.searchsorted(ws, np.clip(src, ws.min(initial=0), ws.max(initial=0)))
    ti = np.searchsorted(ts, np.clip(dst, ts.min(initial=0), ts.max(initial=0)))
    wi = np.minimum(wi, len(ws) - 1)
    ti = np.minimum(ti, len(ts) - 1)
    ok = (ws[wi] == src) & (ts[ti] == dst)
    w_order = np.argsort(np.argsort(workers))  # sorted position -> original
    t_order = np.argsort(np.argsort(tasks))
    cost[w_order[wi[ok]], t_order[ti[ok]]] = w[ok]
    rows, cols = spo.linear_sum_assignment(cost)
    total = float(cost[rows, cols].sum())
    assignment = torch.from_numpy(tasks[cols].astype(np.int32))
    return total, assignment.to(g.device, VERTEX_DTYPE)
