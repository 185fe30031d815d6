"""spmv_sum and spmv_minplus: SpMV kernels (csrc/spmv.cu) and their plain
versions.

    spmv_sum(adj, x)     y[d] = sum over edges s->d of w * x[s]
    spmv_minplus(adj, x) y[d] = min over edges s->d of x[s] + w, +inf if none

``adj`` is a CSC (``Graph.csc()``), or a CSR for the push direction, where
the roles of s and d swap; w is the edge weight when
``use_weights`` and the graph is weighted, else 1 (sum) or 0 (min). A CUDA
tensor launches the kernel (and counts the launch in ``launches``); a CPU
tensor takes the plain version. There is no fallback from one to the other.
Either way the call is a ``cgt/kernel.<name>`` span (``utils/timer.py``).

Both sweep the adjacency by one plan (``_partition.py``), which
``plan_for`` builds at the first call of either and keeps on the
adjacency, so the other finds it there. The plan cuts the adjacency into
merge-path tiles of ``SUM_THREADS * SUM_ITEMS_PER_THREAD`` rows and
edges, one block each, and, where x (4 bytes a minor) outgrows a share of
the card's L2, into K column ranges of the minors, each with its own
offsets and tiles; a later range in which few rows have an edge is
hypersparse, and its sweep walks only those rows. One kernel body,
templated on the reduction, runs a tile kernel and a fix-up a range, in
range order (``sweep``): the first range (dense) writes y, each later one
combines into it, so a row with no edge in any range reads 0 (sum) or
+inf (min). ``launches`` counts calls; the plan says what a call runs.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...core.csr import CompressedAdj
from ...utils.timer import spanned
from . import build
from ._launch import check_operands, on_device, ptr, raise_on_error, stream_of
from ._partition import SweepPlan, plan_for


def _weights(adj: CompressedAdj, use_weights: bool) -> Optional[torch.Tensor]:
    return adj.weights if use_weights else None


def spmv_sum_reference(
    adj: CompressedAdj, x: torch.Tensor, *, use_weights: bool = True
) -> torch.Tensor:
    """Plain version of spmv_sum, in x's dtype, on any device."""
    vals = x.index_select(0, adj.minors)
    w = _weights(adj, use_weights)
    if w is not None:
        vals = vals * w.to(x.dtype)
    y = torch.zeros(adj.num_majors, dtype=x.dtype, device=x.device)
    return y.index_add_(0, adj.majors, vals)


def spmv_minplus_reference(
    adj: CompressedAdj, x: torch.Tensor, *, use_weights: bool = True
) -> torch.Tensor:
    """Plain version of spmv_minplus, in x's dtype, on any device."""
    w = _weights(adj, use_weights)
    vals = x.index_select(0, adj.minors) + (0.0 if w is None else w.to(x.dtype))
    y = torch.full((adj.num_majors,), float("inf"), dtype=x.dtype, device=x.device)
    return y.scatter_reduce_(0, adj.majors.to(torch.int64), vals, "amin")


def _check(kernel: str, adj: CompressedAdj, x: torch.Tensor, use_weights: bool) -> None:
    check_operands(kernel, adj, x, _weights(adj, use_weights))
    if x.dim() != 1:
        raise ValueError(f"{kernel}: x must be 1-D, got shape {tuple(x.shape)}")


def sweep(kernel: str, plan: SweepPlan, x: torch.Tensor, use_weights: bool) -> torch.Tensor:
    """Launch ``cgt_<kernel>`` once a range of ``plan``, in range order,
    and return y; y and the (n_tiles, 2) carries, shared by the ranges,
    are views of one allocation. The caller has checked the operands."""
    v = plan.ranges[0].num_rows  # the first range is dense: every major
    buf = torch.empty(v + 2 * plan.n_tiles, dtype=torch.float32, device=x.device)
    y = buf[:v]
    fn = getattr(build.load("spmv"), f"cgt_{kernel}")
    with on_device(x.device):
        for k, r in enumerate(plan.ranges):
            rc = fn(
                ptr(r.offsets), ptr(r.row_ids), ptr(r.minors), ptr(r.weights if use_weights else None),
                ptr(x), ptr(r.tile_row), ptr(r.tile_edge), buf.data_ptr() + 4 * v, ptr(y),
                r.tile_row.numel() - 1, plan.items_per_thread, k > 0, stream_of(x.device),
            )
            raise_on_error(kernel, rc)
    return y


@spanned("cgt/kernel.spmv_sum")
def spmv_sum(
    adj: CompressedAdj, x: torch.Tensor, *, use_weights: bool = True
) -> torch.Tensor:
    """y[d] = sum over in-edges s->d of w * x[s], f32. Carries the TPU's
    keyed reduce (``spmv3.py:862``) and, weighted, the v1 windowed pull
    SpMV (``spmv.py:194``, ``pull_spmv`` 224 / 260)."""
    if x.device.type == "cpu":
        return spmv_sum_reference(adj, x, use_weights=use_weights)
    _check("spmv_sum", adj, x, use_weights)
    y = sweep("spmv_sum", plan_for(adj), x, use_weights)
    spmv_sum.launches += 1
    return y


@spanned("cgt/kernel.spmv_minplus")
def spmv_minplus(
    adj: CompressedAdj, x: torch.Tensor, *, use_weights: bool = True
) -> torch.Tensor:
    """y[d] = min over in-edges s->d of x[s] + w (+inf if none), f32, exact.
    Carries the TPU's sorted min reduce (``spmv2.py:1675``) and keyed min
    (``spmv3.py:944``)."""
    if x.device.type == "cpu":
        return spmv_minplus_reference(adj, x, use_weights=use_weights)
    _check("spmv_minplus", adj, x, use_weights)
    y = sweep("spmv_minplus", plan_for(adj), x, use_weights)
    spmv_minplus.launches += 1
    return y


spmv_sum.launches = 0
spmv_minplus.launches = 0
