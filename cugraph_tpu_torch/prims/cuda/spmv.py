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

Both cut the adjacency into merge-path tiles of
``SUM_THREADS * SUM_ITEMS_PER_THREAD`` rows and edges, one block each
(``_partition.py``), and run one kernel body templated on the reduction;
the plan is computed on the card at the first call of either and kept on
the adjacency, so the other finds it there.

Where x (4 bytes a minor) outgrows a share of the card's L2, the sweep
goes one column segment at a time (``segment_count``): K ranges of the
minors, each with its own CSC and plan, built at the first call and kept
on the adjacency. The first range writes y, each later one combines into
it, in range order; ``segment_passes`` counts the ranges swept, while
``launches`` still counts one a call. With K = 1 the call is the
unsegmented sweep. A later range in which few rows have an edge is
hypersparse (``SEGMENT_HYPERSPARSE_SHARE``): its sweep walks only those
rows; the first range stays dense and writes every row, so a row with no
edge in any range reads 0 (sum) or +inf (min). ``hypersparse_passes``
counts the hypersparse ranges swept.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from ...core.csr import CompressedAdj
from ...utils.timer import spanned
from . import build
from ._launch import check_operands, on_device, ptr, raise_on_error, stream_of
from ._partition import segments_for, tiles_for

SUM_THREADS = 256  # threads a block of the spmv kernels (csrc/spmv.cu)
# odd, so the threads' shared-memory runs fall in distinct banks; the
# fastest of 3-15 at RMAT scale 21 on an H100 (PERF.md §6)
SUM_ITEMS_PER_THREAD = 7
# The share of the L2 one range's slice of x may fill: 21.5 MiB of an
# H100's 50, the largest slice measured to stay there. At 2^24 minors that
# gives K = 3, the fastest of K = 1-16 on both of the benchmark's scale-24
# graphs (Urand 4.65 ms a sweep against 11.19 at K = 1, 6.10 at K = 2 (32
# MiB slices), 4.96 at K = 4; PERF.md §6)
SEGMENT_L2_SHARE = 0.43
# Segments only where the edges outnumber the majors this many times: each
# range sweeps every major's row again. At 2^24 minors K = 3 beats K = 1
# at degree 3 (0.913 against 1.166 ms); at degree 2 K = 2 and K = 4 bracket
# K = 1 (0.737 and 0.890 against 0.803)
SEGMENT_MIN_DEGREE = 3
# A column segment after the first sweeps only its rows with an edge
# (hypersparse) where fewer than this share of the rows have one. Against
# the dense range at K = 3 on 2^24 Urand rows, a range's sweep is 14.7%
# faster at a share of 0.28, 2.3% at 0.74, and 0.6% slower at 0.86 (0.3%
# at 0.93, 1.0% at GAP's Urand): the crossover is near 0.83 (PERF.md §6)
SEGMENT_HYPERSPARSE_SHARE = 0.8


def segment_count(num_minors: int, num_edges: int, num_majors: int, l2_bytes: int) -> int:
    """K, the column segments of an SpMV sweep: 1 while x (4 bytes a
    minor) fits ``SEGMENT_L2_SHARE`` of an L2 of ``l2_bytes`` or the
    adjacency is too sparse to pay for K passes over its rows, else
    ceil(x bytes / that budget)."""
    budget = int(l2_bytes * SEGMENT_L2_SHARE)
    x_bytes = 4 * num_minors
    if x_bytes <= budget or num_edges < SEGMENT_MIN_DEGREE * num_majors:
        return 1
    return -(-x_bytes // budget)


@functools.lru_cache(maxsize=None)
def _l2_bytes(index: int) -> int:
    return torch.cuda.get_device_properties(index).L2_cache_size


def segment_width(adj: CompressedAdj, device: torch.device) -> int:
    """The minors a column segment covers on ``device``: all of them where
    ``segment_count`` gives 1."""
    k = segment_count(adj.num_minors, adj.num_edges, adj.num_majors, _l2_bytes(device.index))
    return -(-adj.num_minors // k)


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


def _launch(
    kernel: str, adj: CompressedAdj, x: torch.Tensor, use_weights: bool
) -> Tuple[torch.Tensor, int, int]:
    """Check the operands, fetch the plans and launch ``cgt_<kernel>`` once
    a column segment, in range order; y and the (tiles, 2) carries are
    views of one allocation, the carries shared by the ranges. Returns y,
    the ranges swept and how many of them were hypersparse."""
    check_operands(kernel, adj, x, _weights(adj, use_weights))
    if x.dim() != 1:
        raise ValueError(f"{kernel}: x must be 1-D, got shape {tuple(x.shape)}")
    ipt = SUM_ITEMS_PER_THREAD
    width = segment_width(adj, x.device)
    if width >= adj.num_minors:
        sweeps, row_ids = [adj], [None]
    else:
        sweeps = segments_for(adj, width, SEGMENT_HYPERSPARSE_SHARE)
        row_ids = [s.row_ids for s in sweeps]
    plans = [tiles_for(s, SUM_THREADS * ipt) for s in sweeps]
    n_tiles = max(tile_row.numel() for tile_row, _ in plans) - 1
    v = adj.num_majors
    buf = torch.empty(v + 2 * n_tiles, dtype=torch.float32, device=x.device)
    y = buf[:v]
    fn = getattr(build.load("spmv"), f"cgt_{kernel}")
    with on_device(x.device):
        for k, (s, rows, (tile_row, tile_edge)) in enumerate(zip(sweeps, row_ids, plans)):
            rc = fn(
                ptr(s.offsets), ptr(rows), ptr(s.minors), ptr(_weights(s, use_weights)), ptr(x),
                ptr(tile_row), ptr(tile_edge), buf.data_ptr() + 4 * v, ptr(y),
                tile_row.numel() - 1, ipt, k > 0, stream_of(x.device),
            )
            raise_on_error(kernel, rc)
    return y, len(sweeps), sum(rows is not None for rows in row_ids)


@spanned("cgt/kernel.spmv_sum")
def spmv_sum(
    adj: CompressedAdj, x: torch.Tensor, *, use_weights: bool = True
) -> torch.Tensor:
    """y[d] = sum over in-edges s->d of w * x[s], f32. Carries the TPU's
    keyed reduce (``spmv3.py:862``) and, weighted, the v1 windowed pull
    SpMV (``spmv.py:194``, ``pull_spmv`` 224 / 260)."""
    if x.device.type == "cpu":
        return spmv_sum_reference(adj, x, use_weights=use_weights)
    y, passes, hypersparse = _launch("spmv_sum", adj, x, use_weights)
    spmv_sum.launches += 1
    spmv_sum.segment_passes += passes
    spmv_sum.hypersparse_passes += hypersparse
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
    y, passes, hypersparse = _launch("spmv_minplus", adj, x, use_weights)
    spmv_minplus.launches += 1
    spmv_minplus.segment_passes += passes
    spmv_minplus.hypersparse_passes += hypersparse
    return y


spmv_sum.launches = 0
spmv_minplus.launches = 0
spmv_sum.segment_passes = 0
spmv_minplus.segment_passes = 0
spmv_sum.hypersparse_passes = 0
spmv_minplus.hypersparse_passes = 0
