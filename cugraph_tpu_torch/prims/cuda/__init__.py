"""Hand-written CUDA kernels for Hopper (sm_90a) and their wrappers.

- spmv: ``spmv_sum`` and ``spmv_minplus`` over a CSC or CSR (csrc/spmv.cu).
- spmm_row: ``spmm_rows`` over a CSC, f32 or bf16 operands (csrc/spmm_row.cu),
  and ``SpmmRowsFunction``, its autograd form (backward over the CSR).
- _partition: the merge-path tile plans of ``spmv_sum`` and ``spmm_rows``,
  and the SpMVs' column segments.
- scan: ``cumsum_flat``, the f32 prefix sum (csrc/scan.cu), and
  ``segment_sums_from_cumsum``.
- assemble: ``assemble_chunks``, the chunk-granular row copy
  (csrc/assemble.cu).
- probes: ``stream_scale``, ``gather_rows``, ``gather_window_sum``,
  ``multiwin_reduce`` and ``seg_scan_rows``, the TPU probes of
  ``benchmarks/`` (csrc/probes.cu); their entry point is
  ``cugraph_tpu_torch.microbench``.
- build: nvcc build into build/cugraph_tpu_torch/ and ctypes loading.

Each wrapper launches its kernel for a CUDA tensor and takes its plain
version (``*_reference``, same module) for a CPU tensor.
"""

import torch

from .assemble import assemble_chunks, assemble_chunks_reference
from .probes import (
    gather_rows,
    gather_rows_reference,
    gather_window_sum,
    gather_window_sum_reference,
    multiwin_reduce,
    multiwin_reduce_reference,
    seg_scan_rows,
    seg_scan_rows_reference,
    stream_scale,
    stream_scale_reference,
)
from .scan import cumsum_flat, cumsum_flat_reference, segment_sums_from_cumsum
from .spmm_row import SpmmRowsFunction, spmm_rows, spmm_rows_reference
from .spmv import spmv_minplus, spmv_minplus_reference, spmv_sum, spmv_sum_reference


def pull_aggregate(g, msg: torch.Tensor) -> torch.Tensor:
    """out[v] = sum over incoming edges (u -> v) of w_uv * msg[u]; the
    counterpart of ``cugraph_tpu/prims/pallas/__init__.py:pull_aggregate``,
    whose "sorted" (keyed) and "v1" (``spmv.py:pull_spmv``) engines both
    compute this one function, ``spmv_sum`` over the CSC."""
    return spmv_sum(g.csc(), msg)


def push_aggregate(g, msg: torch.Tensor) -> torch.Tensor:
    """out[u] = sum over outgoing edges (u -> v) of w_uv * msg[v]:
    ``spmv_sum`` over the CSR, the counterpart of the JAX package's
    direction="out" layout (HITS' hub step)."""
    return spmv_sum(g.csr(), msg)
