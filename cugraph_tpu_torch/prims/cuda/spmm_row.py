"""spmm_rows: CSC row SpMM kernel (csrc/spmm_row.cu) and its plain version.

    spmm_rows(adj, X, precision)   Y[d, :] = sum over edges s->d of w * X[s, :]

``adj`` is a CSC (``Graph.csc()``) and X is (V, F) float32, any F. w is the
edge weight when ``use_weights`` and the graph is weighted, else 1.
precision "f32" is IEEE f32 throughout; "bf16" rounds w and X to bf16 (round
to nearest even) and accumulates the products in f32, the contract of the
JAX package's ``row_spmm`` (cugraph_tpu/prims/pallas/spmm_row.py:249-254).
A CUDA tensor launches the kernel (and counts the launch in ``launches``);
a CPU tensor takes the plain version.
"""

from __future__ import annotations

import torch

from ...core.csr import CompressedAdj
from . import build
from ._launch import check_operands, ptr, raise_on_error, stream_of

PRECISIONS = ("f32", "bf16")
# edges per step of the plain version: bounds its (chunk, F) gather buffer
_REFERENCE_CHUNK = 1 << 22


def _check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")


def _round_bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


def spmm_rows_reference(
    adj: CompressedAdj,
    x: torch.Tensor,
    *,
    precision: str = "f32",
    use_weights: bool = True,
) -> torch.Tensor:
    """Plain version of spmm_rows, in x's dtype, on any device: a gather
    with ``index_select`` and a scatter with ``index_add_``, over chunks
    of edges so the gathered rows never exceed a (2^22, F) buffer."""
    _check_precision(precision)
    w = adj.weights if use_weights else None
    if precision == "bf16":
        x = _round_bf16(x)
        w = None if w is None else _round_bf16(w)
    y = torch.zeros((adj.num_majors,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    for lo in range(0, adj.num_edges, _REFERENCE_CHUNK):
        hi = min(lo + _REFERENCE_CHUNK, adj.num_edges)
        rows = x.index_select(0, adj.minors[lo:hi])
        if w is not None:
            rows = rows * w[lo:hi].to(x.dtype).view((-1,) + (1,) * (x.dim() - 1))
        y.index_add_(0, adj.majors[lo:hi], rows)
    return y


def spmm_rows(
    adj: CompressedAdj,
    x: torch.Tensor,
    *,
    precision: str = "f32",
    use_weights: bool = True,
) -> torch.Tensor:
    """Y[d, :] = sum over in-edges s->d of w * X[s, :], (V, F) float32."""
    _check_precision(precision)
    if x.device.type == "cpu":
        return spmm_rows_reference(adj, x, precision=precision, use_weights=use_weights)
    w = adj.weights if use_weights else None
    check_operands("spmm_rows", adj, x, w)
    if x.dim() != 2:
        raise ValueError(f"spmm_rows: x must be (V, F), got shape {tuple(x.shape)}")
    f = x.shape[1]
    y = torch.empty((adj.num_majors, f), dtype=torch.float32, device=x.device)
    vec4 = f % 4 == 0 and x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0
    with torch.cuda.device(x.device):
        rc = build.load("spmm_row").cgt_spmm_rows(
            ptr(adj.offsets), ptr(adj.minors), ptr(w), ptr(x), ptr(y),
            adj.num_majors, f, int(precision == "bf16"), int(vec4),
            stream_of(x.device),
        )
    raise_on_error("spmm_rows", rc)
    spmm_rows.launches += 1
    return y


spmm_rows.launches = 0
