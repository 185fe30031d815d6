"""spmm_rows: CSC row SpMM kernel (csrc/spmm_row.cu) and its plain version.

    spmm_rows(adj, X, precision)   Y[d, :] = sum over edges s->d of w * X[s, :]

``adj`` is a CSC (``Graph.csc()``) and X is (V, F) float32, any F. w is the
edge weight when ``use_weights`` and the graph is weighted, else 1.
precision "f32" is IEEE f32 throughout; "bf16" rounds w and X to bf16 (round
to nearest even) and accumulates the products in f32, the contract of the
JAX package's ``row_spmm`` (cugraph_tpu/prims/pallas/spmm_row.py:249-254).
A CUDA tensor launches the kernel (and counts the launch in ``launches``);
a CPU tensor takes the plain version.

The kernel cuts the adjacency into merge-path tiles, one warp each
(``_partition.py``); the plan is computed on the card at the first call
and kept on the adjacency. ``spmm_layout`` picks one of two layouts of a
warp's lanes by F: the wide one (F > ``NARROW_MAX_F``, GraphSAGE's 128
features: 32 lanes on one gathered row, ``ITEMS_PER_TILE`` items a tile;
bf16 mode with F % 4 == 0 gathers from a bf16 copy of x made in the same
call) and the narrow one (Brandes' blocks of a few sources: a few lanes to
an edge, so that every lane gathers, ``NARROW_ITEMS_PER_TILE`` items a
tile; the CSC's majors give each edge's row). ``SpmmRowsFunction`` makes
the product differentiable in x: its backward is ``spmm_rows`` over the
transposed adjacency (the graph's CSR).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ...core.csr import CompressedAdj
from . import build
from ._launch import check_operands, on_device, ptr, raise_on_error, stream_of
from ._partition import tiles_for

PRECISIONS = ("f32", "bf16")
# rows + edges a warp of the wide layout takes (csrc/spmm_row.cu), the
# fastest of 256-2048 at RMAT scale 21, F = 128 on an H100 (PERF.md §6)
ITEMS_PER_TILE = 1024
# the widest F of the narrow layout: at F = 80 and 96 the wide layout ran
# 1.2 times faster on an H100, so the kernel builds no 32-lane float4
# instance (16 lanes of float4 span 64); and the narrow layout's tile, the
# fastest of 512-4096 at RMAT scale 21, F = 8 (PERF.md §6)
NARROW_MAX_F = 64
NARROW_ITEMS_PER_TILE = 1024
# edges per step of the plain version: bounds its (chunk, F) gather buffer
_REFERENCE_CHUNK = 1 << 22


def _check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")


class Layout(NamedTuple):
    """How the kernel's warps cover F columns: ``lanes`` lanes to an edge,
    so ``groups`` = 32 / lanes edges a step, each lane loading ``vec``
    floats at once; ``items_per_tile`` rows + edges a warp."""

    narrow: bool
    lanes: int
    groups: int
    vec: int
    items_per_tile: int


def spmm_layout(f: int, align: int = 16) -> Layout:
    """The layout of an F-column product, x's data aligned to ``align``
    bytes. vec is the widest load (4, 2 or 1 floats) that F and the
    alignment allow. Wide (F > NARROW_MAX_F): 32 lanes, 4 columns each,
    from one float4 or four scalar loads. Narrow: the fewest lanes, a power
    of two up to 32, whose loads span F (more column passes past 32 * vec;
    float4 loads span NARROW_MAX_F with at most 16 lanes)."""
    if f < 1:
        raise ValueError(f"spmm_rows: F must be positive, got {f}")
    vec = next(n for n in (4, 2, 1) if f % n == 0 and align % (4 * n) == 0)
    if f > NARROW_MAX_F:
        return Layout(False, 32, 1, 4 if vec == 4 else 1, ITEMS_PER_TILE)
    lanes = 1
    while lanes * vec < f and lanes < 32:
        lanes *= 2
    return Layout(True, lanes, 32 // lanes, vec, NARROW_ITEMS_PER_TILE)


def _alignment(t: torch.Tensor) -> int:
    """The largest of 16, 8 and 4 bytes that t's data is aligned to."""
    addr = t.data_ptr()
    return next(n for n in (16, 8, 4) if addr % n == 0)


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
    lay = spmm_layout(f, _alignment(x))
    k = lay.items_per_tile
    tile_row, tile_edge = tiles_for(adj, k)
    n_tiles = tile_row.numel() - 1
    # fresh allocations, aligned for the kernels' vector stores; only x's
    # alignment can narrow the loads
    y = torch.empty((adj.num_majors, f), dtype=torch.float32, device=x.device)
    carry = torch.empty((n_tiles, 2, f), dtype=torch.float32, device=x.device)
    bf16 = precision == "bf16"
    lib = build.load("spmm_row")
    with on_device(x.device):
        if lay.narrow:
            majors = adj.majors
            if (majors.device != x.device or majors.dtype != torch.int32
                    or not majors.is_contiguous()):
                raise ValueError("spmm_rows: majors must be contiguous int32 on x's device")
            rc = lib.cgt_spmm_rows_narrow(
                ptr(adj.offsets), ptr(majors), ptr(adj.minors), ptr(w), ptr(x),
                ptr(tile_row), ptr(tile_edge), ptr(carry), ptr(y), n_tiles, k, f,
                lay.lanes, lay.vec, int(bf16), stream_of(x.device),
            )
        else:
            vec4 = lay.vec == 4
            xb = torch.empty_like(x, dtype=torch.bfloat16) if bf16 and vec4 else None
            rc = lib.cgt_spmm_rows(
                ptr(adj.offsets), ptr(adj.minors), ptr(w), ptr(x), ptr(xb), x.numel(),
                ptr(tile_row), ptr(tile_edge), ptr(carry), ptr(y), n_tiles, k, f,
                int(bf16), int(vec4), stream_of(x.device),
            )
    raise_on_error("spmm_rows", rc)
    spmm_rows.launches += 1
    return y


spmm_rows.launches = 0


class SpmmRowsFunction(torch.autograd.Function):
    """Y = A X over the CSC ``csc``, differentiable in X: dX = Aᵀ dY, which is
    ``spmm_rows`` over the graph's CSR ``csr`` in the same precision mode,
    with the same weights (they get no gradient). On the CPU both
    directions take the plain version."""

    @staticmethod
    def forward(ctx, x, csc, csr, precision, use_weights):
        ctx.csr, ctx.precision, ctx.use_weights = csr, precision, use_weights
        return spmm_rows(csc, x, precision=precision, use_weights=use_weights)

    @staticmethod
    def backward(ctx, dy):
        dx = spmm_rows(ctx.csr, dy.contiguous(), precision=ctx.precision,
                       use_weights=ctx.use_weights)
        return dx, None, None, None, None
