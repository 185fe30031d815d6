"""Distributed graph container and its construction, one rank at a time.

Counterpart of ``cugraph_tpu/dist/mg_graph.py`` (ref:
create_graph_from_edgelist_impl.cuh, renumber_edgelist_impl.cuh:96,
shuffle_wrappers.hpp:42,126). Every rank streams the same edge chunks and
keeps only the edges of its own blocks (the JAX package's multi-host
contract, without its exchange), then compresses them on its device: the
multigraph ingest with the same ``_build_adj`` as the single-device graph,
the symmetrizing one from its distinct pairs, sorted once as int64 keys
(the JAX package's streamed ingest keeps parallel edges there; the port
stores each pair once, as its single-shot ingest and GAP's graphs do).

Differences by design: the JAX package stores each rank's edges as
(C blocks, R src-row groups, g_pad) padded slabs, for XLA's static shapes
and its ring gather mode; the port keeps exact lengths in two compressed
adjacencies. Its vertex values are per-rank (vp, ...) tensors where the
JAX package holds (R, C, vp, ...) global arrays. The DCSR src-side arrays
(``src_nzd`` and the rest, JAX mg_graph.py:60-66) are derived from
``out_block`` at their first use (``src_dcsr``) and kept in
``MGGraph.cache``: its edges are already sorted by (span-local src, b * vp
+ local dst), which for the rank's mesh row i is the order of the global
dst (b * R + i) * vp + local dst, so no second pass over the edges is
made. They are unpadded; the JAX package's edge-slot stride ``d_pad`` is
kept for the edge ids, counted at ingest (every rank sees every edge; a
coalescing ingest adds the ranks' counts with an all-reduce).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Iterable, NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ..core.convert import decompress_to_edgelist
from ..core.csr import CompressedAdj, Graph, _build_adj
from ..core.symmetrize import coalesce_edgelist, symmetrize_edgelist
from ..utils.device import DeviceLike, as_tensor, resolve_device
from ..utils.dtypes import INT32_MAX, VERTEX_DTYPE, WEIGHT_DTYPE
from ..utils.error import expects
from ..utils.timer import span
from .mesh import Mesh2D, all_gather_rows, all_reduce
from .partition import Partition2D

LANE = 128  # the JAX package pads edge slots to this many lanes
DECODE_SLICE = 1 << 27  # keys split into ids a slice at a time (1 GiB of int64)
_log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class MGGraph:
    """One rank's share of a 2D-partitioned graph.

    ``in_block`` compresses this rank's edges by dst: major b * vp + local
    dst (C * vp majors, block after block), minor the src's index in the
    column span (R * vp minors). ``out_block`` holds the same edges
    compressed by that src (R * vp majors, C * vp minors). Both carry the
    weights of a weighted graph.
    """

    in_block: CompressedAdj
    out_block: CompressedAdj
    block_counts: torch.Tensor  # (C,) int64: edges of each block on this rank
    rows: int
    cols: int
    vp: int
    num_vertices: int
    num_edges: int  # global
    # the JAX package's edge slots a rank (mg_graph.py:330-333): the largest
    # local edge count over the ranks, rounded up to LANE
    d_pad: int
    is_symmetric: bool = False
    # the selected edges' frame of ``MGPropertyGraph.extract_subgraph``
    edge_data: Optional[object] = dataclasses.field(default=None, compare=False, repr=False)
    # what is derived from the blocks once and kept: the ring's sub-blocks,
    # the DCSR arrays, the similarity paths' oriented adjacency
    cache: dict = dataclasses.field(default_factory=dict, init=False, compare=False, repr=False)

    @property
    def partition(self) -> Partition2D:
        return Partition2D(rows=self.rows, cols=self.cols,
                           num_vertices=self.num_vertices, vp=self.vp)

    @property
    def weighted(self) -> bool:
        return self.in_block.weights is not None


class SrcDcsr(NamedTuple):
    """The DCSR src-side adjacency of a rank (JAX mg_graph.py:60-66): the
    sources with at least one local edge, sorted (span-local ids), their
    offsets and the total, and each edge's global dst (int32) and weight
    (None unweighted) in that order."""

    src_nzd: torch.Tensor
    src_nzd_offsets: torch.Tensor
    src_csr_dsts: torch.Tensor
    src_csr_weights: Optional[torch.Tensor]


def src_dcsr(mesh: Mesh2D, mgg: MGGraph) -> SrcDcsr:
    """This rank's ``SrcDcsr``, derived from ``out_block`` at the first
    call and kept in ``mgg.cache``. No collective."""
    arrays = mgg.cache.get("dcsr")
    if arrays is None:
        blk, vp = mgg.out_block, mgg.vp
        nzd = torch.nonzero(blk.degrees() > 0).reshape(-1).to(VERTEX_DTYPE)
        minors = blk.minors
        arrays = mgg.cache["dcsr"] = SrcDcsr(
            src_nzd=nzd,
            src_nzd_offsets=torch.cat([blk.offsets[nzd.long()], blk.offsets[-1:]]),
            src_csr_dsts=((minors // vp * mgg.rows + mesh.i) * vp + minors % vp).to(VERTEX_DTYPE),
            src_csr_weights=blk.weights,
        )
    return arrays


ChunkSource = Union[
    Sequence[Tuple[object, object, Optional[object]]],
    Callable[[], Iterable[Tuple[object, object, Optional[object]]]],
]


def _chunk_iter(chunks: ChunkSource):
    if callable(chunks):
        return chunks()
    return iter(chunks)


def mg_renumber_map(
    chunks: ChunkSource, num_vertices: int, *, device: DeviceLike = None
) -> torch.Tensor:
    """Degree-descending renumber map from streamed edge chunks: one pass
    sums total degrees on ``device``, then a stable descending sort.
    Returns new_to_old (int32); memory O(V) whatever E."""
    dev = resolve_device(device)
    degrees = torch.zeros(num_vertices, dtype=torch.int64, device=dev)
    for chunk in _chunk_iter(chunks):
        for ids in chunk[:2]:
            degrees += torch.bincount(as_tensor(ids, torch.int64, dev), minlength=num_vertices)
    _, new_to_old = torch.sort(degrees, descending=True, stable=True)
    return new_to_old.to(VERTEX_DTYPE)


def distribute_edgelist_chunks(
    mesh: Mesh2D,
    chunks: ChunkSource,
    *,
    num_vertices: int,
    symmetrize: bool = False,
    is_symmetric: bool = False,
    renumber: bool = False,
) -> Union[MGGraph, Tuple[MGGraph, torch.Tensor]]:
    """Streamed 2D ingest: this rank's MGGraph from every rank's pass over
    the same chunks.

    chunks: a re-iterable sequence, or a zero-argument callable returning
    an iterator, of (src, dst, weight or None) numpy arrays or tensors
    with ids in [0, num_vertices). Every rank must see the same chunks.
    symmetrize=True emits both directions of each chunk's edges and
    coalesces them across chunks: each distinct ordered pair is stored
    once (a self-loop too), a weighted pair keeping its smallest weight,
    the rule of ``core/symmetrize.py``. Each ordered pair has one owner
    rank, so each rank coalesces its own share (``_coalesce``), and the
    graph's counts take one all-reduce each of SUM and MAX. Without it the
    ingest keeps parallel edges, as the reference's multigraph ingest
    does, and runs no collective. renumber=True first takes a
    degree-counting pass (``mg_renumber_map``) and returns (graph,
    new_to_old).

    A rank keeps its share of each chunk as it arrives: int64 keys
    major * (R * vp) + minor when it coalesces, else int32 minors and
    majors. The set-up spans ``cgt/ingest.coalesce`` (the merge of the
    chunks' keys, after the chunk loop) and ``cgt/ingest.compress`` (both
    blocks) hold the counters ``dropped_pairs`` and, on a card,
    ``peak_bytes`` (the process's peak device allocation at the ingest's
    end), each also logged at INFO.
    """
    r, c = mesh.rows, mesh.cols
    part = Partition2D.create(r, c, num_vertices)
    part.validate()
    vp, col_span = part.vp, r * part.vp
    dev = mesh.device

    old_to_new = new_to_old = None
    if renumber:
        new_to_old = mg_renumber_map(chunks, num_vertices, device=dev)
        old_to_new = torch.empty_like(new_to_old)
        old_to_new[new_to_old.long()] = torch.arange(
            num_vertices, dtype=VERTEX_DTYPE, device=dev)

    kept, weights = [], []
    rank_counts = torch.zeros(r * c, dtype=torch.int64, device=dev)
    emitted = 0
    for chunk in _chunk_iter(chunks):
        src = as_tensor(chunk[0], torch.int64, dev)
        dst = as_tensor(chunk[1], torch.int64, dev)
        w = chunk[2] if len(chunk) > 2 else None
        w = None if w is None else as_tensor(w, WEIGHT_DTYPE, dev)
        if src.numel():
            lo = int(torch.minimum(src.min(), dst.min()))
            hi = int(torch.maximum(src.max(), dst.max()))
            expects(lo >= 0 and hi < num_vertices,
                    "vertex id out of range [0, num_vertices)")
        if old_to_new is not None:
            src, dst = old_to_new[src].long(), old_to_new[dst].long()
        if symmetrize:
            src, dst = torch.cat([src, dst]), torch.cat([dst, src])
            w = None if w is None else torch.cat([w, w])
        i, j, b = part.edge_block(src, dst)
        if not symmetrize:
            emitted += src.numel()
            rank_counts += torch.bincount(i * c + j, minlength=r * c)
        mine = (i == mesh.i) & (j == mesh.j)
        # each temporary freed as soon as it is used: the next chunk is
        # drawn beside what the rank keeps
        del i, j
        minor = src[mine] - mesh.j * col_span
        major = b[mine] * vp + dst[mine] % vp
        del src, dst, b
        if symmetrize:
            kept.append(major * col_span + minor)
        else:
            kept.append((minor.to(VERTEX_DTYPE), major.to(VERTEX_DTYPE)))
        weights.append(None if w is None else w[mine])
        del minor, major, mine, w

    if any(w is not None for w in weights):
        # an unweighted chunk among weighted ones weighs 1, as in the JAX package
        weights = [
            torch.ones(len(k if symmetrize else k[0]), dtype=WEIGHT_DTYPE, device=dev)
            if w is None else w for k, w in zip(kept, weights)
        ]
    else:
        weights = None
    if symmetrize:
        majors, minors, w_l = _coalesce(kept, weights, col_span, dev)
        with span("cgt/ingest.compress", setup=True, device=dev) as s:
            in_block = _sorted_adj(majors, minors, w_l, c * vp, col_span)
            del majors, minors, w_l
            out_block = _transposed_adj(in_block)
            _count_peak(s, dev)
        local = torch.tensor([in_block.num_edges], dtype=torch.int64, device=dev)
        num_edges = int(all_reduce(local.clone()))
        top = int(all_reduce(local, dist.ReduceOp.MAX))
    else:
        with span("cgt/ingest.compress", setup=True, device=dev) as s:
            src_l = _cat([m for m, _ in kept], VERTEX_DTYPE, dev)
            maj_l = _cat([m for _, m in kept], VERTEX_DTYPE, dev)
            kept.clear()
            w_l = None if weights is None else _cat(weights, WEIGHT_DTYPE, dev)
            in_block = _build_adj(maj_l, src_l, w_l, c * vp, col_span)
            out_block = _build_adj(src_l, maj_l, w_l, col_span, c * vp)
            del src_l, maj_l, w_l
            _count_peak(s, dev)
        num_edges, top = emitted, int(rank_counts.max())
    mgg = MGGraph(
        in_block=in_block,
        out_block=out_block,
        # the edges of block b: majors [b * vp, (b + 1) * vp)
        block_counts=torch.diff(in_block.offsets[::vp].to(torch.int64)),
        rows=r,
        cols=c,
        vp=vp,
        num_vertices=int(num_vertices),
        num_edges=int(num_edges),
        d_pad=-(-max(top, 1) // LANE) * LANE,
        is_symmetric=bool(is_symmetric or symmetrize),
    )
    if renumber:
        return mgg, new_to_old
    return mgg


def _cat(parts, dtype, device) -> torch.Tensor:
    return torch.cat(parts) if parts else torch.empty(0, dtype=dtype, device=device)


def _decode(keys: torch.Tensor, base: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(keys // base, keys % base) as int32, a slice at a time, so that no
    int64 temporary as long as ``keys`` is made."""
    hi = torch.empty(keys.numel(), dtype=VERTEX_DTYPE, device=keys.device)
    lo = torch.empty_like(hi)
    for a in range(0, keys.numel(), DECODE_SLICE):
        k = keys[a:a + DECODE_SLICE]
        q = torch.div(k, base, rounding_mode="floor")
        hi[a:a + DECODE_SLICE] = q
        lo[a:a + DECODE_SLICE] = k - q * base
    return hi, lo


def _coalesce(keys, weights, num_minors: int, device):
    """A rank's streamed share, coalesced: (majors, minors, weights or
    None) of each distinct key major * num_minors + minor of the chunks'
    ``keys``, sorted by key; duplicates keep their smallest weight. Empties
    the lists it is given."""
    with span("cgt/ingest.coalesce", setup=True, device=device) as s:
        every = _cat(keys, torch.int64, device)
        keys.clear()
        total = every.numel()
        if weights is None:
            # keys alone: no sort order to gather through
            every = torch.unique(every)
            majors, minors = _decode(every, num_minors)
            del every
            w = None
        else:
            w = _cat(weights, WEIGHT_DTYPE, device)
            weights.clear()
            majors, minors = _decode(every, num_minors)
            del every
            majors, minors, w = coalesce_edgelist(majors, minors, w, reduce="min",
                                                  device=device)
        s.count("dropped_pairs", total - majors.numel())
    _log.info("rank %d ingest: %d parallel pairs dropped, %d kept",
              dist.get_rank(), total - majors.numel(), majors.numel())
    return majors, minors, w


def _sorted_adj(majors, minors, weights, num_majors: int, num_minors: int) -> CompressedAdj:
    """The CompressedAdj of edges already sorted by (major, minor): no sort,
    offsets found by binary search."""
    expects(majors.numel() <= INT32_MAX, "a rank's edges exceed int32 offsets")
    bounds = torch.arange(num_majors + 1, dtype=VERTEX_DTYPE, device=majors.device)
    return CompressedAdj(
        offsets=torch.searchsorted(majors, bounds, out_int32=True),
        minors=minors,
        majors=majors,
        weights=weights,
        num_majors=int(num_majors),
        num_minors=int(num_minors),
        num_edges=int(majors.numel()),
    )


def _transposed_adj(adj: CompressedAdj) -> CompressedAdj:
    """The same distinct edges compressed by their minors: unweighted, a
    sort of keys minor * num_majors + major alone (each edge is its key,
    so no order is gathered through); weighted, ``_build_adj``."""
    if adj.weights is not None:
        return _build_adj(adj.minors, adj.majors, adj.weights, adj.num_minors, adj.num_majors)
    keys = torch.empty(adj.num_edges, dtype=torch.int64, device=adj.minors.device)
    for a in range(0, adj.num_edges, DECODE_SLICE):
        b = a + DECODE_SLICE
        torch.add(adj.majors[a:b], adj.minors[a:b].to(torch.int64), alpha=adj.num_majors,
                  out=keys[a:b])
    keys = torch.unique(keys)
    minors, majors = _decode(keys, adj.num_majors)
    del keys
    return _sorted_adj(minors, majors, None, adj.num_minors, adj.num_majors)


def _count_peak(s, device) -> None:
    """Keep the process's peak device allocation with set-up span ``s``."""
    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(device)
        s.count("peak_bytes", peak)
        _log.info("rank %d ingest: peak device memory %d B", dist.get_rank(), peak)


def distribute_edgelist(
    mesh: Mesh2D,
    src,
    dst,
    weight=None,
    *,
    num_vertices: Optional[int] = None,
    symmetrize: bool = False,
    is_symmetric: bool = False,
) -> MGGraph:
    """Single-shot ingest: one chunk through ``distribute_edgelist_chunks``.
    symmetrize=True unions each edge with its reciprocal and coalesces
    duplicates first (``core/symmetrize.py``)."""
    dev = mesh.device
    src = as_tensor(src, VERTEX_DTYPE, dev)
    dst = as_tensor(dst, VERTEX_DTYPE, dev)
    if symmetrize:
        src, dst, weight = symmetrize_edgelist(src, dst, weight, device=dev)
        is_symmetric = True
    if num_vertices is None:
        num_vertices = int(torch.maximum(src.max(), dst.max())) + 1 if src.numel() else 0
    return distribute_edgelist_chunks(
        mesh, [(src, dst, weight)], num_vertices=int(num_vertices),
        is_symmetric=is_symmetric,
    )


def distribute_graph(mesh: Mesh2D, g: Graph) -> MGGraph:
    """This rank's share of a single-device Graph that every rank holds."""
    src, dst, w = decompress_to_edgelist(g)
    return distribute_edgelist(
        mesh, src, dst, w, num_vertices=g.num_vertices, is_symmetric=g.is_symmetric,
    )


def shard_vertex_values(mesh: Mesh2D, mgg: MGGraph, values) -> torch.Tensor:
    """This rank's (vp, ...) slice of a global (V, ...) vertex array: range
    q = j*R + i, zero-padded past V, on the mesh's device."""
    values = torch.as_tensor(values)
    lo, hi = mgg.partition.range_of(mesh.i, mesh.j)
    out = torch.zeros((mgg.vp,) + tuple(values.shape[1:]), dtype=values.dtype,
                      device=mesh.device)
    hi = min(hi, mgg.num_vertices)
    if hi > lo:
        out[: hi - lo] = values[lo:hi].to(mesh.device)
    return out


def unshard_vertex_values(mgg: MGGraph, local: torch.Tensor) -> torch.Tensor:
    """The global (V, ...) array from every rank's (vp, ...) slice: an
    all-gather over the world (rank order i*C + j), reordered to range
    order q = j*R + i. Every rank must call it."""
    tail = tuple(local.shape[1:])
    by_rank = all_gather_rows(local).view((mgg.rows, mgg.cols, mgg.vp) + tail)  # [i, j]
    return by_rank.transpose(0, 1).reshape((-1,) + tail)[: mgg.num_vertices]
