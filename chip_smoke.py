#!/usr/bin/env python3
"""Drive cugraph_tpu_torch's main path on one CUDA card and check it.

    python3 chip_smoke.py [--scale 21] [--seed 0]

Phases, each unguarded, so any failure ends the run with a non-zero exit:

1. Device: require CUDA; print the card's name and power limit.
2. Build: compile the CUDA kernels from csrc/ with nvcc (sm_90a).
3. Kernels against their plain versions, on a small skewed graph, on an
   adversarial graph for the merge-path tiles (a 2^18-edge hub row, rows
   ending exactly on tile boundaries, empty first, middle and last rows;
   spmv_sum and spmv_minplus, weighted, unweighted and BFS-shaped, at both
   tile sizes) and at the main path's shapes: spmv_sum, spmv_minplus,
   spmm_rows (both modes, and an F other than 128), each kernel launched
   twice and bit-equal. Median times of single calls and of back-to-back
   calls; bounds, library yardsticks, each tile plan's one-time cost, and
   an SpMV wrapper's host time split into its parts.
4. Main path at RMAT scale 21, edgefactor 16, scrambled: generate ->
   renumber -> from_edgelist -> pagerank(tol=0, 50 iterations) ->
   bfs(0) -> 2-layer GraphSAGE forward (F = 128 -> 128 -> 64), each held
   against a reference computed here from the plain versions. The launch
   counters are set to 0 just before and read just after. Then the
   gradient path: dX of one bf16 mean spmm_aggregate, whose backward
   launches spmm_rows over the CSR, against autograd through the plain
   version.
5. MG path on the main path's edge list, on a 1 x 1 mesh over NCCL
   (world size 1): distribute_edgelist -> mg_pagerank(tol=0, 50
   iterations) -> mg_bfs(0) -> mg_sage_forward (F = 128 -> 128 -> 64),
   with the launch counters set to 0 just before and read just after;
   held against the single-device pagerank and bfs and float64 GraphSAGE
   layers, and the rank's in_block against the single-device CSC. Each
   kernel checked and timed on the rank's block.
6. Weighted path on the same graph with weights in (0, 1]: spmv_sum and
   spmv_minplus checked and timed on its CSC, then katz, eigenvector,
   hits, pagerank(tol=0, 20 iterations), sssp(0), betweenness and edge
   betweenness (k=8), degree centrality and extract_bfs_paths, each
   with its launch counters set to 0 just before and read just after,
   and each held against a float64 (or, for SSSP, bit-exact f32)
   reference computed here from the plain versions.

7. Scan and assembly entry points (TPU kernels #12 and #7) at the s21
   shapes, launch counters set to 0 just before and read just after:
   cumsum_flat on the weighted CSC weights and on a seeded U[-1, 1) array
   of the same E, segment_sums_from_cumsum over the CSC offsets, and
   assemble_chunks on E / 128 rows of 128 f32 in chunks of 16 rows, with
   ~8% of the chunks copied twice. Each held against its plain version and
   float64, timed, bounded, beside torch.cumsum / index_select +
   index_copy_. The scan also: a second launch bit-equal on both inputs,
   2^24 ones exact, lengths 1 and a tile - 1, + 0, + 1 and a slice at a
   4-byte offset against the plain version, and 200 more launches on the
   U[-1, 1) input, each bit-equal to the first. assemble_chunks also:
   int64 ids, bad ids in both widths, 200 more calls each bit-equal to
   the first, back-to-back times and its time split into parts
   (assemble_split: host µs of each part, device µs of each launch).
8. Sampling and link prediction: uniform_neighbor_sample on the weighted
   s21 graph (the main path's edges) from 1,024 seeded starts with
   fanouts [25, 10], without and with replacement, and [25, 10, -1];
   random_walks (uniform and biased) and node2vec (p = 1, q = 0.5) of
   2^14 walkers, length 80;
   jaccard, sorensen, overlap and cosine over the default pairs of the
   symmetrized graph at SMALL_SCALE, unweighted and weighted;
   all_pairs_similarity at scale 10; mg_rmat_edgelist ->
   rmat_chunk_source -> distribute_edgelist_chunks on a 1 x 1 NCCL mesh
   at SMALL_SCALE. Each phase with its launch counters set to 0 just
   before and read just after, and an independent check: sampled edges
   and walk steps are edges with their weights, slots per vertex and per
   hop follow from the degrees, a vertex of degree <= K (or fanout -1)
   takes exactly its edges; the coefficients against float64 numpy on seeded pairs and on
   every pair of the highest-degree vertex; the two-hop pairs against
   scipy; the rank's in_block against a numpy CSC of the shards.
9. Community path on the s21 edge list symmetrized (SCC on the directed
   one): weakly_connected_components, strongly_connected_components,
   core_number, k_core at the largest core, louvain, modularity, the
   three analyze_clustering_* functions, leiden and ego_graph(0, 1);
   triangle_count, ktruss and ecg at RMAT scale 18 (SMALL_SCALE); the
   two spectral clusterings at scale 10. Each phase with its launch
   counters set to 0 just before and read just after, and an independent
   reference: scipy's weak and strong components, the core numbers by
   h-index iteration from the degrees, float64 modularity above the
   singletons', a min-degree probe count of triangles and k-truss support.

The line before the last is one JSON object with a "kernels" list; the
last line is {"ok": true, "device": {...}}. Without CUDA the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import socket
import statistics
import subprocess
import sys
import time

import torch

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and f32 rate outside
# the tensor cores. Bounds are stated against these, beside the card's
# power limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
DEV = torch.device("cuda")
# tolerances (see check_* below)
TOL_SUM_REL = 1e-5  # spmv_sum, spmm_rows f32 / bf16 vs float64 plain version
# spmm_aggregate's bf16 dX against autograd through the plain version: the
# kernel rounds each term of dY to bf16, autograd rounds the summed row;
# each is within 2^-8 (bf16's unit roundoff) of the row's sum of |dY| from
# the exact sum, so 2^-7, plus the f32 sums' TOL_SUM_REL
TOL_GRAD_BF16_REL = 2.0**-7 + TOL_SUM_REL
TOL_PAGERANK_SUM = 1e-4
TOL_SAGE_ABS = 1e-4
# PageRank, Katz, eigenvector and HITS in f32 vs float64 after the same
# iterations: positive sums of up to ~1e5 terms a row, max abs error over
# max |ref|
TOL_CENTRALITY_REL = 1e-5
# each MG GraphSAGE layer (unnormalized rows) in f32 vs float64 layers
# over the same bf16 rounding of its input: sums of up to ~1e5 terms and
# 128-term dot products, max abs error over max |ref|. (Held end to end,
# the float64 hidden layer would round to bf16 apart from the f32 one in
# a few entries, and one such entry moves an output by ~2^-8 |h| |w| / deg.)
TOL_MG_SAGE_LAYER_REL = 1e-5
# betweenness in f32 vs float64 on the same sources: atomic f32 sums of up
# to ~1e6 positive terms a vertex (n eps worst, sqrt(n) eps typical), max
# abs error over max |ref|
TOL_BETWEENNESS_REL = 1e-4
# cumsum_flat: each entry within this share of the float64 prefix of |x|
# there (f32 tree sums within 4096-element tiles, f64 carries across them)
TOL_SCAN_REL = 1e-5
# segment sums as differences of two f32 prefixes: error against float64
# within this many 2^-24 of the sum of the segment's two float64 prefixes
# of |w|. Each prefix carries its own rounding: on the s21 weights the
# scan's entries reach 2.6e-7 (4.4 x 2^-24) of their prefix on an H100, so
# a difference of two reaches 4.4 of their sum; twice that here.
TOL_SEGMENT_EPS = 8.8
# Louvain, Leiden and the clustering metrics in f32 against float64, absolute
TOL_MODULARITY = 1e-6
# Louvain and Leiden must beat the singletons' modularity by this much
# (they reach 0.0389 and 0.0431 at s21 on an H100; the singletons sit
# near 0)
MODULARITY_GAIN = 0.01
# assemble_chunks at the sorted engine's s21 shape: chunks of 16 rows,
# parts of 2048 rows, each part filled with 120 of its 128 chunk slots
ASSEMBLE_CHUNK_ROWS = 16
ASSEMBLE_PART_ROWS = 2048
ASSEMBLE_PART_FILL = 120
KTRUSS_K = 16
# RMAT scale of triangle count, k-truss and ECG (at s21 their wedge probes
# and ECG's 17 Louvain runs would dominate the run), and of link prediction
SMALL_SCALE = 18
# neighbor sampling: seeded start vertices and GraphSAGE's two-layer
# fanouts (Hamilton et al., 2017)
SAMPLE_STARTS = 1024
SAMPLE_FANOUTS = (25, 10)
# and a third hop over the whole neighbourhood (fanout -1), whose ~4e4
# frontier vertices hold hubs of ~1e5 edges
SAMPLE_ALL_FANOUTS = (25, 10, -1)
# walks: 2^14 walkers of node2vec's default length 80 (Grover & Leskovec,
# 2016), node2vec with p = 1, q = 0.5
WALKERS = 1 << 14
WALK_LENGTH = 80
NODE2VEC_P, NODE2VEC_Q = 1.0, 0.5
# link prediction against float64 numpy on this many seeded pairs, plus
# every pair that touches the vertex of highest degree; unweighted: the
# same exact counts under one f32 division, so within 1e-6 absolute;
# weighted: float32 vertex weights summed in another order, within 1e-5
# of the coefficient
SIMILARITY_PAIRS = 4096
TOL_SIMILARITY_ABS = 1e-6
TOL_SIMILARITY_W_REL = 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def sync() -> None:
    torch.cuda.synchronize()


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def median_ms(fn, reps: int) -> float:
    """Median over ``reps`` launches, each between two CUDA events, after
    one warm-up call: the card's time plus the host time the call spends
    before its first launch."""
    fn()
    sync()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def back_to_back_ms(fn, reps: int) -> float:
    """A call's time on the card alone: the median over 3 rounds of
    ``reps`` back-to-back calls, each round between two CUDA events and
    divided by ``reps``, after one warm-up call. The host enqueues the
    next call while the card runs this one, so a call's host time shows
    only where it exceeds the card's."""
    fn()
    sync()
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def back_to_back(kernel, library, reps) -> dict:
    """The kernel's wrapper and the library call, each by back_to_back_ms;
    ``ms`` less ``back_to_back_ms`` is about the host time of a call."""
    return dict(back_to_back_ms=back_to_back_ms(kernel, reps),
                library_back_to_back_ms=back_to_back_ms(library, reps))


def plan_ms(adj, items: int) -> float:
    """The one-time cost of a merge-path plan (``merge_path_tiles`` on the
    card, no host read), timed on its own."""
    from cugraph_tpu_torch.prims.cuda._partition import merge_path_tiles

    return median_ms(lambda: merge_path_tiles(adj.offsets, adj.num_edges, items), 5)


@contextlib.contextmanager
def tile_constant(module, name: str, value):
    """Set a kernel module's tile constant to ``value`` inside the block
    (None keeps it); the adjacency caches a plan for each tile size."""
    old = getattr(module, name)
    setattr(module, name, old if value is None else value)
    try:
        yield
    finally:
        setattr(module, name, old)


# ---------------------------------------------------------------- graphs


def rmat_edges(scale: int, seed: int):
    """The main path's edge list: R-MAT edgefactor 16, scrambled,
    renumbered by descending degree, on the card. Returns (src, dst, V)."""
    import cugraph_tpu_torch as ct

    v = 1 << scale
    gen = torch.Generator(device=DEV).manual_seed(seed)
    src, dst = ct.rmat_edgelist(scale, 16 * v, scramble=True, generator=gen, device=DEV)
    new_to_old = ct.compute_renumber_map(src, dst, v, device=DEV)
    src, dst = ct.apply_renumber_map(new_to_old, src, dst, device=DEV)
    return src, dst, v


def rmat_graph(scale: int, seed: int, weighted: bool = False):
    """The main path's graph, CSR + CSC on the card. weighted: weights
    1 - U[0, 1) in (0, 1], so that Katz's default alpha bounds the
    spectral radius."""
    import cugraph_tpu_torch as ct

    src, dst, v = rmat_edges(scale, seed)
    w = None
    if weighted:
        wgen = torch.Generator(device=DEV).manual_seed(seed + 3)
        w = 1.0 - torch.rand(src.numel(), generator=wgen, device=DEV)
    return ct.from_edgelist(src, dst, w, num_vertices=v, device=DEV)


def skewed_graph(seed: int, v: int = 5000, e: int = 60000, weighted: bool = True):
    """A small graph with hub sources, heavy destinations and empty rows."""
    import cugraph_tpu_torch as ct

    gen = torch.Generator().manual_seed(seed)
    src = (torch.rand(e, generator=gen) ** 4 * v).long()
    dst = (torch.rand(e, generator=gen) ** 3 * (v - 100)).long()  # last 100 rows empty
    w = torch.randn(e, generator=gen) if weighted else None
    return ct.from_edgelist(src, dst, w, num_vertices=v, device=DEV)


# ------------------------------------------------------- kernel checks


def sum_reference(adj, x, reference, **kw):
    """(float64 plain result, the row's sum of |w * x|) for sum_error."""
    ref = reference(adj, x.double(), **kw)
    abs_adj = adj if adj.weights is None else dataclasses.replace(adj, weights=adj.weights.abs())
    return ref, reference(abs_adj, x.double().abs(), **kw)


def sum_error(adj, y, x, reference, ref_size=None, **kw):
    """(max abs error, max relative error) of a sum kernel against its
    plain version in float64. The relative error of a row is taken
    against the row's sum of |w * x|, the size of its terms: cancellation
    makes the plain relative error of a sum meaningless."""
    ref, size = ref_size if ref_size is not None else sum_reference(adj, x, reference, **kw)
    err = (y.double() - ref).abs()
    require(bool((err[size == 0] == 0).all()), "rows with no terms must be exactly 0")
    rel = (err / size.clamp(min=1e-300)).max().item() if err.numel() else 0.0
    return err.max().item() if err.numel() else 0.0, rel


def check_relaunch(name, y, fn) -> None:
    """A second launch on the same inputs gives the same bits (no atomics)."""
    y2 = fn()
    sync()
    require(torch.equal(y, y2), f"{name}: two launches differ")


def check_spmv_sum(adj, x) -> float:
    from cugraph_tpu_torch.prims.cuda import spmv_sum, spmv_sum_reference

    y = spmv_sum(adj, x)
    sync()
    check_relaunch("spmv_sum", y, lambda: spmv_sum(adj, x))
    abs_err, rel = sum_error(adj, y, x, spmv_sum_reference)
    require(rel <= TOL_SUM_REL, f"spmv_sum relative error {rel} > {TOL_SUM_REL}")
    return abs_err


def check_spmv_minplus(adj, x, use_weights=True) -> float:
    from cugraph_tpu_torch.prims.cuda import spmv_minplus, spmv_minplus_reference

    y = spmv_minplus(adj, x, use_weights=use_weights)
    ref = spmv_minplus_reference(adj, x, use_weights=use_weights)
    sync()
    require(torch.equal(torch.isinf(y), torch.isinf(ref)), "spmv_minplus +inf pattern differs")
    require(torch.equal(y, ref), "spmv_minplus is not bit-exact")
    check_relaunch("spmv_minplus", y, lambda: spmv_minplus(adj, x, use_weights=use_weights))
    return 0.0


def check_spmm_rows(adj, x, precision) -> float:
    from cugraph_tpu_torch.prims.cuda import spmm_rows, spmm_rows_reference

    y = spmm_rows(adj, x, precision=precision)
    sync()
    require(y.shape == (adj.num_majors, x.shape[1]), "spmm_rows output shape")
    check_relaunch("spmm_rows", y, lambda: spmm_rows(adj, x, precision=precision))
    abs_err, rel = sum_error(adj, y, x, spmm_rows_reference, precision=precision)
    require(rel <= TOL_SUM_REL, f"spmm_rows {precision} F={x.shape[1]} relative error {rel}")
    return abs_err


def adversarial_graph(seed: int, weighted: bool, tile_sizes):
    """A CSC that stresses the kernels' tile carries: an empty first row;
    one destination with 2^18 + 4321 in-edges (at least 64 tiles of every
    size used); 300 rows of 0-600 edges (many cut by one tile boundary);
    for each tile size in ``tile_sizes``, 8 rows whose end marker is the
    last item of a tile, then 5 empty rows; 2,000 rows of 0-40 edges; 7
    empty last rows. Sources are skewed over all the rows."""
    import cugraph_tpu_torch as ct

    gen = torch.Generator().manual_seed(seed)
    deg = [0, (1 << 18) + 4321] + torch.randint(0, 600, (300,), generator=gen).tolist()
    pos = sum(deg) + len(deg)  # merge-path items so far: edges and end markers
    for k in tile_sizes:
        for _ in range(8):
            d = (k - 1 - pos) % k  # this row's end marker lands on position k - 1 mod k
            deg.append(d)
            pos += d + 1
        deg += [0] * 5
        pos += 5
    deg += torch.randint(0, 40, (2000,), generator=gen).tolist() + [0] * 7
    v = len(deg)
    dst = torch.repeat_interleave(torch.arange(v), torch.tensor(deg))
    src = (torch.rand(dst.numel(), generator=gen) ** 3 * v).long()
    w = torch.randn(dst.numel(), generator=gen) if weighted else None
    g = ct.from_edgelist(src, dst, w, num_vertices=v, device=DEV)
    ends = g.csc().offsets[1:].long().cpu() + torch.arange(v)
    for k in tile_sizes:
        require(int(((ends % k) == k - 1).sum()) >= 8, f"rows ending on {k}-item tile boundaries")
    return g


def small_graph_checks(seed: int) -> None:
    from cugraph_tpu_torch.prims.cuda import spmm_row, spmm_rows, spmv, spmv_minplus, spmv_sum

    counters = (spmv_sum, spmv_minplus, spmm_rows)
    before = [k.launches for k in counters]
    gen = torch.Generator().manual_seed(seed)
    for weighted in (True, False):
        g = skewed_graph(seed + weighted, weighted=weighted)
        adj = g.csc()
        x = torch.randn(g.num_vertices, generator=gen).to(DEV)
        check_spmv_sum(adj, x)
        check_spmv_minplus(adj, x)
        frontier = torch.rand(g.num_vertices, generator=gen).to(DEV) < 0.05
        ids = torch.arange(g.num_vertices, dtype=torch.float32, device=DEV)
        check_spmv_minplus(adj, torch.where(frontier, ids, float("inf")), use_weights=False)
        for f in (128, 37):  # 37: the scalar path for F % 4 != 0
            xf = torch.randn(g.num_vertices, f, generator=gen).to(DEV)
            check_spmm_rows(adj, xf, "f32")
            check_spmm_rows(adj, xf, "bf16")
    require(
        [k.launches - b for k, b in zip(counters, before)] == [4, 8, 16],
        "every small-graph check must launch its kernel",
    )
    log("small skewed graphs: spmv_sum, spmv_minplus, spmm_rows (f32, bf16; F=128, 37) ok")

    # the adversarial graph, at the default tiles and at small ones (the hub
    # then spans thousands of tiles)
    spmm_tiles = (spmm_row.ITEMS_PER_TILE, 32)
    spmv_ipts = (spmv.SUM_ITEMS_PER_THREAD, 1)
    spmv_tiles = tuple(spmv.SUM_THREADS * i for i in spmv_ipts)
    before = [k.launches for k in counters]
    for weighted in (True, False):
        g = adversarial_graph(seed + 10 + weighted, weighted, spmm_tiles + spmv_tiles)
        adj = g.csc()
        x = torch.randn(g.num_vertices, generator=gen).to(DEV)
        frontier = torch.rand(g.num_vertices, generator=gen).to(DEV) < 0.05
        ids = torch.arange(g.num_vertices, dtype=torch.float32, device=DEV)
        xb = torch.where(frontier, ids, float("inf"))  # a BFS sweep's x
        for ipt in spmv_ipts:
            with tile_constant(spmv, "SUM_ITEMS_PER_THREAD", ipt):
                check_spmv_sum(adj, x)
                check_spmv_minplus(adj, x)
                check_spmv_minplus(adj, x, use_weights=False)
                check_spmv_minplus(adj, xb, use_weights=False)
        for f in (128, 37):
            xf = torch.randn(g.num_vertices, f, generator=gen).to(DEV)
            for precision in ("f32", "bf16"):
                for k in spmm_tiles:
                    with tile_constant(spmm_row, "ITEMS_PER_TILE", k):
                        check_spmm_rows(adj, xf, precision)
    require(
        [k.launches - b for k, b in zip(counters, before)] == [8, 24, 32],
        "every adversarial-graph check must launch its kernel",
    )
    log(f"adversarial graphs (V={g.num_vertices}, E={g.num_edges}, hub in-degree "
        f"{int(g.in_degrees().max())}): spmv_sum, spmv_minplus (weighted, unweighted, BFS "
        f"x; tiles of {list(spmv_tiles)}), "
        f"spmm_rows (tiles of {list(spmm_tiles)}; f32, bf16; F=128, 37) ok, "
        f"each bit-equal on a second launch")


def wrapper_host_split(adj, x, reps: int = 2000) -> dict:
    """An unweighted spmv_minplus call's host time in µs, by part: each part
    alone, the median over ``reps`` calls of time.perf_counter around it,
    the card idle before each (a synchronise outside the timed span). The
    parts are what the wrapper does in order; "two_empty" is the two
    allocations it made before y and the carries shared one."""
    from cugraph_tpu_torch.prims.cuda import build, spmv, spmv_minplus
    from cugraph_tpu_torch.prims.cuda._launch import check_operands, on_device, ptr, stream_of
    from cugraph_tpu_torch.prims.cuda._partition import tiles_for

    items = spmv.SUM_THREADS * spmv.SUM_ITEMS_PER_THREAD
    tile_row, tile_edge = tiles_for(adj, items)
    n_tiles, v = tile_row.numel() - 1, adj.num_majors
    buf = torch.empty(v + 2 * n_tiles, device=DEV)
    fn = build.load("spmv").cgt_spmv_minplus

    def arguments():
        return (ptr(adj.offsets), ptr(adj.minors), None, ptr(x), ptr(tile_row), ptr(tile_edge),
                buf.data_ptr() + 4 * v, buf.data_ptr(), n_tiles, spmv.SUM_ITEMS_PER_THREAD,
                stream_of(x.device))

    args = arguments()
    parts = {
        "check_operands": lambda: check_operands("spmv_minplus", adj, x, None),
        "tiles_for": lambda: tiles_for(adj, items),
        "one_empty": lambda: torch.empty(v + 2 * n_tiles, device=DEV),
        "two_empty": lambda: (torch.empty(v, device=DEV), torch.empty(2 * n_tiles, device=DEV)),
        "on_device": lambda: on_device(x.device),
        "load_library": lambda: getattr(build.load("spmv"), "cgt_spmv_minplus"),
        "stream_of": lambda: stream_of(x.device),
        "arguments": arguments,
        "ctypes_call": lambda: fn(*args),
        "wrapper": lambda: spmv_minplus(adj, x, use_weights=False),
    }
    out = {}
    for name, part in parts.items():
        times = []
        for _ in range(reps):
            sync()
            t = time.perf_counter()
            part()
            times.append(time.perf_counter() - t)
        out[name] = statistics.median(times) * 1e6
    sync()
    out["parts_sum"] = sum(out[k] for k in parts if k not in ("two_empty", "wrapper", "stream_of"))
    log(f"spmv_minplus wrapper host time, µs (median of {reps}, card idle): {json.dumps(out)}")
    return out


def bound(bytes_moved: float, flops: float):
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sparse_csr(adj):
    """adj as a torch sparse CSR tensor, the library call's operand."""
    e = adj.num_edges
    vals = adj.weights if adj.weights is not None else torch.ones(e, device=DEV)
    return torch.sparse_csr_tensor(adj.offsets, adj.minors, vals,
                                   size=(adj.num_majors, adj.num_minors))


def weighted_full_shape_kernels(g, seed: int) -> dict:
    """spmv_sum (kernel #11's function, and #3's) and spmv_minplus (#4's)
    on the weighted CSC at full shape: check, time, bound."""
    from cugraph_tpu_torch.prims.cuda import (
        spmv_minplus,
        spmv_minplus_reference,
        spmv_sum,
        spmv_sum_reference,
    )

    adj = g.csc()
    v, e = g.num_vertices, g.num_edges
    n_src = int((g.out_degrees() > 0).sum())
    # offsets, minors, weights, 4 B per source with an out-edge, and y
    b_ms, b_by = bound(4 * (v + 1) + 8 * e + 4 * n_src + 4 * v, 2 * e)
    gen = torch.Generator(device=DEV).manual_seed(seed + 4)
    lib_a = sparse_csr(adj)
    out = {}

    # spmv_sum: a Katz / PageRank message, positive
    x = torch.rand(v, generator=gen, device=DEV) / v
    err = check_spmv_sum(adj, x)
    out["spmv_sum"] = dict(
        replaces="cugraph_tpu/prims/pallas/spmv.py:194",
        max_abs_err=err, tol=f"rel {TOL_SUM_REL} of the row's sum of |w x| vs float64",
        ms=median_ms(lambda: spmv_sum(adj, x), 20),
        plain_ms=median_ms(lambda: spmv_sum_reference(adj, x), 5),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=median_ms(lambda: torch.mv(lib_a, x), 20),
        **back_to_back(lambda: spmv_sum(adj, x), lambda: torch.mv(lib_a, x), 20),
    )

    # spmv_minplus: an SSSP sweep, finite distances on a tenth of the
    # vertices, +inf elsewhere
    xd = torch.where(torch.rand(v, generator=gen, device=DEV) < 0.1,
                     4 * torch.rand(v, generator=gen, device=DEV), float("inf"))
    err = check_spmv_minplus(adj, xd)
    out["spmv_minplus"] = dict(
        replaces="cugraph_tpu/prims/pallas/spmv2.py:1675",
        max_abs_err=err, tol="bit-exact, +inf pattern equal",
        ms=median_ms(lambda: spmv_minplus(adj, xd), 20),
        plain_ms=median_ms(lambda: spmv_minplus_reference(adj, xd), 5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        back_to_back_ms=back_to_back_ms(lambda: spmv_minplus(adj, xd), 20),
    )
    log(f"weighted full-shape kernels (V={v}, E={e}): checks ok")
    return out


def full_shape_kernels(g, seed: int) -> dict:
    """Each kernel at the main path's shapes: check, time, bound; the sum
    kernels also back to back, and the one-time cost of their tile plans."""
    from cugraph_tpu_torch.prims.cuda import (
        spmm_row,
        spmm_rows,
        spmm_rows_reference,
        spmv_minplus,
        spmv,
        spmv_minplus_reference,
        spmv_sum,
        spmv_sum_reference,
    )

    adj = g.csc()
    v, e = g.num_vertices, g.num_edges
    n_src = int((g.out_degrees() > 0).sum())  # x rows the data needs
    w_bytes = 0 if adj.weights is None else 4 * e
    graph_bytes = 4 * (v + 1) + 4 * e + w_bytes
    gen = torch.Generator(device=DEV).manual_seed(seed + 1)
    lib_a = sparse_csr(adj)
    out = {}

    # spmv_sum: PageRank's message, pr / out-degree, is positive
    x = torch.rand(v, generator=gen, device=DEV) / v
    err = check_spmv_sum(adj, x)
    b_ms, b_by = bound(graph_bytes + 4 * n_src + 4 * v, e)
    out["spmv_sum"] = dict(
        max_abs_err=err, tol=f"rel {TOL_SUM_REL} of the row's sum of |w x| vs float64",
        ms=median_ms(lambda: spmv_sum(adj, x), 20),
        plain_ms=median_ms(lambda: spmv_sum_reference(adj, x), 5),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=median_ms(lambda: torch.mv(lib_a, x), 20),
        **back_to_back(lambda: spmv_sum(adj, x), lambda: torch.mv(lib_a, x), 20),
        plan_ms=plan_ms(adj, spmv.SUM_THREADS * spmv.SUM_ITEMS_PER_THREAD),
    )

    # spmv_minplus: a BFS sweep, x = id in the frontier, +inf elsewhere
    ids = torch.arange(v, dtype=torch.float32, device=DEV)
    xb = torch.where(torch.rand(v, generator=gen, device=DEV) < 0.1, ids, float("inf"))
    err = check_spmv_minplus(adj, xb, use_weights=False)
    b_ms, b_by = bound(4 * (v + 1) + 4 * e + 4 * n_src + 4 * v, e)
    out["spmv_minplus"] = dict(
        max_abs_err=err, tol="bit-exact, +inf pattern equal",
        ms=median_ms(lambda: spmv_minplus(adj, xb, use_weights=False), 20),
        plain_ms=median_ms(lambda: spmv_minplus_reference(adj, xb, use_weights=False), 5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        back_to_back_ms=back_to_back_ms(lambda: spmv_minplus(adj, xb, use_weights=False), 20),
        host_us=wrapper_host_split(adj, xb),
    )
    del xb

    # spmm_rows at F = 128 in the main path's bf16 mode, f32 beside it, and
    # F = 40 in f32
    f = 128
    xs = torch.randn(v, f, generator=gen, device=DEV)
    err_bf16 = check_spmm_rows(adj, xs, "bf16")
    err_f32 = check_spmm_rows(adj, xs, "f32")
    err_f40 = check_spmm_rows(adj, torch.randn(v, 40, generator=gen, device=DEV), "f32")
    b_ms, b_by = bound(graph_bytes + 4 * f * n_src + 4 * f * v, 2 * e * f)
    out["spmm_rows"] = dict(
        max_abs_err=err_bf16, tol=f"rel {TOL_SUM_REL} of the row's sum of |w x| vs float64",
        ms=median_ms(lambda: spmm_rows(adj, xs, precision="bf16"), 10),
        plain_ms=median_ms(lambda: spmm_rows_reference(adj, xs, precision="bf16"), 3),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=median_ms(lambda: lib_a @ xs, 10),
        **back_to_back(lambda: spmm_rows(adj, xs, precision="bf16"), lambda: lib_a @ xs, 10),
        plan_ms=plan_ms(adj, spmm_row.ITEMS_PER_TILE), mode="bf16",
        f32_ms=median_ms(lambda: spmm_rows(adj, xs, precision="f32"), 10),
        f32_max_abs_err=err_f32, f40_f32_max_abs_err=err_f40,
    )
    log(f"full-shape kernels (V={v}, E={e}, sources with out-edges={n_src}): checks ok")
    return out


# ------------------------------------------------------------ main path


def reference_pagerank(g, iterations: int, alpha: float = 0.85) -> torch.Tensor:
    """The same power iteration in float64 over spmv_sum_reference."""
    from cugraph_tpu_torch.prims.cuda import spmv_sum_reference

    v = g.num_vertices
    out_w = g.out_weight_sums().double()
    dangling = out_w <= 0
    inv_out = torch.where(dangling, 0.0, 1.0 / torch.where(dangling, 1.0, out_w))
    pr = torch.full((v,), 1.0 / v, dtype=torch.float64, device=DEV)
    for _ in range(iterations):
        agg = spmv_sum_reference(g.csc(), pr * inv_out)
        dsum = torch.where(dangling, pr, 0.0).sum()
        pr = alpha * (agg + dsum / v) + (1.0 - alpha) / v
    return pr


def reference_bfs(g, source: int):
    """Level-synchronous BFS over spmv_minplus_reference."""
    from cugraph_tpu_torch.prims.cuda import spmv_minplus_reference

    v = g.num_vertices
    ids = torch.arange(v, dtype=torch.float32, device=DEV)
    frontier = torch.zeros(v, dtype=torch.bool, device=DEV)
    frontier[source] = True
    visited = frontier.clone()
    dist = torch.full((v,), 2**31 - 1, dtype=torch.int32, device=DEV)
    pred = torch.full((v,), -1, dtype=torch.int32, device=DEV)
    dist[source] = 0
    depth = 0
    while bool(frontier.any()):
        y = spmv_minplus_reference(g.csc(), torch.where(frontier, ids, float("inf")),
                                   use_weights=False)
        new = torch.isfinite(y) & ~visited
        depth += 1
        dist[new] = depth
        pred[new] = y[new].to(torch.int32)
        visited |= new
        frontier = new
    return dist, pred


def reference_graphsage(model, g, x) -> torch.Tensor:
    """The model's layers applied by hand, with spmm_rows_reference for the
    mean aggregation in the mode the port takes: bf16 on the card above
    8192 vertices, exact f32 below (the dense branch) and on the CPU."""
    from cugraph_tpu_torch.prims.cuda import spmm_rows_reference
    from cugraph_tpu_torch.prims.dense_spmm import DENSE_MAX_VERTICES

    bf16 = x.is_cuda and g.num_vertices > DENSE_MAX_VERTICES
    deg = g.in_degrees().float().clamp(min=1)[:, None]
    for i, conv in enumerate(model.convs):
        nbr = spmm_rows_reference(g.csc(), x, precision="bf16" if bf16 else "f32") / deg
        x = conv.lin_self(x) + conv.lin_nbr(nbr)
        if i < len(model.convs) - 1:
            x = torch.relu(x)
    return x / x.norm(dim=-1, keepdim=True).clamp(min=1e-12)


def seeded_graphsage(seed: int):
    """GraphSAGE(128 -> 128 -> 64, 2 layers) with weights drawn from a
    fixed torch.Generator, uniform in +-1/sqrt(fan_in) like nn.Linear."""
    from cugraph_tpu_torch.gnn import GraphSAGE

    model = GraphSAGE(128, hidden_features=128, out_features=64, num_layers=2, device=DEV)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            fan_in = p.shape[-1] if p.dim() == 2 else 128
            p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1) / fan_in**0.5)
    return model


def main_path(scale: int, seed: int) -> dict:
    import cugraph_tpu_torch as ct
    from cugraph_tpu_torch.prims.cuda import spmm_rows, spmv_minplus, spmv_sum

    counters = {"spmv_sum": spmv_sum, "spmv_minplus": spmv_minplus, "spmm_rows": spmm_rows}
    seconds = {}
    for k in counters.values():
        k.launches = 0

    t = time.perf_counter()
    g = rmat_graph(scale, seed)
    sync()
    seconds["graph"] = time.perf_counter() - t

    model = seeded_graphsage(seed)
    feats = torch.randn(g.num_vertices, 128, device=DEV,
                        generator=torch.Generator(device=DEV).manual_seed(seed + 2))

    def graphsage():
        with torch.no_grad():
            return model(g, feats)

    phases = {
        "pagerank": lambda: ct.pagerank(g, tol=0.0, max_iterations=50),
        "bfs": lambda: ct.bfs(g, 0),
        "graphsage": graphsage,
    }
    results = {}
    for name, fn in phases.items():
        t = time.perf_counter()
        results[name] = fn()
        sync()
        seconds[name] = time.perf_counter() - t
    (pr, iters), (dist, pred), emb = results.values()

    launches = {name: k.launches for name, k in counters.items()}
    log(f"main path seconds: {json.dumps(seconds)}")
    log(f"main path launches: {json.dumps(launches)}")
    for name, n in launches.items():
        require(n > 0, f"{name} was not launched on the main path")

    # PageRank: sums to 1, matches the float64 reference
    require(abs(float(pr.sum()) - 1.0) <= TOL_PAGERANK_SUM, f"pagerank sum {float(pr.sum())}")
    ref = reference_pagerank(g, iters)
    pr_err = rel_err(pr, ref)
    require(pr_err <= TOL_CENTRALITY_REL, f"pagerank error {pr_err} > {TOL_CENTRALITY_REL}")
    pr_abs = (pr.double() - ref).abs().max().item()
    log(f"pagerank: {iters} iterations, error {pr_err:.3e} of max |ref| "
        f"(max abs {pr_abs:.3e}) vs float64 reference")

    # BFS: equal to the reference BFS
    rd, rp = reference_bfs(g, 0)
    require(torch.equal(dist, rd), "bfs distances differ from the reference")
    require(torch.equal(pred, rp), "bfs predecessors differ from the reference")
    reached = int((dist < 2**31 - 1).sum())
    levels = int(dist[dist < 2**31 - 1].max()) + 1
    log(f"bfs: {reached} vertices reached, {levels} levels, equal to the reference")

    # GraphSAGE: finite, (V, 64), matches the layers applied by hand
    require(emb.shape == (g.num_vertices, 64), f"graphsage output shape {tuple(emb.shape)}")
    require(bool(torch.isfinite(emb).all()), "graphsage output not finite")
    with torch.no_grad():
        sage_err = (emb - reference_graphsage(model, g, feats)).abs().max().item()
    require(sage_err <= TOL_SAGE_ABS, f"graphsage max abs error {sage_err}")
    log(f"graphsage: max abs error {sage_err:.3e} vs the layers applied by hand")
    return dict(seconds=seconds, launches=launches, pagerank_iterations=iters,
                pagerank_rel_err=pr_err, pagerank_max_abs_err=pr_abs, bfs_levels=levels, bfs_reached=reached,
                graphsage_err=sage_err, warm=warm_breakdown(phases),
                gradient=gradient_path(g, feats, seed))


def gradient_path(g, feats, seed: int) -> dict:
    """dX of one mean spmm_aggregate in bf16 mode at full shape: the forward
    and the backward each launch spmm_rows once (the backward over the
    CSR; counters set to 0 just before the backward and read just after).
    dX is held against autograd through the plain version on the card and
    against the plain bf16 product over the CSR in float64."""
    from cugraph_tpu_torch.gnn import spmm_aggregate
    from cugraph_tpu_torch.prims.cuda import spmm_rows, spmm_rows_reference

    v = g.num_vertices
    mode = "bf16" if feats.is_cuda else "f32"  # the mode spmm_aggregate takes
    r = torch.randn(v, feats.shape[1], device=DEV,
                    generator=torch.Generator(device=DEV).manual_seed(seed + 8))
    deg = g.in_degrees().float().clamp(min=1)[:, None]
    x = feats.clone().requires_grad_()
    spmm_rows.launches = 0
    t = time.perf_counter()
    y = spmm_aggregate(g, x, op="mean")
    sync()
    forward_s = time.perf_counter() - t
    forward = spmm_rows.launches
    loss = (y * r).sum()
    spmm_rows.launches = 0
    t = time.perf_counter()
    loss.backward()
    sync()
    backward_s = time.perf_counter() - t
    backward = spmm_rows.launches
    log(f"gradient path: spmm_rows launches forward {forward}, backward {backward}; "
        f"seconds forward {forward_s:.4f}, backward {backward_s:.4f}")
    require(forward == 1 and backward == 1, "spmm_aggregate's backward must launch spmm_rows")
    dx = x.grad
    require(dx.shape == feats.shape and bool(torch.isfinite(dx).all()), "dX shape or finiteness")
    # the kernel's contract: the bf16 product over the CSR of dL/dY = r / deg
    dy = r / deg
    abs_err, rel = sum_error(g.csr(), dx, dy, spmm_rows_reference, precision=mode)
    require(rel <= TOL_SUM_REL, f"dX relative error {rel} vs the plain {mode} CSR product")
    # autograd through the plain version rounds the summed gradient to bf16
    # (the backward of x.to(bfloat16)); the kernel rounds each term of dY
    # instead: each within 2^-8 of the row's sum of |dY| of the exact sum
    xr = feats.clone().requires_grad_()
    ((spmm_rows_reference(g.csc(), xr, precision=mode) / deg) * r).sum().backward()
    _, auto_rel = sum_error(g.csr(), dx, dy, spmm_rows_reference,
                            (xr.grad.double(), spmm_rows_reference(g.csr(), dy.double().abs())))
    require(auto_rel <= TOL_GRAD_BF16_REL,
            f"dX vs autograd through the plain version: {auto_rel} > {TOL_GRAD_BF16_REL}")
    log(f"gradient path: dX within {rel:.3e} of the plain {mode} CSR product, {auto_rel:.3e} of "
        f"autograd through the plain version (of the row's sum of |dY|)")
    return dict(launches={"spmm_rows": backward}, forward_launches=forward,
                seconds=dict(forward=forward_s, backward=backward_s),
                max_abs_err=abs_err, rel_err=rel, autograd_rel_err=auto_rel)


def profiled(fn, reps: int = 1):
    """``fn`` run ``reps`` times under torch.profiler: the wall seconds of
    the runs, and {kernel, memset or copy: [launches, device µs]} over them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        sync()
        wall = time.perf_counter() - t
    return wall, {e.key: [e.count, e.self_device_time_total]
                  for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def warm_breakdown(phases) -> dict:
    """Each algorithm phase once more, after the counted run: its wall
    seconds warm, then its device time by kernel under torch.profiler.
    The idle share is 1 - (device busy) / (profiled wall)."""
    out = {}
    for name, fn in phases.items():
        t = time.perf_counter()
        fn()
        sync()
        warm = time.perf_counter() - t
        wall, device = profiled(fn)
        busy = sum(us for _, us in device.values()) / 1e6
        top = sorted(device.items(), key=lambda kv: -kv[1][1])[:5]
        out[name] = dict(
            warm_s=warm, profiled_s=wall, device_busy_s=busy,
            idle_share=1 - busy / wall if busy else None,
            top_kernels_ms=[[key[:80], count, us / 1e3] for key, (count, us) in top],
        )
        log(f"warm {name}: {json.dumps(out[name])}")
    return out


# -------------------------------------------------------------- MG path


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def reference_sage_layer(g, x, w_self, w_nbr) -> torch.Tensor:
    """One mg_sage_forward layer before its activation, by hand in
    float64: the mean aggregation over spmm_rows_reference in bf16 mode
    (operands rounded to bf16)."""
    from cugraph_tpu_torch.prims.cuda import spmm_rows_reference

    x = x.double()
    deg = g.in_degrees().double().clamp(min=1)[:, None]
    nbr = spmm_rows_reference(g.csc(), x, precision="bf16", use_weights=False) / deg
    return x @ w_self.double() + nbr @ w_nbr.double()


def block_kernels(mesh, mgg, feats) -> dict:
    """Each kernel on the rank's block at the MG path's shapes: check
    against its plain version, time, bound, library yardstick."""
    from cugraph_tpu_torch.dist import mg_prims
    from cugraph_tpu_torch.prims.cuda import (
        spmm_rows,
        spmm_rows_reference,
        spmv_minplus,
        spmv_minplus_reference,
        spmv_sum,
        spmv_sum_reference,
    )

    blk = mgg.in_block
    rows, cols, e = blk.num_majors, blk.num_minors, blk.num_edges
    n_src = int((mgg.out_block.degrees() > 0).sum())  # span rows the data needs
    gen = torch.Generator(device=DEV).manual_seed(7)
    lib_a = sparse_csr(blk)
    out = {}
    x = torch.rand(cols, generator=gen, device=DEV) / cols
    b_ms, b_by = bound(4 * (rows + 1) + 4 * e + 4 * n_src + 4 * rows, e)
    out["spmv_sum"] = dict(
        max_abs_err=check_spmv_sum(blk, x),
        ms=median_ms(lambda: spmv_sum(blk, x), 20),
        plain_ms=median_ms(lambda: spmv_sum_reference(blk, x), 5),
        bound_ms=b_ms, bound_by=b_by, library_ms=median_ms(lambda: torch.mv(lib_a, x), 20),
        back_to_back_ms=back_to_back_ms(lambda: spmv_sum(blk, x), 20),
    )
    ids = torch.arange(cols, dtype=torch.float32, device=DEV)
    xb = torch.where(torch.rand(cols, generator=gen, device=DEV) < 0.1, ids, float("inf"))
    out["spmv_minplus"] = dict(
        max_abs_err=check_spmv_minplus(blk, xb, use_weights=False),
        ms=median_ms(lambda: spmv_minplus(blk, xb, use_weights=False), 20),
        plain_ms=median_ms(lambda: spmv_minplus_reference(blk, xb, use_weights=False), 5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        back_to_back_ms=back_to_back_ms(lambda: spmv_minplus(blk, xb, use_weights=False), 20),
    )
    x_span = mg_prims.gather_src_values(mesh, feats)
    f = x_span.shape[1]
    b_ms, b_by = bound(4 * (rows + 1) + 4 * e + 4 * f * n_src + 4 * f * rows, 2 * e * f)
    out["spmm_rows"] = dict(
        max_abs_err=check_spmm_rows(blk, x_span, "bf16"), mode="bf16",
        ms=median_ms(lambda: spmm_rows(blk, x_span, precision="bf16", use_weights=False), 10),
        plain_ms=median_ms(lambda: spmm_rows_reference(blk, x_span, precision="bf16"), 3),
        bound_ms=b_ms, bound_by=b_by, library_ms=median_ms(lambda: lib_a @ x_span, 10),
    )
    for m in out.values():
        m["block"] = dict(majors=rows, minors=cols, edges=e, span_sources=n_src)
    log(f"block kernels (majors={rows}, minors={cols}, E={e}): checks ok")
    return out


def mg_path(scale: int, seed: int) -> dict:
    """The dist/ layer on a 1 x 1 mesh over NCCL, world size 1: ingest,
    PageRank, BFS and the GraphSAGE forward at full width."""
    import torch.distributed as dist

    import cugraph_tpu_torch as ct
    from cugraph_tpu_torch.dist import distribute_edgelist, initialize_distributed, make_mesh
    from cugraph_tpu_torch.dist import mg_algos, mg_gnn
    from cugraph_tpu_torch.dist.mg_graph import shard_vertex_values, unshard_vertex_values
    from cugraph_tpu_torch.prims.cuda import spmm_rows, spmv_minplus, spmv_sum

    counters = {"spmv_sum": spmv_sum, "spmv_minplus": spmv_minplus, "spmm_rows": spmm_rows}
    torch.cuda.reset_peak_memory_stats()
    seconds = {}
    t = time.perf_counter()
    # NCCL on the card (gloo where DEV is the CPU)
    initialize_distributed(device=DEV, init_method=f"tcp://127.0.0.1:{free_port()}",
                           world_size=1, rank=0)
    mesh = make_mesh((1, 1), device=DEV)
    seconds["setup"] = time.perf_counter() - t
    # NCCL makes each group's communicator at its first collective
    t = time.perf_counter()
    for group in (None, mesh.row_group, mesh.col_group):
        dist.all_reduce(torch.zeros(1, device=DEV), group=group)
    sync()
    seconds["first_collectives"] = time.perf_counter() - t
    log(f"mg path: backend {dist.get_backend()}, mesh {mesh.shape} on {mesh.device}")
    src, dst, v = rmat_edges(scale, seed)
    sync()
    t = time.perf_counter()
    mgg = distribute_edgelist(mesh, src, dst, num_vertices=v)
    sync()
    seconds["mg_graph"] = time.perf_counter() - t
    g = ct.from_edgelist(src, dst, num_vertices=v, device=DEV)  # the single-device reference
    del src, dst
    params = mg_gnn.init_sage_params(torch.Generator(device=DEV).manual_seed(seed + 5),
                                     128, 128, 64, device=DEV)
    feats_global = torch.randn(v, 128, device=DEV,
                               generator=torch.Generator(device=DEV).manual_seed(seed + 2))
    feats = shard_vertex_values(mesh, mgg, feats_global)
    phases = {
        "mg_pagerank": lambda: mg_algos.mg_pagerank(mesh, mgg, tol=0.0, max_iterations=50),
        "mg_bfs": lambda: mg_algos.mg_bfs(mesh, mgg, 0),
        "mg_graphsage": lambda: mg_gnn.mg_sage_forward(mesh, mgg, params, feats),
    }
    for k in counters.values():
        k.launches = 0
    results = {}
    for name, fn in phases.items():
        t = time.perf_counter()
        results[name] = fn()
        sync()
        seconds[name] = time.perf_counter() - t
    launches = {name: k.launches for name, k in counters.items()}
    log(f"mg path seconds: {json.dumps(seconds)}")
    log(f"mg path launches: {json.dumps(launches)}")
    pr_l, iters = results["mg_pagerank"]
    # 50 at scale 21; a small graph may reach an exact fixpoint sooner
    require(launches["spmv_sum"] == iters, "mg_pagerank must launch spmv_sum once an iteration")
    require(launches["spmv_minplus"] > 0, "spmv_minplus was not launched by mg_bfs")
    require(launches["spmm_rows"] == 2, "mg_sage_forward must launch spmm_rows once a layer")
    out = dict(seconds=seconds, launches=launches)

    # the rank's in_block is the single-device CSC on one rank
    csc = g.csc()
    for key in ("offsets", "minors", "majors"):
        require(torch.equal(getattr(mgg.in_block, key), getattr(csc, key)),
                f"in_block.{key} differs from the single-device CSC")

    # PageRank against the single-device pagerank, relative to max |ref|
    pr = unshard_vertex_values(mgg, pr_l)
    ref, ref_iters = ct.pagerank(g, tol=0.0, max_iterations=50)
    require(iters == ref_iters, f"mg_pagerank ran {iters} iterations, pagerank {ref_iters}")
    pr_err = rel_err(pr, ref.double())
    require(pr_err <= TOL_CENTRALITY_REL, f"mg_pagerank error {pr_err} > {TOL_CENTRALITY_REL}")
    out["pagerank"] = dict(iterations=iters, rel_err=pr_err)

    # BFS: distances and predecessors equal to the single-device bfs
    dist_l, pred_l = results["mg_bfs"]
    rd, rp = ct.bfs(g, 0)
    require(torch.equal(unshard_vertex_values(mgg, dist_l), rd), "mg_bfs distances differ")
    require(torch.equal(unshard_vertex_values(mgg, pred_l), rp), "mg_bfs predecessors differ")
    out["bfs"] = dict(reached=int((rd < 2**31 - 1).sum()))

    # GraphSAGE: finite, (V, 64); the forward is its two layers, and each
    # layer matches float64 on the layer's own input
    emb = unshard_vertex_values(mgg, results["mg_graphsage"])
    require(emb.shape == (v, 64), f"mg graphsage output shape {tuple(emb.shape)}")
    require(bool(torch.isfinite(emb).all()), "mg graphsage output not finite")
    p = params
    h = torch.relu(feats @ p["w_self1"]
                   + mg_algos.mg_spmm_aggregate(mesh, mgg, feats, op="mean") @ p["w_nbr1"])
    out2 = h @ p["w_self2"] + mg_algos.mg_spmm_aggregate(mesh, mgg, h, op="mean") @ p["w_nbr2"]
    h = unshard_vertex_values(mgg, h)
    comp_err = rel_err(emb, unshard_vertex_values(mgg, out2).double())
    require(comp_err <= 1e-6, f"mg_sage_forward differs from its layers: {comp_err}")
    l1_err = rel_err(h, torch.relu(reference_sage_layer(g, feats_global, p["w_self1"], p["w_nbr1"])))
    l2_err = rel_err(emb, reference_sage_layer(g, h, p["w_self2"], p["w_nbr2"]))
    for name, err in (("layer 1", l1_err), ("layer 2", l2_err)):
        require(err <= TOL_MG_SAGE_LAYER_REL,
                f"mg graphsage {name} error {err} > {TOL_MG_SAGE_LAYER_REL}")
    out["graphsage"] = dict(layer1_rel_err=l1_err, layer2_rel_err=l2_err,
                            forward_vs_layers_rel_err=comp_err)
    del h, out2, g
    log(f"mg path checks: {json.dumps({k: out[k] for k in ('pagerank', 'bfs', 'graphsage')})}")

    out["block"] = block_kernels(mesh, mgg, feats)
    out["warm"] = warm_breakdown(phases)
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    log(f"mg path peak memory: {out['max_memory_allocated']} B")
    dist.destroy_process_group()
    return out


# -------------------------------------------------------- weighted path


def reference_katz(g, iterations: int) -> torch.Tensor:
    """Katz with the default alpha and beta = 1, the same iterations in
    float64 over spmv_sum_reference, L2-normalized."""
    from cugraph_tpu_torch.prims.cuda import spmv_sum_reference

    alpha = 1.0 / (int(g.out_degrees().max()) + 1)
    x = torch.zeros(g.num_vertices, dtype=torch.float64, device=DEV)
    for _ in range(iterations):
        x = alpha * spmv_sum_reference(g.csc(), x) + 1.0
    return x / x.norm()


def reference_eigenvector(g, iterations: int) -> torch.Tensor:
    from cugraph_tpu_torch.prims.cuda import spmv_sum_reference

    x = torch.full((g.num_vertices,), 1.0 / g.num_vertices, dtype=torch.float64, device=DEV)
    for _ in range(iterations):
        x = spmv_sum_reference(g.csc(), x) + x
        x = x / x.norm()
    return x


def reference_hits(g, iterations: int):
    """(hubs, authorities), the same iterations in float64, each
    half-step max-normalized, then sum-normalized."""
    from cugraph_tpu_torch.prims.cuda import spmv_sum_reference

    h = torch.full((g.num_vertices,), 1.0 / g.num_vertices, dtype=torch.float64, device=DEV)
    a = torch.zeros_like(h)
    for _ in range(iterations):
        a = spmv_sum_reference(g.csc(), h)
        a = a / a.max().clamp(min=1e-30)
        h = spmv_sum_reference(g.csr(), a)
        h = h / h.max().clamp(min=1e-30)
    return h / h.sum().clamp(min=1e-30), a / a.sum().clamp(min=1e-30)


def reference_sssp(g, source: int):
    """Bellman-Ford over spmv_minplus_reference in f32 until no distance
    changes; predecessors: the smallest src among the tree edges."""
    from cugraph_tpu_torch.prims.cuda import spmv_minplus_reference

    v = g.num_vertices
    csc = g.csc()
    dist = torch.full((v,), float("inf"), device=DEV)
    dist[source] = 0.0
    while True:
        new = torch.minimum(dist, spmv_minplus_reference(csc, dist))
        if not bool((new < dist).any()):
            break
        dist = new
    s, d = csc.minors.long(), csc.majors.long()
    tree = torch.isfinite(dist[d]) & (dist[s] + csc.weights == dist[d]) & (d != source)
    pred = torch.full((v,), v, dtype=torch.int64, device=DEV)
    pred.scatter_reduce_(0, d[tree], s[tree], "amin")
    return dist, torch.where(pred < v, pred, -1).to(torch.int32)


def reference_brandes(g, sources):
    """Brandes one source at a time in float64 over the CSR, with the
    frontier's edges compacted: (sum of vertex dependencies (V,), sum of
    edge dependencies (E,)), unweighted shortest paths."""
    v = g.num_vertices
    csr = g.csr()
    s_ids, d_ids = csr.majors.long(), csr.minors.long()
    delta_sum = torch.zeros(v, dtype=torch.float64, device=DEV)
    edge_sum = torch.zeros(g.num_edges, dtype=torch.float64, device=DEV)
    for src in sources.tolist():
        dist = torch.full((v,), -1, dtype=torch.int64, device=DEV)
        dist[src] = 0
        sigma = torch.zeros(v, dtype=torch.float64, device=DEV)
        sigma[src] = 1.0
        frontier, level = dist == 0, 0
        while bool(frontier.any()):
            e = (frontier[s_ids] & (dist[d_ids] < 0)).nonzero().squeeze(1)
            add = torch.zeros_like(sigma).index_add_(0, d_ids[e], sigma[s_ids[e]])
            frontier = add > 0
            level += 1
            dist[frontier] = level
            sigma += add
        delta = torch.zeros_like(sigma)
        for d in range(level - 1, -1, -1):
            e = ((dist[s_ids] == d) & (dist[d_ids] == d + 1)).nonzero().squeeze(1)
            c = sigma[s_ids[e]] / sigma[d_ids[e]] * (1.0 + delta[d_ids[e]])
            edge_sum.index_add_(0, e, c)
            delta.index_add_(0, s_ids[e], c)
        delta[src] = 0.0
        delta_sum += delta
    return delta_sum, edge_sum


def rel_err(got, ref) -> float:
    return ((got.double() - ref).abs().max() / ref.abs().max().clamp(min=1e-300)).item()


def weighted_path(g, seed: int) -> dict:
    """The link-analysis, centrality and traversal surface on the weighted
    graph, one phase at a time, each with its own launch counts."""
    import cugraph_tpu_torch as ct
    from cugraph_tpu_torch.algos.centrality import sample_sources
    from cugraph_tpu_torch.prims.cuda import spmm_rows, spmv_minplus, spmv_sum

    counters = {"spmv_sum": spmv_sum, "spmv_minplus": spmv_minplus, "spmm_rows": spmm_rows}
    v = g.num_vertices
    k = 8
    torch.cuda.reset_peak_memory_stats()
    phases = {
        "katz": lambda: ct.katz_centrality(g),
        "eigenvector": lambda: ct.eigenvector_centrality(g),
        "hits": lambda: ct.hits(g),
        "pagerank": lambda: ct.pagerank(g, tol=0.0, max_iterations=20),
        "sssp": lambda: ct.sssp(g, 0),
        "betweenness": lambda: ct.betweenness_centrality(g, k=k, seed=seed),
        "edge_betweenness": lambda: ct.edge_betweenness_centrality(g, k=k, seed=seed),
        "degree": lambda: ct.degree_centrality(g),
    }
    seconds, launches, results = {}, {}, {}

    def run(name, fn):
        for c in counters.values():
            c.launches = 0
        t = time.perf_counter()
        results[name] = fn()
        sync()
        seconds[name] = time.perf_counter() - t
        launches[name] = {n: c.launches for n, c in counters.items()}

    for name, fn in list(phases.items()):
        run(name, fn)
        if name == "sssp":
            dist, pred = results["sssp"]
            # the four farthest reached vertices: the longest paths
            dests = torch.topk(torch.where(torch.isfinite(dist), dist, -1.0), 4).indices
            phases["paths"] = lambda: ct.extract_bfs_paths(g, dist, pred, dests)
            run("paths", phases["paths"])
    log(f"weighted path seconds: {json.dumps(seconds)}")
    log(f"weighted path launches: {json.dumps(launches)}")
    for name in ("katz", "eigenvector", "hits", "pagerank"):
        require(launches[name]["spmv_sum"] > 0, f"spmv_sum was not launched by {name}")
    require(launches["sssp"]["spmv_minplus"] > 0, "spmv_minplus was not launched by sssp")
    out = dict(seconds=seconds, launches=launches)

    # Katz, eigenvector, HITS, PageRank: the same iterations in float64
    x, it = results["katz"]
    out["katz"] = dict(iterations=it, rel_err=rel_err(x, reference_katz(g, it)))
    x, it = results["eigenvector"]
    out["eigenvector"] = dict(iterations=it, rel_err=rel_err(x, reference_eigenvector(g, it)))
    h, a, it = results["hits"]
    rh, ra = reference_hits(g, it)
    out["hits"] = dict(iterations=it, rel_err=max(rel_err(h, rh), rel_err(a, ra)))
    for name in ("katz", "eigenvector", "hits"):
        err = out[name]["rel_err"]
        require(err <= TOL_CENTRALITY_REL, f"{name} error {err} > {TOL_CENTRALITY_REL}")
    pr, it = results["pagerank"]
    ref = reference_pagerank(g, it)
    pr_err = rel_err(pr, ref)
    require(pr_err <= TOL_CENTRALITY_REL,
            f"weighted pagerank error {pr_err} > {TOL_CENTRALITY_REL}")
    out["pagerank"] = dict(iterations=it, rel_err=pr_err,
                           max_abs_err=(pr.double() - ref).abs().max().item(),
                           max_ref=ref.abs().max().item())

    # SSSP: distances bit-equal, predecessors equal to the post-pass rule
    # and on tree edges
    rd, rp = reference_sssp(g, 0)
    require(torch.equal(dist, rd), "sssp distances differ from Bellman-Ford")
    require(torch.equal(pred, rp), "sssp predecessors differ from the tree-edge rule")
    csc = g.csc()
    s, d = csc.minors.long(), csc.majors.long()
    tree = (s == pred[d].long()) & (dist[s] + csc.weights == dist[d])
    has = torch.zeros(v, dtype=torch.bool, device=DEV)
    has[d[tree]] = True
    want = torch.isfinite(dist)
    want[0] = False
    require(torch.equal(has, want), "a reached vertex has no tree edge from its predecessor")
    out["sssp"] = dict(reached=int(torch.isfinite(dist).sum()),
                       max_dist=float(dist[torch.isfinite(dist)].max()))

    # extract_bfs_paths: each row walks the predecessors back from its
    # destination, -1 before the start
    paths, max_len = results["paths"]
    require(max_len == int(dist[dests].max()) + 1, "path length")
    cur = dests.to(torch.int32)
    for j in range(max_len - 1, -1, -1):
        require(torch.equal(paths[:, j], cur), f"path column {j}")
        cur = torch.where(cur >= 0, pred[cur.clamp(min=0).long()], -1)
    out["paths"] = dict(destinations=dests.tolist(), max_len=max_len)

    # betweenness and edge betweenness: the same sources in float64
    sources = sample_sources(v, k, seed, DEV)
    delta, edge = reference_brandes(g, sources)
    bc_err = rel_err(results["betweenness"], delta * (v / k) / ((v - 1) * (v - 2)))
    ebc_err = rel_err(results["edge_betweenness"], edge * (v / k) / (v * (v - 1)))
    for name, err in (("betweenness", bc_err), ("edge betweenness", ebc_err)):
        require(err <= TOL_BETWEENNESS_REL, f"{name} error {err} > {TOL_BETWEENNESS_REL}")
    out["betweenness"] = dict(k=k, sources=sources.tolist(), rel_err=bc_err,
                              edge_rel_err=ebc_err)

    # degree: (in + out) / (V - 1), equal
    deg = (g.out_degrees() + g.in_degrees()).float() / (v - 1)
    require(torch.equal(results["degree"], deg), "degree centrality")
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    log(f"weighted path checks: {json.dumps({n: out[n] for n in out if n not in ('seconds', 'launches')})}")
    out["warm"] = warm_breakdown(phases)
    return out


# ------------------------------------------------- scan and assembly


def check_cumsum(x, y, plain, name: str) -> dict:
    """Each entry of y within TOL_SCAN_REL of the float64 prefix of |x|,
    both from the float64 prefix of x and from the plain version's y."""
    size = torch.cumsum(x.double().abs(), 0).clamp(min=1e-300)
    err = (y.double() - torch.cumsum(x.double(), 0)).abs()
    out = dict(max_abs_err=err.max().item(), rel=(err / size).max().item(),
               vs_plain_rel=((y.double() - plain.double()).abs() / size).max().item())
    for key in ("rel", "vs_plain_rel"):
        require(out[key] <= TOL_SCAN_REL,
                f"{name}: {key} error {out[key]} of the prefix of |x| > {TOL_SCAN_REL}")
    return out


def scan_edge_cases(inputs, scans, repeats: int = 200) -> dict:
    """cumsum_flat's single-pass look-back beyond the path's two calls: a
    second launch bit-equal on each input; 2^24 ones, where every entry is
    i + 1 exactly; lengths at a tile's edges and a slice 4 bytes into its
    storage (no 16-byte loads there), each against the plain version; then
    ``repeats`` launches on the U[-1, 1) input, each bit-equal to the
    first, so that a race or a deadlock in the look-back shows."""
    from cugraph_tpu_torch.prims.cuda import cumsum_flat, cumsum_flat_reference, scan

    for name, x in inputs.items():
        check_relaunch(f"cumsum_flat({name})", scans[name], lambda: cumsum_flat(x))
    ones = torch.ones(1 << 24, device=DEV)
    want = torch.arange(1, (1 << 24) + 1, dtype=torch.float32, device=DEV)
    require(torch.equal(cumsum_flat(ones), want), "cumsum_flat of 2^24 ones is not i + 1")
    x = inputs["uniform"]
    out = {}
    for n in (1, scan.TILE - 1, scan.TILE, scan.TILE + 1):
        out[f"n={n}"] = check_cumsum(x[:n], cumsum_flat(x[:n]), cumsum_flat_reference(x[:n]),
                                     f"cumsum_flat(n={n})")
    tail = x[1:]
    require(tail.data_ptr() % 16 == 4, "the slice starts 4 bytes into its storage")
    out["offset_4_bytes"] = check_cumsum(tail, cumsum_flat(tail), cumsum_flat_reference(tail),
                                         "cumsum_flat(x[1:])")
    first = scans["uniform"]
    t = time.perf_counter()
    same = 0
    for _ in range(repeats):
        same += bool(torch.equal(cumsum_flat(x), first))
    sync()
    require(same == repeats, f"cumsum_flat: {repeats - same} of {repeats} repeats differ")
    out["repeats"] = dict(n=repeats, bit_equal=same, seconds=time.perf_counter() - t)
    log(f"cumsum_flat edge cases: {json.dumps(out)}")
    return out


def assemble_split(binned, chunk_src, chunk_dst, ch: int, out_rows: int, reps: int = 2000) -> dict:
    """assemble_chunks' time by part at one shape. Host µs: each part alone,
    the median over ``reps`` runs of time.perf_counter around it, the card
    idle before each (a synchronise outside the timed span): the argument
    checks, the output's allocation, the C call alone (a memset and two
    launches, then a wait for the index pass) and the whole wrapper. A
    part's time ends when it returns, the card maybe still copying.
    Device µs per launch from torch.profiler; the whole call as
    ``median_ms`` and ``back_to_back_ms`` time it."""
    from cugraph_tpu_torch.prims.cuda import assemble, assemble_chunks, build

    out_chunks, in_chunks = out_rows // ch, binned.shape[0] // ch
    width, lanes = ch * binned.shape[1], binned.shape[1]
    fn = build.load("assemble").cgt_assemble_chunks
    buf = torch.empty(out_rows * lanes + out_chunks, device=DEV)
    flag, event = assemble._flag_and_event(DEV)
    args = (binned.data_ptr(), chunk_src.data_ptr(), chunk_dst.data_ptr(),
            buf.data_ptr() + 4 * out_rows * lanes, buf.data_ptr(), flag.data_ptr(), event,
            chunk_src.numel(), in_chunks, out_chunks, width // 4, 0,
            torch.cuda.current_stream().cuda_stream)

    def call():
        return assemble_chunks(binned, chunk_src, chunk_dst, ch, out_rows)

    parts = {
        "check": lambda: assemble._check(binned, chunk_src, chunk_dst, ch, out_rows),
        "one_empty": lambda: torch.empty(out_rows * lanes + out_chunks, device=DEV),
        "ctypes_call": lambda: fn(*args),
        "wrapper": call,
    }
    host = {}
    for name, part in parts.items():
        times = []
        for _ in range(reps):
            sync()
            t = time.perf_counter()
            part()
            times.append(time.perf_counter() - t)
        host[name] = statistics.median(times) * 1e6
    sync()
    call()
    _, device = profiled(call, 50)
    out = dict(host_us=host,
               device_us={k[:60]: [count / 50, us / 50] for k, (count, us) in device.items()},
               median_ms=median_ms(call, 200), back_to_back_ms=back_to_back_ms(call, 50))
    log(f"assemble_chunks split: {json.dumps(out)}")
    return out


def seeded_chunk_layout(n_chunks: int, seed: int):
    """chunk_src / chunk_dst shaped like the sorted engine's at s21: every
    binned chunk once in a seeded order, and after some 8% of them a
    second copy (a run's boundary chunk lands in two parts: real / copied
    cells 92.1%, spmv2.py:86-90); parts of 2048 rows (128 chunks of 16),
    each filled with ASSEMBLE_PART_FILL consecutive chunks."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    order = torch.randperm(n_chunks, generator=gen, device=DEV)
    n_rep = round(n_chunks * (1 / 0.921 - 1))
    twice = torch.zeros(n_chunks, dtype=torch.bool, device=DEV)
    twice[torch.randperm(n_chunks, generator=gen, device=DEV)[:n_rep]] = True
    chunk_src = order.repeat_interleave(1 + twice.long()).to(torch.int32)
    step = torch.arange(chunk_src.numel(), device=DEV)
    per_part = ASSEMBLE_PART_ROWS // ASSEMBLE_CHUNK_ROWS
    part, slot = step // ASSEMBLE_PART_FILL, step % ASSEMBLE_PART_FILL
    chunk_dst = (part * per_part + slot).to(torch.int32)
    out_rows = (int(part[-1]) + 1) * ASSEMBLE_PART_ROWS
    return chunk_src, chunk_dst, out_rows


def scan_assemble_path(g, seed: int) -> dict:
    """The entry points of kernels #12 and #7 at the s21 shapes: launch
    counters set to 0 just before and read just after; then each kernel
    against its plain version and float64, timed, bounded, and beside its
    library yardstick."""
    from cugraph_tpu_torch.prims.cuda import (
        assemble_chunks,
        assemble_chunks_reference,
        cumsum_flat,
        cumsum_flat_reference,
        segment_sums_from_cumsum,
    )

    adj = g.csc()
    e = adj.num_edges
    gen = torch.Generator(device=DEV).manual_seed(seed + 6)
    inputs = {"weights": adj.weights, "uniform": torch.rand(e, generator=gen, device=DEV) * 2 - 1}
    ch = ASSEMBLE_CHUNK_ROWS
    rows = -(-e // 128 // ch) * ch  # E / 128 rows, rounded up to whole chunks
    binned = torch.randn(rows, 128, generator=gen, device=DEV)
    chunk_src, chunk_dst, out_rows = seeded_chunk_layout(rows // ch, seed + 7)

    counters = {"cumsum_flat": cumsum_flat, "assemble_chunks": assemble_chunks}
    for c in counters.values():
        c.launches = 0
    t = time.perf_counter()
    scans = {name: cumsum_flat(x) for name, x in inputs.items()}
    seg = segment_sums_from_cumsum(scans["weights"], adj.offsets, adj.num_majors)
    assembled = assemble_chunks(binned, chunk_src, chunk_dst, ch, out_rows)
    sync()
    seconds = time.perf_counter() - t
    launches = {n: c.launches for n, c in counters.items()}
    log(f"scan/assemble path launches: {json.dumps(launches)}")
    require(launches == {"cumsum_flat": 2, "assemble_chunks": 1},
            "the scan/assemble entry points must launch their kernels")
    # a chunk id outside its array raises on the card, as on the CPU; an
    # int64 id past 2^31 is not cut into the arrays
    for bad_src, bad_dst, dtype in ((rows // ch, 0, torch.int32), (0, out_rows // ch, torch.int32),
                                    (-1, 0, torch.int64), (2**32, 0, torch.int64)):
        try:
            assemble_chunks(binned, torch.tensor([bad_src], dtype=dtype, device=DEV),
                            torch.tensor([bad_dst], dtype=dtype, device=DEV), ch, out_rows)
        except ValueError:
            continue
        raise RuntimeError("check failed: assemble_chunks took a chunk id outside its array")

    out = {}
    errs = {name: check_cumsum(x, scans[name], cumsum_flat_reference(x), f"cumsum_flat({name})")
            for name, x in inputs.items()}
    errs["edge_cases"] = scan_edge_cases(inputs, scans)
    # segment sums: the boundaries exact over a float64 prefix; the kernel's
    # f32 differences each within the rounding of its own two prefixes
    ref = torch.zeros(adj.num_majors, dtype=torch.float64, device=DEV)
    ref.index_add_(0, adj.majors, adj.weights.double())  # in_weight_sums in float64
    prefix = torch.cat([ref.new_zeros(1), torch.cumsum(adj.weights.double(), 0)])
    seg64 = segment_sums_from_cumsum(prefix[1:], adj.offsets, adj.num_majors)
    lo, hi = prefix[adj.offsets[:-1].long()], prefix[adj.offsets[1:].long()]
    require(bool(((seg64 - ref).abs() <= 1e-12 * hi).all()),
            "segment sums over a float64 prefix differ from float64 in_weight_sums")
    seg_diff = (seg.double() - ref).abs()
    seg_err = seg_diff.max().item()
    seg_ulps = (seg_diff / (2.0**-24 * (lo + hi)).clamp(min=2.0**-149)).max().item()
    require(seg_ulps <= TOL_SEGMENT_EPS,
            f"segment sums error {seg_ulps} x 2^-24 of the segment's two prefixes > {TOL_SEGMENT_EPS}")
    top = float(prefix[-1])
    x = inputs["uniform"]
    b_ms, b_by = bound(8 * e, e)
    out["cumsum_flat"] = dict(
        max_abs_err=errs["uniform"]["max_abs_err"],
        tol=f"{TOL_SCAN_REL} of the float64 prefix of |x| at each entry, vs float64 and vs plain",
        errors=dict(errs, segment_sums_max_abs_err=seg_err, largest_prefix=top,
                    segment_sums_eps_of_prefixes=seg_ulps,
                    segment_tol=f"{TOL_SEGMENT_EPS} x 2^-24 of each segment's two prefixes"),
        n=e, ms=median_ms(lambda: cumsum_flat(x), 20),
        plain_ms=median_ms(lambda: cumsum_flat_reference(x), 20),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=median_ms(lambda: torch.cumsum(x, 0), 20),
        **back_to_back(lambda: cumsum_flat(x), lambda: torch.cumsum(x, 0), 20),
    )

    plain = assemble_chunks_reference(binned, chunk_src, chunk_dst, ch, out_rows)
    sync()
    require(torch.equal(assembled, plain), "assemble_chunks is not bit-equal to its plain version")
    require(torch.equal(assemble_chunks(binned, chunk_src.long(), chunk_dst.long(), ch, out_rows),
                        plain), "assemble_chunks on int64 ids differs")
    t = time.perf_counter()
    same = sum(bool(torch.equal(assemble_chunks(binned, chunk_src, chunk_dst, ch, out_rows), assembled))
               for _ in range(200))
    require(same == 200, f"assemble_chunks: {200 - same} of 200 repeats differ from the first")
    repeats = dict(n=200, bit_equal=same, seconds=time.perf_counter() - t)
    covered = torch.zeros(out_rows // ch, dtype=torch.bool, device=DEV)
    covered[chunk_dst.long()] = True
    require(not bool(assembled.view(out_rows // ch, -1)[~covered].any()),
            "rows no chunk writes must be zero")
    width = ch * 128
    lib_out = torch.zeros(out_rows // ch, width, device=DEV)
    cs64, cd64 = chunk_src.long(), chunk_dst.long()
    n_steps, distinct = chunk_src.numel(), int(torch.unique(chunk_src).numel())
    # each distinct input chunk read once, each output row written once,
    # the two chunk id arrays read once
    b_ms, b_by = bound(distinct * width * 4 + out_rows * 128 * 4 + 8 * n_steps, 0)
    out["assemble_chunks"] = dict(
        max_abs_err=0.0, tol="bit-equal to the plain version; uncovered rows zero",
        shape=dict(binned_rows=rows, chunk_rows=ch, steps=n_steps, distinct_chunks=distinct,
                   out_rows=out_rows, part_fill=ASSEMBLE_PART_FILL),
        ms=median_ms(lambda: assemble_chunks(binned, chunk_src, chunk_dst, ch, out_rows), 20),
        plain_ms=median_ms(
            lambda: assemble_chunks_reference(binned, chunk_src, chunk_dst, ch, out_rows), 20),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=median_ms(
            lambda: lib_out.index_copy_(0, cd64, binned.view(-1, width).index_select(0, cs64)), 20),
        **back_to_back(
            lambda: assemble_chunks(binned, chunk_src, chunk_dst, ch, out_rows),
            lambda: lib_out.index_copy_(0, cd64, binned.view(-1, width).index_select(0, cs64)), 20),
        repeats=repeats,
        split=assemble_split(binned, chunk_src, chunk_dst, ch, out_rows),
    )
    timing = ("ms", "back_to_back_ms", "plain_ms", "bound_ms", "library_ms")
    log(f"scan/assemble path (E={e}, {n_steps} chunk steps): checks ok, "
        f"{json.dumps({k: {t: m.get(t) for t in timing} for k, m in out.items()})}")
    return dict(seconds=seconds, launches=launches, kernels=out)


# ------------------------------------------------- sampling path


def sorted_edge_keys(adj):
    """src * V + dst of every CSR edge, int64, sorted (the CSR is sorted by
    (src, dst))."""
    return adj.majors.long() * adj.num_minors + adj.minors.long()


def edge_multiplicity(keys, src, dst, width):
    """How many parallel edges (src, dst) the sorted keys hold, and the
    first of them."""
    probe = src.long() * width + dst.long()
    lo = torch.searchsorted(keys, probe)
    return torch.searchsorted(keys, probe, right=True) - lo, lo


def weights_match(adj, lo, mult, w) -> bool:
    """Each w is the weight of one of its parallel edges lo .. lo + mult."""
    match = torch.zeros_like(w, dtype=torch.bool)
    for k in range(int(mult.max()) if mult.numel() else 0):
        match |= (k < mult) & (adj.weights[(lo + k).clamp(max=adj.num_edges - 1)] == w)
    return bool(match.all())


def check_neighbor_sample(g, starts, per_hop, compressed, with_replacement) -> dict:
    """Every sampled edge is an edge; without replacement no row takes an
    (src, dst) more often than the CSR holds it; a row of degree <= K takes
    exactly its edges, slot i edge i; each hop's count follows from the
    frontier's degrees; the compressed dict is the valid slots in order."""
    adj = g.csr()
    keys = sorted_edge_keys(adj)
    deg = adj.degrees().long()
    frontier = starts.long()
    counts = []
    for hop, (srcs, dsts, w, valid) in enumerate(per_hop):
        n, k = dsts.shape
        require(torch.equal(srcs[valid].long(), frontier[:, None].expand(n, k)[valid]),
                f"hop {hop}: a slot's source is not its frontier vertex")
        mult, lo = edge_multiplicity(keys, srcs[valid], dsts[valid], adj.num_minors)
        require(bool((mult > 0).all()), f"hop {hop}: a sampled edge is not in the graph")
        require(weights_match(adj, lo, mult, w[valid]), f"hop {hop}: sampled weights are not the edges'")
        fdeg = torch.where(frontier >= 0, deg[frontier.clamp(min=0)], 0)
        want = torch.where(fdeg > 0, k, 0) if with_replacement else fdeg.clamp(max=k)
        require(torch.equal(valid.sum(1), want), f"hop {hop}: slots per vertex != min(deg, K)")
        if not with_replacement:
            # no (row, dst) more often than the row's parallel edges to dst
            row = torch.arange(n, device=DEV)[:, None].expand(n, k)[valid]
            pair, times = torch.unique(row * adj.num_minors + dsts[valid].long(), return_counts=True)
            m, _ = edge_multiplicity(keys, frontier[pair // adj.num_minors],
                                     pair % adj.num_minors, adj.num_minors)
            require(bool((times <= m).all()), f"hop {hop}: a slot repeats an edge")
            small = (fdeg > 0) & (fdeg <= k)
            slot = torch.arange(k, device=DEV)[None, :]
            eidx = adj.offsets[frontier.clamp(min=0)].long()[:, None] + slot
            take = small[:, None] & (slot < fdeg[:, None])
            require(torch.equal(dsts[take], adj.minors[eidx[take]]),
                    f"hop {hop}: a vertex of degree <= K did not take exactly its edges")
        counts.append(int(valid.sum()))
        frontier = torch.where(valid, dsts, -1).reshape(-1).long()
    hop = compressed["hop"]
    require([int((hop == h).sum()) for h in range(len(per_hop))] == counts,
            "compressed hop counts differ from the valid slots")
    for key, i in (("sources", 0), ("destinations", 1), ("weights", 2)):
        want = torch.cat([p[i][p[3]] for p in per_hop])
        require(torch.equal(compressed[key], want), f"compressed {key} are not the valid slots")
    return dict(edges_by_hop=counts)


def check_all_neighbors(g, starts, got, fanouts) -> dict:
    """Compressed fanouts ending in -1: each hop of fanout K takes min(deg,
    K) edges of each vertex of its frontier (the starts, then the hop
    before's destinations); the last hop is, for each destination of the
    hop before in order, exactly its out-edges: as many slots as its
    degree, each an edge with its weight, none more often than the CSR
    holds it."""
    adj = g.csr()
    keys = sorted_edge_keys(adj)
    deg = adj.degrees().long()
    hop, src, dst, w = got["hop"], got["sources"], got["destinations"], got["weights"]
    last = len(fanouts) - 1
    require(bool((hop[1:] >= hop[:-1]).all()) and int(hop.max()) == last, "hops out of order")
    mult, lo = edge_multiplicity(keys, src, dst, adj.num_minors)
    require(bool((mult > 0).all()), "fanout -1: a sampled edge is not in the graph")
    require(weights_match(adj, lo, mult, w), "fanout -1: sampled weights are not the edges'")
    frontier, counts = starts.long(), []
    for h, k in enumerate(fanouts[:-1]):
        counts.append(int((hop == h).sum()))
        require(counts[-1] == int(deg[frontier].clamp(max=k).sum()),
                f"hop {h}: slots != min(deg, K) over the frontier")
        frontier = dst[hop == h].long()
    n_last = deg[frontier]
    in_last = hop == last
    require(torch.equal(src[in_last].long(), frontier.repeat_interleave(n_last)),
            "fanout -1: the hop is not each frontier vertex's row in frontier order")
    seg = torch.arange(frontier.numel(), device=DEV).repeat_interleave(n_last)
    pair, times = torch.unique(seg * adj.num_minors + dst[in_last].long(), return_counts=True)
    m, _ = edge_multiplicity(keys, frontier[pair // adj.num_minors], pair % adj.num_minors,
                             adj.num_minors)
    require(bool((times <= m).all()), "fanout -1: a row repeats an edge")
    counts.append(int(n_last.sum()))
    return dict(edges_by_hop=counts, frontier=frontier.numel(),
                frontier_max_degree=int(n_last.max()))


def check_walks(g, starts, walks, ws) -> dict:
    """Every step is an edge whose weight the step returns, or -1 after a
    sink, and stays -1; weights are 0 after it."""
    adj = g.csr()
    keys = sorted_edge_keys(adj)
    n, length = ws.shape
    require(walks.shape == (n, length + 1) and torch.equal(walks[:, 0], starts),
            f"walks shape {tuple(walks.shape)} or starts")
    a, b = walks[:, :-1], walks[:, 1:]
    dead = b < 0
    require(bool((dead[:, 1:] >= dead[:, :-1]).all()), "a walk came back after -1")
    require(not bool(ws[dead].any()), "a weight after a walk's end is not 0")
    live = ~dead
    mult, lo = edge_multiplicity(keys, a[live], b[live], adj.num_minors)
    require(bool((mult > 0).all()), "a walk step is not an edge")
    require(weights_match(adj, lo, mult, ws[live]), "a walk's edge weight is not the CSR's")
    return dict(steps=int(live.sum()), ended=int(dead[:, -1].sum()),
                mean_length=float(live.sum(1).double().mean()))


def similarity_reference(g, v1, v2, weighted: bool):
    """Jaccard, Sorensen, overlap and cosine in float64 numpy for the pairs
    (host arrays): np.intersect1d on each pair's neighbour lists, and for
    every pair of one vertex a membership mask (the hub's pairs); weighted:
    a vertex weighs its edges' sum, a set the sum of its members'."""
    import numpy as np

    adj = g.csr()
    off = adj.offsets.cpu().numpy().astype(np.int64)
    nbr = adj.minors.cpu().numpy()
    vw = np.ones(g.num_vertices)
    if weighted:
        vw[:] = 0
        np.add.at(vw, adj.majors.cpu().numpy(), adj.weights.cpu().numpy().astype(np.float64))
    prefix = np.concatenate([[0.0], np.cumsum(vw[nbr])])
    size = prefix[off[1:]] - prefix[off[:-1]]  # the weight of each neighbour set
    inter = np.zeros(len(v1))
    hub_rows = {}
    for i, (x, y) in enumerate(zip(v1.tolist(), v2.tolist())):
        for h, o in ((x, y), (y, x)):
            if off[h + 1] - off[h] > 4096:  # a hub: one mask for all its pairs
                if h not in hub_rows:
                    hub_rows[h] = np.zeros(g.num_vertices, bool)
                    hub_rows[h][nbr[off[h]:off[h + 1]]] = True
                common = nbr[off[o]:off[o + 1]][hub_rows[h][nbr[off[o]:off[o + 1]]]]
                break
        else:
            common = np.intersect1d(nbr[off[x]:off[x + 1]], nbr[off[y]:off[y + 1]])
        inter[i] = vw[common].sum()
    a, b = size[v1], size[v2]
    with np.errstate(divide="ignore", invalid="ignore"):
        out = {"jaccard": inter / (a + b - inter), "sorensen": 2 * inter / (a + b),
               "overlap": inter / np.minimum(a, b), "cosine": inter / np.sqrt(a * b)}
    return {k: np.nan_to_num(v, nan=0.0, posinf=0.0) for k, v in out.items()}


def check_similarity(g, results, weighted: bool, seed: int) -> dict:
    """Each coefficient over the default pairs against float64 numpy on
    SIMILARITY_PAIRS seeded pairs and every pair of the highest-degree
    vertex."""
    import numpy as np

    v1, v2, _ = next(iter(results.values()))
    require(bool((v1 < v2).all()), "default pairs are not u < v")
    adj = g.csr()
    loops = int((adj.majors == adj.minors).sum())
    require(v1.numel() == (adj.num_edges - loops) // 2, "default pairs are not every edge once")
    rng = np.random.default_rng(seed)
    hub = int(torch.argmax(adj.degrees()))
    pick = np.unique(np.concatenate([
        rng.choice(v1.numel(), SIMILARITY_PAIRS, replace=False),
        torch.nonzero((v1 == hub) | (v2 == hub)).squeeze(1).cpu().numpy()]))
    a, b = v1.cpu().numpy()[pick], v2.cpu().numpy()[pick]
    ref = similarity_reference(g, a, b, weighted)
    out = dict(pairs=v1.numel(), checked=len(pick), hub=hub, hub_degree=int(adj.degrees()[hub]))
    for kind, (r1, r2, c) in results.items():
        require(torch.equal(r1, v1) and torch.equal(r2, v2), f"{kind}: pairs differ")
        got = c.cpu().numpy()[pick].astype(np.float64)
        err = np.abs(got - ref[kind])
        if weighted:
            bad = err > TOL_SIMILARITY_W_REL * np.abs(ref[kind])
        else:
            bad = err > TOL_SIMILARITY_ABS
        require(not bad.any(), f"{kind} (weighted={weighted}): {int(bad.sum())} pairs off, "
                f"max error {err.max()}")
        out[kind] = dict(max_abs_err=float(err.max()), mean=float(c.double().mean()))
    return out


def check_all_pairs(g, result, seed: int) -> dict:
    """all_pairs_similarity's pairs are exactly the two-hop pairs u < v
    (scipy A @ A), and its Jaccard holds against float64 numpy on a seeded
    sample."""
    import numpy as np
    import scipy.sparse as sp

    adj = g.csr()
    v = g.num_vertices
    m = sp.csr_matrix((np.ones(adj.num_edges), adj.minors.cpu().numpy(),
                       adj.offsets.cpu().numpy()), shape=(v, v))
    two = (m @ m).tocoo()
    keep = two.row < two.col
    want = np.unique(two.row[keep].astype(np.int64) * v + two.col[keep])
    v1, v2, c = result
    got = v1.long().cpu().numpy() * v + v2.long().cpu().numpy()
    require(np.array_equal(got, want), "all_pairs_similarity pairs are not the two-hop pairs")
    pick = np.random.default_rng(seed).choice(len(got), min(2048, len(got)), replace=False)
    ref = similarity_reference(g, v1.cpu().numpy()[pick], v2.cpu().numpy()[pick], False)["jaccard"]
    err = np.abs(c.cpu().numpy()[pick] - ref)
    require(err.max() <= TOL_SIMILARITY_ABS, f"all_pairs_similarity error {err.max()}")
    return dict(pairs=len(got), max_abs_err=float(err.max()))


def mg_rmat_ingest(scale: int, seed: int) -> dict:
    """mg_rmat_edgelist -> rmat_chunk_source -> distribute_edgelist_chunks
    on a 1 x 1 mesh over NCCL (gloo where DEV is the CPU): the rank's
    in_block equals a CSC of the shards built here in numpy (a stable sort
    by (dst, src), offsets from a bincount)."""
    import numpy as np
    import torch.distributed as dist

    import cugraph_tpu_torch as ct
    from cugraph_tpu_torch.dist import initialize_distributed, make_mesh
    from cugraph_tpu_torch.dist.mg_graph import distribute_edgelist_chunks

    v = 1 << scale
    initialize_distributed(device=DEV, init_method=f"tcp://127.0.0.1:{free_port()}",
                           world_size=1, rank=0)
    try:
        mesh = make_mesh((1, 1), device=DEV)
        shards = ct.mg_rmat_edgelist(mesh, scale, 16 * v, seed=seed, scramble=True)
        t = time.perf_counter()
        mgg = distribute_edgelist_chunks(mesh, ct.rmat_chunk_source(shards), num_vertices=v)
        sync()
        seconds = time.perf_counter() - t
    finally:
        dist.destroy_process_group()
    src, dst = (torch.cat(a).cpu().numpy().astype(np.int64)
                for a in zip(*ct.rmat_chunk_source(shards)()))
    order = np.lexsort((src, dst))
    want = dict(offsets=np.concatenate([[0], np.cumsum(np.bincount(dst, minlength=v))]),
                minors=src[order], majors=dst[order])
    for key, ref in want.items():
        got = getattr(mgg.in_block, key).cpu().numpy()
        require(np.array_equal(got, ref), f"mg_rmat in_block.{key} differs from the numpy CSC "
                "of the shards")
    return dict(seconds=seconds, shards=len(shards), edges=mgg.num_edges)


def sampling_path(g, small_scale: int, seed: int) -> dict:
    """Neighbor sampling and random walks on the weighted s21 graph (the
    main path's edges), link prediction on the symmetrized RMAT graph at
    ``small_scale`` (unweighted and weighted), all-pairs similarity at
    scale 10 and the MG R-MAT ingest at ``small_scale``: each phase with
    the launch counters set to 0 just before and read just after, and an
    independent check."""
    import cugraph_tpu_torch as ct
    from cugraph_tpu_torch.prims.cuda import (
        assemble_chunks,
        cumsum_flat,
        spmm_rows,
        spmv_minplus,
        spmv_sum,
    )

    counters = {"spmv_sum": spmv_sum, "spmv_minplus": spmv_minplus, "spmm_rows": spmm_rows,
                "cumsum_flat": cumsum_flat, "assemble_chunks": assemble_chunks}
    torch.cuda.reset_peak_memory_stats()
    v = g.num_vertices
    gen = torch.Generator(device=DEV).manual_seed(seed + 8)
    starts = torch.randint(0, v, (SAMPLE_STARTS,), generator=gen, device=DEV, dtype=torch.int32)
    walkers = torch.randint(0, v, (WALKERS,), generator=gen, device=DEV, dtype=torch.int32)
    s_src, s_dst, s_v = rmat_edges(small_scale, seed)
    wgen = torch.Generator(device=DEV).manual_seed(seed + 9)
    gs = ct.from_edgelist(s_src, s_dst, num_vertices=s_v, symmetrize=True, device=DEV)
    gsw = ct.from_edgelist(s_src, s_dst, 1.0 - torch.rand(s_src.numel(), generator=wgen, device=DEV),
                           num_vertices=s_v, symmetrize=True, device=DEV)
    t_src, t_dst, t_v = rmat_edges(10, seed)
    g10 = ct.from_edgelist(t_src, t_dst, num_vertices=t_v, symmetrize=True, device=DEV)

    def sample(replace, compress=True):
        return ct.uniform_neighbor_sample(
            g, starts, SAMPLE_FANOUTS, with_replacement=replace, compress=compress,
            generator=torch.Generator(device=DEV).manual_seed(seed + 10))

    def walk_gen():
        return torch.Generator(device=DEV).manual_seed(seed + 11)

    kinds = ("jaccard", "sorensen", "overlap", "cosine")
    phases = {
        "neighbor_sample": lambda: sample(False),
        "neighbor_sample_replace": lambda: sample(True),
        "neighbor_sample_all": lambda: ct.uniform_neighbor_sample(
            g, starts, SAMPLE_ALL_FANOUTS, generator=torch.Generator(device=DEV).manual_seed(seed)),
        "random_walks": lambda: ct.random_walks(g, walkers, WALK_LENGTH, generator=walk_gen()),
        "biased_walks": lambda: ct.random_walks(g, walkers, WALK_LENGTH, biased=True,
                                                generator=walk_gen()),
        "node2vec": lambda: ct.node2vec(g, walkers, WALK_LENGTH, p=NODE2VEC_P, q=NODE2VEC_Q,
                                        generator=walk_gen()),
        "similarity": lambda: {k: getattr(ct, k)(gs) for k in kinds},
        "similarity_weighted": lambda: {k: getattr(ct, k)(gsw, use_weight=True) for k in kinds},
        "all_pairs_similarity": lambda: ct.all_pairs_similarity(g10, "jaccard"),
        "all_pairs_topk": lambda: ct.all_pairs_similarity(g10, "jaccard", topk=100),
        "mg_rmat_ingest": lambda: mg_rmat_ingest(small_scale, seed),
    }
    seconds, launches, results = {}, {}, {}
    for name, fn in phases.items():
        for c in counters.values():
            c.launches = 0
        t = time.perf_counter()
        results[name] = fn()
        sync()
        seconds[name] = time.perf_counter() - t
        launches[name] = {n: c.launches for n, c in counters.items()}
    log(f"sampling path seconds: {json.dumps(seconds)}")
    log(f"sampling path launches: {json.dumps(launches)}")
    out = dict(seconds=seconds, launches=launches)

    for name, replace in (("neighbor_sample", False), ("neighbor_sample_replace", True)):
        per_hop = sample(replace, compress=False)  # the same draws, padded
        out[name] = check_neighbor_sample(g, starts, per_hop, results[name], replace)
    out["neighbor_sample_all"] = check_all_neighbors(g, starts, results["neighbor_sample_all"],
                                                     SAMPLE_ALL_FANOUTS)
    for name in ("random_walks", "biased_walks", "node2vec"):
        out[name] = check_walks(g, walkers, *results[name])
    out["similarity"] = check_similarity(gs, results["similarity"], False, seed)
    out["similarity_weighted"] = check_similarity(gsw, results["similarity_weighted"], True, seed)
    out["all_pairs_similarity"] = check_all_pairs(g10, results["all_pairs_similarity"], seed)
    top = results["all_pairs_topk"]
    full_c = results["all_pairs_similarity"][2]
    require(torch.equal(top[2], torch.sort(full_c, descending=True, stable=True).values[:100]),
            "all_pairs_similarity topk is not the largest coefficients")
    out["mg_rmat_ingest"] = results["mg_rmat_ingest"]
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    log(f"sampling path checks: {json.dumps({k: out[k] for k in out if k not in ('seconds', 'launches')})}")
    del phases["mg_rmat_ingest"]  # its process group is gone
    out["warm"] = warm_breakdown(phases)
    return out


# ------------------------------------------------------- community path


def degree_probe_triangles(g, budget: int = 1 << 24):
    """Per-vertex triangles and per-edge common-neighbour counts of a
    symmetric graph by another method than the port's: for every stored
    edge (v, u), u != v, the neighbours of its smaller-degree end are
    looked up in the other end's sorted list (no orientation, no DAG;
    self-loops are no neighbours). t(v) = (sum over v's edges of the
    counts) / 2."""
    adj = g.csr()
    v = g.num_vertices
    offsets = adj.offsets.long()
    s, d = adj.majors.long(), adj.minors.long()
    keys = s * v + d  # sorted, like the CSR
    deg = offsets[1:] - offsets[:-1]
    swap = deg[d] < deg[s]
    a, b = torch.where(swap, d, s), torch.where(swap, s, d)  # probe a's list in b's
    count = torch.where(s != d, deg[a], 0)
    cum = torch.cumsum(count, 0)
    common = torch.zeros(adj.num_edges, dtype=torch.int64, device=DEV)
    e0 = 0
    while e0 < adj.num_edges:
        base = int(cum[e0 - 1]) if e0 else 0
        e1 = int(torch.searchsorted(cum, base + budget, right=True))
        e1 = max(e1, e0 + 1)
        n = int(cum[e1 - 1]) - base
        edge = torch.repeat_interleave(torch.arange(e0, e1, device=DEV), count[e0:e1],
                                       output_size=n)
        j = torch.arange(n, device=DEV) - (cum[edge] - count[edge] - base)
        x = d[offsets[a[edge]] + j]
        probe = b[edge] * v + x
        pos = torch.searchsorted(keys, probe).clamp(max=adj.num_edges - 1)
        # a self-loop on either end is no common neighbour
        hit = (keys[pos] == probe) & (x != a[edge]) & (x != b[edge])
        common.index_add_(0, edge, hit.long())
        e0 = e1
    tri = torch.zeros(v, dtype=torch.int64, device=DEV).index_add_(0, s, common)
    return tri // 2, common


def hindex_cores(g, max_rounds: int = 1000):
    """Core numbers of core_number(g, "incoming_outgoing") by another method
    than the port's peeling: the h-index operator iterated from the degrees
    (Lü et al., Nat. Commun. 2016). Degree counts as core_number does: the
    incidences of v are its out-edges over the CSR plus its in-edges over
    the CSC. Each round sets c(v) to the largest h such that at least h of
    v's incidences lead to a u with c(u) >= h, by one sort of packed
    (v, -c(u)) keys; from the degrees the sequence falls to the core
    numbers, the greatest fixed point, and stops there. Returns (cores,
    rounds)."""
    lists = [(adj.majors.long(), adj.minors.long()) for adj in (g.csr(), g.csc())]
    me, order = torch.sort(torch.cat([m for m, _ in lists]), stable=True)
    nb = torch.cat([n for _, n in lists])[order]
    del lists, order
    deg = torch.bincount(me, minlength=g.num_vertices)
    end = torch.cumsum(deg, 0)
    start = end - deg
    rank = torch.arange(me.numel(), device=DEV) - start[me] + 1  # 1-based within v's incidences
    top = (1 << 31) - 1
    c = deg
    for rounds in range(1, max_rounds + 1):
        ranked = top - (torch.sort((me << 32) | (top - c[nb])).values & top)  # c(u) descending per v
        hits = torch.cat([deg.new_zeros(1), torch.cumsum((ranked >= rank).long(), 0)])
        h = hits[end] - hits[start]
        if torch.equal(h, c):
            return c, rounds
        c = h
    raise RuntimeError(f"check failed: h-index cores did not settle in {max_rounds} rounds")


def check_cores(g, core) -> dict:
    """core_number(g, "incoming_outgoing") against both core invariants,
    counting degree as it does (each v has at least core(v) incidences to
    vertices whose core is at least its own, and fewer than core(v) + 1 to
    those whose core is above it: necessary, not sufficient, as all zeros
    pass), and equal to hindex_cores(g)."""
    ge = torch.zeros(g.num_vertices, dtype=torch.int64, device=DEV)
    gt = torch.zeros_like(ge)
    for adj in (g.csr(), g.csc()):
        me, nb = adj.majors.long(), adj.minors.long()
        ge.index_add_(0, me, (core[nb] >= core[me]).long())
        gt.index_add_(0, me, (core[nb] > core[me]).long())
    c = core.long()
    require(bool((ge >= c).all()), "a vertex has fewer than core(v) neighbours of core >= core(v)")
    require(bool((gt < c + 1).all()), "a vertex has core(v) + 1 neighbours of core > core(v)")
    del ge, gt
    ref, rounds = hindex_cores(g)
    require(torch.equal(core.long(), ref), "core numbers differ from the h-index cores")
    return dict(max_core=int(core.max()), hindex_rounds=rounds)


def modularity64(g, labels) -> float:
    """Modularity in float64 from the edge list (resolution 1)."""
    csr = g.csr()
    lab = labels.long()
    w = torch.ones(csr.num_edges, dtype=torch.float64, device=DEV) if csr.weights is None \
        else csr.weights.double()
    k = torch.zeros(g.num_vertices, dtype=torch.float64, device=DEV).index_add_(0, csr.majors, w)
    m2 = k.sum()
    intra = (w * (lab[csr.majors.long()] == lab[csr.minors.long()])).sum()
    sigma = torch.zeros_like(k).index_add_(0, lab, k)
    return float(intra / m2 - ((sigma / m2) ** 2).sum())


def community_path(scale: int, small_scale: int, seed: int) -> dict:
    """WCC, SCC, core number, k-core, Louvain, modularity, the clustering
    metrics, Leiden and the ego graph on the symmetrized RMAT graph at
    ``scale`` (SCC on the directed one); triangle count, k-truss and ECG at
    ``small_scale``; the spectral clusterings at scale 10. Each phase with
    its launch counters set to 0 just before and read just after, and an
    independent reference."""
    import numpy as np
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    import cugraph_tpu_torch as ct
    from cugraph_tpu_torch.prims.cuda import (
        assemble_chunks,
        cumsum_flat,
        spmm_rows,
        spmv_minplus,
        spmv_sum,
    )

    counters = {"spmv_sum": spmv_sum, "spmv_minplus": spmv_minplus, "spmm_rows": spmm_rows,
                "cumsum_flat": cumsum_flat, "assemble_chunks": assemble_chunks}
    torch.cuda.reset_peak_memory_stats()
    seconds, launches, results = {}, {}, {}

    t = time.perf_counter()
    src, dst, v = rmat_edges(scale, seed)
    g_dir = ct.from_edgelist(src, dst, num_vertices=v, device=DEV)
    g = ct.from_edgelist(src, dst, num_vertices=v, symmetrize=True, device=DEV)
    del src, dst
    sync()
    seconds["graph"] = time.perf_counter() - t
    small = {}
    for s_ in (small_scale, 10):
        s_src, s_dst, s_v = rmat_edges(s_, seed)
        small[s_] = ct.from_edgelist(s_src, s_dst, num_vertices=s_v, symmetrize=True, device=DEV)
    log(f"community graphs: s{scale} V={v} E directed {g_dir.num_edges}, symmetrized "
        f"{g.num_edges}; s{small_scale} E {small[small_scale].num_edges}; s10 E {small[10].num_edges}")

    def run(name, fn):
        for c in counters.values():
            c.launches = 0
        t = time.perf_counter()
        results[name] = fn()
        sync()
        seconds[name] = time.perf_counter() - t
        launches[name] = {n: c.launches for n, c in counters.items()}

    gs = small[small_scale]

    # later phases read earlier results when they run
    def core_k():
        return int(results["core_number"].max())

    def louvain_labels():
        return results["louvain"][0]

    phases = {
        "wcc": lambda: ct.weakly_connected_components(g),
        "scc": lambda: ct.strongly_connected_components(g_dir),
        "core_number": lambda: ct.core_number(g, "incoming_outgoing"),
        "k_core": lambda: ct.k_core(g, core_k(), results["core_number"]),
        "louvain": lambda: ct.louvain(g),
        "modularity": lambda: ct.modularity(g, louvain_labels()),
        "analyze": lambda: (ct.analyze_clustering_modularity(g, louvain_labels()),
                            ct.analyze_clustering_edge_cut(g, louvain_labels()),
                            ct.analyze_clustering_ratio_cut(g, louvain_labels())),
        "leiden": lambda: ct.leiden(g),
        "ego_graph": lambda: ct.ego_graph(g, 0, 1),
        "triangle_count": lambda: ct.triangle_count(gs),
        "ktruss": lambda: ct.ktruss(gs, KTRUSS_K),
        "ecg": lambda: ct.ecg(gs, seed=seed),
        "spectral_balanced_cut": lambda: ct.spectral_balanced_cut_clustering(small[10], 4),
        "spectral_modularity": lambda: ct.spectral_modularity_maximization_clustering(small[10], 4),
    }
    for name, fn in phases.items():
        run(name, fn)
        if name == "core_number":
            core_rounds = ct.core_number.rounds
    log(f"community path seconds: {json.dumps(seconds)}")
    log(f"community path launches: {json.dumps(launches)}")
    require(launches["ego_graph"]["spmv_minplus"] > 0, "ego_graph's bfs must launch spmv_minplus")
    out = dict(seconds=seconds, launches=launches, num_edges_symmetrized=g.num_edges,
               num_edges_directed=g_dir.num_edges, small_scale=small_scale,
               small_num_edges=gs.num_edges)

    # WCC: equal to scipy's components, each labelled by its smallest id
    csr = g.csr()
    m = sp.csr_matrix((np.ones(csr.num_edges, np.int8),
                       csr.minors.cpu().numpy(), csr.offsets.cpu().numpy()), shape=(v, v))
    n_comp, raw = connected_components(m, directed=False)
    first = np.full(n_comp, v, np.int64)
    np.minimum.at(first, raw, np.arange(v))
    wcc = results["wcc"]
    require(np.array_equal(wcc.cpu().numpy(), first[raw]), "wcc differs from scipy's components")
    out["wcc"] = dict(components=int(n_comp))

    # SCC: equal to scipy's strong components of the directed graph, each
    # labelled by its smallest id, and a refinement of the WCC labels
    dcsr = g_dir.csr()
    m = sp.csr_matrix((np.ones(dcsr.num_edges, np.int8),
                       dcsr.minors.cpu().numpy(), dcsr.offsets.cpu().numpy()), shape=(v, v))
    n_scc, raw = connected_components(m, directed=True, connection="strong")
    first = np.full(n_scc, v, np.int64)
    np.minimum.at(first, raw, np.arange(v))
    scc = results["scc"].long()
    require(np.array_equal(scc.cpu().numpy(), first[raw]), "scc differs from scipy's strong components")
    require(int(torch.unique(scc).numel()) == n_scc, "scc component count differs from scipy's")
    require(torch.equal(wcc[scc], wcc), "scc labels do not refine the wcc labels")
    out["scc"] = dict(components=int(n_scc))

    # core number: both invariants; k-core: the vertices of largest core
    core, kmax = results["core_number"], core_k()
    out["core_number"] = check_cores(g, core)
    out["core_number"]["rounds"] = core_rounds
    sub, vmap = results["k_core"]
    require(torch.equal(vmap.long(), torch.nonzero(core >= kmax).squeeze(1)), "k_core vertices")
    require(bool((sub.out_degrees() + sub.in_degrees() >= kmax).all()),
            "a k_core vertex has in + out degree below k inside the k-core")
    out["k_core"] = dict(k=kmax, vertices=sub.num_vertices, edges=sub.num_edges)

    # Louvain and Leiden: the returned modularity against float64, and a
    # clustering that beats the singletons by a margin, in more than one
    # community
    q_single = modularity64(g, torch.arange(v, device=DEV))
    for name in ("louvain", "leiden"):
        lab_, q_ = results[name]
        n_comm = int(torch.unique(lab_).numel())
        require(q_ > q_single + MODULARITY_GAIN and 1 < n_comm < v,
                f"{name}: modularity {q_} over {n_comm} communities, singletons {q_single}")
    labels, q = results["louvain"]
    q64 = modularity64(g, labels)
    lq_err = abs(q - q64)
    require(lq_err <= TOL_MODULARITY, f"louvain modularity {q} vs float64 {q64}")
    require(abs(results["modularity"] - q64) <= TOL_MODULARITY, "modularity vs float64")
    a_mod, a_cut, a_ratio = results["analyze"]
    require(abs(a_mod - q64) <= TOL_MODULARITY, "analyze_clustering_modularity vs float64")
    lab = labels.long()
    cross = lab[csr.majors.long()] != lab[csr.minors.long()]
    cut64 = float(cross.sum()) / 2
    require(abs(a_cut - cut64) <= TOL_SUM_REL * cut64, f"edge cut {a_cut} vs {cut64}")
    sizes = torch.bincount(lab).double()
    cut_per = torch.bincount(lab[csr.majors.long()][cross], minlength=sizes.numel()).double()
    ratio64 = float((cut_per / sizes.clamp(min=1)).sum())
    require(abs(a_ratio - ratio64) <= 1e-9 * ratio64, f"ratio cut {a_ratio} vs {ratio64}")
    out["louvain"] = dict(modularity=q, modularity64=q64, abs_err=lq_err, singletons64=q_single,
                          communities=int(torch.unique(lab).numel()),
                          edge_cut=a_cut, ratio_cut=a_ratio)
    l_labels, l_q = results["leiden"]
    l_q64 = modularity64(g, l_labels)
    require(abs(l_q - l_q64) <= TOL_MODULARITY, f"leiden modularity {l_q} vs float64 {l_q64}")
    out["leiden"] = dict(modularity=l_q, modularity64=l_q64, abs_err=abs(l_q - l_q64),
                         communities=int(torch.unique(l_labels).numel()))

    # ego graph: vertex 0 and its neighbours, and the edges among them
    esub, emap = results["ego_graph"]
    nbrs = torch.unique(torch.cat([csr.minors[csr.offsets[0]:csr.offsets[1]].long(),
                                   torch.zeros(1, dtype=torch.long, device=DEV)]))
    require(torch.equal(emap.long(), nbrs), "ego_graph vertices are not vertex 0's neighbourhood")
    inside = torch.zeros(v, dtype=torch.bool, device=DEV)
    inside[nbrs] = True
    want_e = int((inside[csr.majors.long()] & inside[csr.minors.long()]).sum())
    require(esub.num_edges == want_e, f"ego_graph has {esub.num_edges} edges, want {want_e}")
    out["ego_graph"] = dict(vertices=esub.num_vertices, edges=esub.num_edges)

    # triangles at the small scale against the min-degree probe
    tri_ref, _ = degree_probe_triangles(gs)
    tri = results["triangle_count"]
    require(torch.equal(tri.long(), tri_ref), "triangle counts differ from the probe count")
    out["triangle_count"] = dict(triangles=int(tri_ref.sum()) // 3, max_per_vertex=int(tri.max()))

    # k-truss: every edge of the result closes at least k - 2 triangles in
    # it, and the result is a subgraph of the input
    kt = results["ktruss"]
    _, common = degree_probe_triangles(kt)
    kcsr = kt.csr()
    loops = kcsr.majors == kcsr.minors
    require(bool((common[~loops] >= KTRUSS_K - 2).all()), "a k-truss edge has too little support")
    gkeys = gs.csr().majors.long() * gs.num_vertices + gs.csr().minors.long()
    kkeys = kcsr.majors.long() * gs.num_vertices + kcsr.minors.long()
    pos = torch.searchsorted(gkeys, kkeys).clamp(max=gkeys.numel() - 1)
    require(bool((gkeys[pos] == kkeys).all()), "k-truss edge not in the graph")
    out["ktruss"] = dict(k=KTRUSS_K, edges=kt.num_edges,
                         min_support=int(common[~loops].min()) if kt.num_edges else None)

    # ECG: the returned modularity is that of its labels on the reweighted
    # graph, which is not recomputed here; the labels' modularity on the
    # graph itself is recorded
    e_labels, e_q = results["ecg"]
    require(e_labels.shape == (gs.num_vertices,) and 0 <= e_q <= 1, "ecg result")
    out["ecg"] = dict(modularity_reweighted=e_q, modularity64=modularity64(gs, e_labels),
                      communities=int(torch.unique(e_labels).numel()))

    for name in ("spectral_balanced_cut", "spectral_modularity"):
        lab10 = results[name]
        require(lab10.shape == (small[10].num_vertices,) and set(lab10.tolist()) <= set(range(4)),
                f"{name} labels")
        out[name] = dict(modularity64=modularity64(small[10], lab10))
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    log(f"community path checks: {json.dumps({n: out[n] for n in out if n not in ('seconds', 'launches')})}")
    out["warm"] = warm_breakdown(phases)
    return out


# ----------------------------------------------------------------- main

SOURCES = {
    "spmv_sum": ("cugraph_tpu_torch/csrc/spmv.cu", "cugraph_tpu/prims/pallas/spmv3.py:862"),
    "spmv_minplus": ("cugraph_tpu_torch/csrc/spmv.cu", "cugraph_tpu/prims/pallas/spmv2.py:1675"),
    "spmm_rows": ("cugraph_tpu_torch/csrc/spmm_row.cu", "cugraph_tpu/prims/pallas/spmm_row.py:225"),
    "cumsum_flat": ("cugraph_tpu_torch/csrc/scan.cu", "cugraph_tpu/prims/pallas/scan.py:41"),
    "assemble_chunks": ("cugraph_tpu_torch/csrc/assemble.cu",
                        "cugraph_tpu/prims/pallas/spmv2.py:1605"),
}
ALSO_REPLACES = {
    "spmv_sum": [
        "cugraph_tpu/prims/pallas/spmv2.py:1507",
        "cugraph_tpu/prims/pallas/spmv2.py:1582",
        "cugraph_tpu/prims/pallas/spmv.py:194",
        "cugraph_tpu/prims/pallas/spmv2.py:1675",
    ],
    "spmv_minplus": [
        "cugraph_tpu/prims/pallas/spmv3.py:944",
        "cugraph_tpu/prims/pallas/spmv2.py:1507",
        "cugraph_tpu/prims/pallas/spmv2.py:1582",
    ],
    "spmm_rows": [
        "cugraph_tpu/prims/pallas/spmv2.py:1934",
        "cugraph_tpu/prims/pallas/spmv2.py:1989",
        "cugraph_tpu/prims/pallas/spmv2.py:2017",
    ],
    "cumsum_flat": ["cugraph_tpu/prims/pallas/scan.py:59"],
    "assemble_chunks": [],
}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--scale", type=int, default=21, help="RMAT scale (default 21)")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    # float32 matmuls (the GraphSAGE linear layers and their reference) in
    # full f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 2. build
    from cugraph_tpu_torch.prims.cuda import build

    log(f"build: {build.build():.1f} s for {', '.join(build.SOURCES)}")
    for name in build.SOURCES:
        for line in build.compiler_report(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # 3. kernels against their plain versions
    t = time.perf_counter()
    small_graph_checks(args.seed)
    g = rmat_graph(args.scale, args.seed)
    kernels = full_shape_kernels(g, args.seed)
    del g
    torch.cuda.empty_cache()
    log(f"kernel checks: {time.perf_counter() - t:.1f} s")

    # 4. main path
    path = main_path(args.scale, args.seed)
    torch.cuda.empty_cache()

    # 5. MG path
    mgp = mg_path(args.scale, args.seed)
    torch.cuda.empty_cache()

    # 6. weighted path
    g = rmat_graph(args.scale, args.seed, weighted=True)
    weighted = weighted_full_shape_kernels(g, args.seed)
    wpath = weighted_path(g, args.seed)

    # 7. the entry points of the scan and the chunk assembly, on the
    # weighted graph's CSC weights and the same E
    scan = scan_assemble_path(g, args.seed)

    # 8. sampling and link prediction
    spath = sampling_path(g, min(SMALL_SCALE, args.scale), args.seed)
    del g
    torch.cuda.empty_cache()

    # 9. community path
    cpath = community_path(args.scale, min(SMALL_SCALE, args.scale), args.seed)
    torch.cuda.empty_cache()

    def on_path(name, launches):
        return sum(n.get(name, 0) for n in launches.values())

    lines = []
    for name, m in dict(kernels, **scan["kernels"]).items():
        source, replaces = SOURCES[name]
        if name in scan["launches"]:
            launches = scan["launches"][name]
            by_path = dict(scan_assemble_path=launches)
        else:
            launches = path["launches"][name]
            by_path = dict(main_path=launches, mg_path=mgp["launches"][name],
                           weighted_path=on_path(name, wpath["launches"]),
                           gradient_path=path["gradient"]["launches"].get(name, 0))
        by_path["sampling_path"] = on_path(name, spath["launches"])
        by_path["community_path"] = on_path(name, cpath["launches"])
        extra = {"weighted": weighted[name]} if name in weighted else {}
        if name in mgp["block"]:
            extra["mg_block"] = mgp["block"][name]
        lines.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            also_replaces=ALSO_REPLACES[name], launches=launches,
            launches_by_path=by_path, **m, **extra,
        ))
    log(f"total: {time.perf_counter() - t_start:.1f} s after device setup")
    print(json.dumps({"kernels": lines, "scale": args.scale, "main_path": path,
                      "mg_path": mgp, "weighted_path": wpath, "scan_assemble_path": scan,
                      "sampling_path": spath, "community_path": cpath, "card": smi}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
