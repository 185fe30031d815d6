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
   tile sizes; spmm_rows in its wide layout at F = 128, 101 (one float a
   load) and 200 (a partial second column pass), in its narrow layout's
   F, with x 4 bytes off alignment, and on graphs whose rows close a step
   of the narrow layout's lane groups); the column-segmented SpMV at
   forced widths (K = 2, 3 with an uneven last range, 4, and a range with
   no edge) on the small and adversarial graphs, spmv_sum within
   TOL_SUM_REL and spmv_minplus bit-exact, one launch and K segment passes
   a call; and
   at the main path's shapes: spmv_sum, spmv_minplus, spmm_rows (both
   modes, F = 128, 129 (the wide layout's scalar loads) and 40, and the
   narrow layout at F = 8, 16, 32, 10 in f32 and 8 in bf16), each kernel
   launched twice and bit-equal. Median
   times of single calls and of back-to-back calls; bounds, library
   yardsticks, each tile plan's one-time cost, and an SpMV wrapper's host
   time split into its parts.
3b. Fault path: every entry point that takes vertex ids from its caller
   (pagerank's personalization, the four similarity pairs, the sampler's,
   the walks' and node2vec's starts, extract_bfs_paths' destinations,
   mg_pagerank's personalization on a 1 x 1 NCCL mesh) given an id out of
   range on the card must raise GraphError; modularity gives one Q under
   renamed labels; then spmv_sum and spmv_minplus against their plain
   versions in the same process (the CUDA context survived).
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
   kernel checked and timed on the rank's block. Then mg_extract_bfs_paths
   to 1,024 seeded destinations against extract_bfs_paths, and
   mg_pagerank(gather_mode="ring") bit-equal to "all_gather", both timed
   warm.
6. Weighted path on the same graph with weights in (0, 1]: spmv_sum and
   spmv_minplus checked and timed on its CSC, then katz, eigenvector,
   hits, pagerank(tol=0, 20 iterations), sssp(0), betweenness and edge
   betweenness (k=8, spmm_rows a level), degree centrality and
   extract_bfs_paths, each
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
7b. Probes path: the entry point of the benchmarks/ probes
   (cugraph_tpu_torch.microbench) at the probes' shapes (131,072 rows of
   128; 2,048 tiles of 128 edges into a 32,768-row table) and at two
   ceiling shapes (stream_scale at 2^21 rows, 1 GiB each way; gather_rows
   from a 2^21-row table), launch counters set to 0 just before and read
   just after; then each of stream_scale, gather_rows (f32 and bf16),
   gather_window_sum, multiwin_reduce and seg_scan_rows on small, ragged
   and adversarial inputs and at full shape against its plain version
   (bit-equal, and on relaunch, but for the two kernels that add with
   atomics: within TOL_PROBE_REL of the sum of the terms' |.|), an index
   out of range raising GraphError, bounded, beside x.mul and
   index_select (index_add_ over the window reduce's keys beside it,
   labelled); the kernels' times are the entry point's own, on the same
   inputs; the copy and gather rates on a line of their own.
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
   Then the MG community path on the same symmetrized graph on a 1 x 1
   NCCL mesh: mg_wcc and mg_core_number bit-equal to the single-device
   results, mg_louvain and mg_leiden with Q within TOL_MG_Q of float64
   modularity of their labels, beside the single-device Q.
10. API path: the s21 edges as a pandas frame of sparse int64 ids (id *
   an odd constant mod 2^64) -> api.Graph().from_pandas_edgelist, twice,
   NumberMap.renumber timed apart; its internal ids against
   compute_renumber_map over np.unique's codes, 2^20 ids round-tripped,
   an unknown id raising. The dataframe pagerank, bfs, sssp,
   connected_components, jaccard (2^16 given pairs) and
   uniform_neighbor_sample ([25, 10] from 1,024 starts), each timed first
   and warm (the median of 5, in turns) beside the port's core call on
   G.core, each frame equal to
   the core result through to_external and launching the same kernels.
   Save and load of the s21 graph (bytes, seconds; equal CSR and CSC),
   check_edgelist on its edges with the checks on (an id out of range
   raises); both spanning trees on the weighted symmetrized graph at
   SMALL_SCALE (V - components edges, each a graph edge with its weight;
   the total at scale 12 against networkx's); hungarian on 2,048 x 2,048
   against scipy on a matrix built apart; force_atlas2 (500 iterations)
   on the symmetrized scale-14 graph: finite, its peak memory far under
   the unblocked step's 20 V^2 bytes, its first 3 steps each against a
   float64 step over all pairs, 50 iterations under the profiler.
11. Training path on the main path's unweighted s21 graph:
   examples/train_graphsage.py's loop, NeighborLoader (1,024 seeds a
   batch, fanouts [25, 10], shuffled) -> block -> GraphSAGE(128 -> 128 ->
   16) -> cross-entropy over the seeds -> backward -> Adam(1e-3), 20
   steps, each block above the dense branch, each with spmm_rows launched
   3 times (counters set to 0 just before each step and read just after),
   each block edge a graph edge under n_ids and the seeds first; step 1's
   loss and gradients against float64 autograd through the plain
   versions; 10 steps on one block lower its loss; the median step split
   into its parts, seeds/s, a profiled step's idle share. Then
   make_sage_train_step on its own 1 x 1 NCCL mesh (F = 128 -> 128 -> 64,
   lr 1e-2, 3 steps of 3 spmm_rows launches): step 1's loss and update
   against the single-device autograd step on the card, and spmm_rows
   over the rank's out_block (the backward's product) checked and timed.
12. MG weighted path: the weighted s21 graph on its own 1 x 1 NCCL mesh,
   mg_sssp(0), mg_katz_centrality, mg_eigenvector_centrality and mg_hits,
   each with its launch counts, held against the single-device sssp
   (equal distances and predecessors), katz, eigenvector and hits.
13. MG analytics path on its own 1 x 1 NCCL mesh, each call against the
   port's single-device result on the same graph, counters set to 0 just
   before and read just after each: at SMALL_SCALE, symmetrized and
   weighted, mg_triangle_count (equal per vertex to triangle_count) and
   mg_jaccard, mg_sorensen and mg_overlap, plain and weighted, on 2^16
   seeded pairs (within 1e-6); an MGPropertyGraph of those edges behind a
   GraphStore, sample_neighbors ([10] from 1,024 seeds, "in" and "out"),
   every edge an edge of the frame; at the main scale, weighted:
   mg_uniform_neighbor_sample [25, 10] from 1,024 seeds without and with
   replacement, "replicate" and "shuffle" equal for one generator seed,
   every edge an edge with its weight, min(K, degree) slots a row,
   distinct without replacement; mg_random_walks 2^14 x 80 (every step an
   edge, -1 after a sink); mg_betweenness and mg_edge_betweenness (k = 8)
   within 1e-5 of the single-device ones, with as many spmm_rows launches
   (Brandes' sweeps, the 8 sources one block), and within 1e-4 of the
   float64 reference_brandes. First-call and warm seconds, idle shares,
   peak bytes.
14. Service path: a CugraphTpuServer on localhost over the scale-18 R-MAT
   edges (each once) as a CSV in a temporary directory; PageRank, BFS,
   SSSP, WCC and Katz through CugraphTpuClient, each equal to the port's
   api.algorithms call on a Graph of the same frame and timed beside it;
   distribute_graph([1, 1]) (the handler's own one-rank NCCL group, ended
   by the server's stop), the MG-routed results against the single-device
   ones, and one MG-routed uniform_neighbor_sample request, its edges
   edges of the frame.
15. Examples path: cugraph_tpu_torch.examples.train_graphsage and
   community_detection through their main() at their default sizes, and
   the trainer again at scale 18, where its blocks take spmm_rows; the
   trainer's loss must fall.

The line before the last is one JSON object with a "kernels" list (each
kernel's launches_by_path names only the paths that count it; the SpMVs'
"segments": K on the main path's graph, its launches and segment
passes); the last
line is {"ok": true, "device": {...}}. Without CUDA the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
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
# spmm_rows' wide layout on the small graphs: 128 (one float4 pass), 101
# (one float a load: F % 4 != 0) and 200 (a partial second 128-column pass)
WIDE_CHECK_FS = (128, 101, 200)
# its narrow layout: 1 and 2 (32 edges a step), 3, 33 and 37 (one float a
# load; 33 and 37 take a second column pass of 1 and 5), 8 (16 edges a
# step, Brandes at k = 8), 10 (two floats a load), 16, 32 and 64
NARROW_CHECK_FS = (1, 2, 3, 8, 10, 16, 32, 33, 37, 64)
# x at a 4-byte offset takes one float a load in either layout
UNALIGNED_CHECK_FS = (128, 8)
# spmm_rows at full shape in the narrow layout: (F, mode), Brandes' f32
# blocks of 8, 16 and 32 sources, an F with no 4-float loads, bf16
NARROW_FULL_SHAPES = ((8, "f32"), (16, "f32"), (32, "f32"), (10, "f32"), (8, "bf16"))
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


# the API path: external ids id * this odd constant mod 2^64, sparse int64
# values that pandas' factorize has to hash; 2^20 of them round-tripped;
# Jaccard on 2^16 given pairs (half of them edges, half drawn)
API_ID_MULTIPLIER = 0x9E3779B97F4A7C15
API_ROUNDTRIP_IDS = 1 << 20
API_JACCARD_PAIRS = 1 << 16
API_PAGERANK_TOL = 1e-9
# warm times: the median of 5 calls, wrapper and core call in turns (one
# warm call of each read the sampler's layer as -18.9 ms on an H100)
API_WARM_REPS = 5
# hungarian on a complete bipartite graph of 2,048 workers and 2,048 tasks
HUNGARIAN_SIDE = 2048
# force_atlas2: 500 iterations (the default) on the symmetrized RMAT scale-14
# graph, 50 more under the profiler; each of the first 3 steps against a
# float64 step over (V, V) pairs from the same state (fa2_step_errors),
# each coordinate's error over its scale: a row's 2^14 repulsion terms
# summed in f32 in another order, typically within sqrt(n) eps ~ 8e-6 of
# the sum of their absolute values; 1e-5, as TOL_SUM_REL for the sum kernels
FA2_SCALE = 14
FA2_CHECK_STEPS = 3
FA2_PROFILED_STEPS = 50
TOL_FA2_STEP_REL = 1e-5
# the training path: examples/train_graphsage.py's loop at the main path's
# width, 16 classes, 20 steps of Adam(lr 1e-3) on NeighborLoader blocks
# (batch SAMPLE_STARTS, fanouts SAMPLE_FANOUTS), then 10 steps on one
# fixed block; 3 steps of the MG make_sage_train_step
TRAIN_CLASSES = 16
TRAIN_STEPS = 20
TRAIN_FIXED_STEPS = 10
MG_TRAIN_STEPS = 3
# the MG step on one rank against the single-device step: the same kernel
# launches on the same CSC and CSR, the same matrix products, so only f32
# reassociation may differ; loss relative, each update relative to
# lr * max |g| beyond the f32 rounding of p - lr * g (2^-22 |p|)
TOL_MG_TRAIN_REL = 1e-5
# the trainer's step 1 against float64 autograd whose aggregation follows
# the kernel's bf16 contract both ways (PlainSpmm): the same roundings, so
# only the f32 sums and GEMMs may differ; loss relative, each gradient's
# max abs error over its max |ref|. Beside it the script reads what an
# aggregation without the bf16 rounding, and one that drops 1 in
# TRAIN_DROP_EVERY of the edges the loss reads, would read against the
# same reference.
TOL_TRAIN_STEP1_REL = 1e-5
TRAIN_DROP_EVERY = 1000
# MG Katz and eigenvector run this many iterations on both sides (tol 0):
# at the default tol, V * tol = 2.1 at s21 stops them after 3
MG_CENTRALITY_ITERATIONS = 100
# the MG community path: Louvain's and Leiden's reported Q against float64
# modularity of their labels
TOL_MG_Q = 1e-5
MG_PATH_DESTINATIONS = 1024  # mg_extract_bfs_paths in the MG path
# the MG analytics path: similarity on 2^16 seeded pairs (half edges),
# each coefficient against the single-device one (the same exact counts,
# the same float64 weight sums but summed in another order, one f32
# division), absolute; walks of node2vec's length; sampled betweenness as
# in the weighted path, against the single-device run on the same sources
# (the same f32 terms summed in another order); the GNN store's fanout
MG_PAIRS = 1 << 16
TOL_MG_SIMILARITY = 1e-6
MG_WALKERS = 1 << 14
MG_WALK_LENGTH = 80
MG_BC_K = 8
TOL_MG_BETWEENNESS_REL = 1e-5
MG_STORE_FANOUT = 10
# the probes path: the ceiling shapes beside the probes' own (stream_scale at
# 1 GiB each way, past the 50 MB L2; gather_rows from s21's vertex count of
# rows), and the tolerance of the two kernels that add with atomics, of the
# sum of their terms' |.| an output
PROBE_KERNELS = ("stream_scale", "gather_rows", "gather_window_sum", "multiwin_reduce",
                 "seg_scan_rows")
PROBE_HBM_ROWS = 1 << 21
PROBE_HBM_TABLE_ROWS = 1 << 21
TOL_PROBE_REL = 2e-6
TOL_PROBE_ABS = 1e-6
SERVICE_SCALE = 18  # the service path's R-MAT edge CSV
EXAMPLE_SPARSE_SCALE = 18  # the example trainer's blocks above DENSE_MAX_VERTICES


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


def unaligned(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of x whose data starts 4 bytes past a 16-byte
    boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


def small_graph_checks(seed: int) -> None:
    from cugraph_tpu_torch.prims.cuda import spmm_row, spmm_rows, spmv, spmv_minplus, spmv_sum

    layout = spmm_row.spmm_layout
    require(not any(layout(f).narrow for f in WIDE_CHECK_FS)
            and all(layout(f).narrow for f in NARROW_CHECK_FS)
            and layout(101).vec == 1 and layout(200).vec == 4
            and all(layout(f, 4).vec == 1 for f in UNALIGNED_CHECK_FS),
            "the spmm_rows check widths must reach the layouts they are listed for")
    spmm_fs = WIDE_CHECK_FS + NARROW_CHECK_FS
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
        for f in spmm_fs:
            xf = torch.randn(g.num_vertices, f, generator=gen).to(DEV)
            check_spmm_rows(adj, xf, "f32")
            check_spmm_rows(adj, xf, "bf16")
        for f in UNALIGNED_CHECK_FS:
            xf = unaligned(torch.randn(g.num_vertices, f, generator=gen).to(DEV))
            check_spmm_rows(adj, xf, "f32")
            check_spmm_rows(adj, xf, "bf16")
    n_spmm = 2 * 2 * 2 * len(spmm_fs)
    require(
        [k.launches - b for k, b in zip(counters, before)]
        == [4, 8, n_spmm + 2 * 2 * 2 * len(UNALIGNED_CHECK_FS)],
        "every small-graph check must launch its kernel",
    )
    log(f"small skewed graphs: spmv_sum, spmv_minplus, spmm_rows (f32, bf16; "
        f"wide F={list(WIDE_CHECK_FS)}, narrow F={list(NARROW_CHECK_FS)}, "
        f"x 4 bytes off alignment F={list(UNALIGNED_CHECK_FS)}) ok")

    # the adversarial graph, at the default tiles and at small ones (the hub
    # then spans thousands of tiles); spmm_rows' wide and narrow tiles
    spmm_tiles = ((spmm_row.ITEMS_PER_TILE, spmm_row.NARROW_ITEMS_PER_TILE), (32, 64))
    spmv_ipts = (spmv.SUM_ITEMS_PER_THREAD, 1)
    spmv_tiles = tuple(spmv.SUM_THREADS * i for i in spmv_ipts)
    before = [k.launches for k in counters]
    for weighted in (True, False):
        g = adversarial_graph(seed + 10 + weighted, weighted,
                              sum(spmm_tiles, ()) + spmv_tiles)
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
        for f in spmm_fs:
            xf = torch.randn(g.num_vertices, f, generator=gen).to(DEV)
            for precision in ("f32", "bf16"):
                for wide, narrow in spmm_tiles:
                    with tile_constant(spmm_row, "ITEMS_PER_TILE", wide), \
                            tile_constant(spmm_row, "NARROW_ITEMS_PER_TILE", narrow):
                        check_spmm_rows(adj, xf, precision)
    require(
        [k.launches - b for k, b in zip(counters, before)] == [8, 24, n_spmm * 2],
        "every adversarial-graph check must launch its kernel",
    )
    log(f"adversarial graphs (V={g.num_vertices}, E={g.num_edges}, hub in-degree "
        f"{int(g.in_degrees().max())}): spmv_sum, spmv_minplus (weighted, unweighted, BFS "
        f"x; tiles of {list(spmv_tiles)}), "
        f"spmm_rows (wide, narrow tiles of {list(spmm_tiles)}; f32, bf16; "
        f"wide F={list(WIDE_CHECK_FS)}, narrow F={list(NARROW_CHECK_FS)}) ok, each bit-equal "
        f"on a second launch")

    # the narrow layout's steps: rows whose last edge closes a step of its
    # G groups, at the default tile and a small one
    before = spmm_rows.launches
    steps = []
    for f in NARROW_CHECK_FS:
        groups = spmm_row.spmm_layout(f).groups
        for k in (spmm_row.NARROW_ITEMS_PER_TILE, 64):
            g, closing = step_boundary_graph(seed + f + k, groups, k)
            xf = torch.randn(g.num_vertices, f, generator=gen).to(DEV)
            with tile_constant(spmm_row, "NARROW_ITEMS_PER_TILE", k):
                for precision in ("f32", "bf16"):
                    check_spmm_rows(g.csc(), xf, precision)
            steps.append([f, groups, k, closing])
    require(spmm_rows.launches - before == 8 * len(NARROW_CHECK_FS),
            "every step-boundary check must launch spmm_rows")
    log(f"step-boundary graphs ([F, G, tile, rows closing a step]: {steps}): spmm_rows "
        f"(f32, bf16) ok, each bit-equal on a second launch")


def segment_counts(adj, kernels) -> dict:
    """K, the column segments the rule gives ``adj`` on this card, and
    each SpMV's launches and segment passes since its counters were set
    to 0; every call must have swept K ranges."""
    from cugraph_tpu_torch.prims.cuda import spmv

    k = -(-adj.num_minors // spmv.segment_width(adj, DEV))
    out = {"k": k}
    for name, fn in kernels.items():
        require(fn.segment_passes == k * fn.launches,
                f"{name}: {fn.segment_passes} segment passes over {fn.launches} calls at K = {k}")
        out[name] = {"launches": fn.launches, "segment_passes": fn.segment_passes}
    return out


@contextlib.contextmanager
def forced_segments(width: int):
    """Every SpMV in the block sweeps column segments of ``width`` minors,
    whatever the rule (``spmv.segment_width``) would give."""
    from cugraph_tpu_torch.prims.cuda import spmv

    with tile_constant(spmv, "segment_width", lambda adj, device: width):
        yield


def gapped_graph(seed: int, v: int = 5000, e: int = 60000, gap=(2000, 2500)):
    """skewed_graph's sources moved out of the range ``gap``, so that a
    column segment can hold no edge; weighted."""
    import cugraph_tpu_torch as ct

    gen = torch.Generator().manual_seed(seed)
    src = (torch.rand(e, generator=gen) ** 4 * (v - gap[1] + gap[0])).long()
    src = torch.where(src >= gap[0], src + gap[1] - gap[0], src)
    dst = (torch.rand(e, generator=gen) ** 3 * (v - 100)).long()
    w = torch.randn(e, generator=gen)
    return ct.from_edgelist(src, dst, w, num_vertices=v, device=DEV)


def segment_checks(seed: int) -> None:
    """The column-segmented sweep at forced widths: K = 2, 3 (an uneven
    last range) and 4 on the small skewed graphs and the adversarial
    graphs (at the default tiles and at 1 item a thread), and ranges of
    500 on a graph whose sources skip [2000, 2500) (a range with no edge):
    spmv_sum within TOL_SUM_REL of float64, spmv_minplus bit-exact
    (weighted, unweighted, BFS-shaped x), each relaunch bit-equal, one
    launch and K segment passes a call; K = 1 the unsegmented sweep."""
    from cugraph_tpu_torch.prims.cuda import _partition, spmv, spmv_minplus, spmv_sum

    gen = torch.Generator().manual_seed(seed)
    tiles = (spmv.SUM_THREADS * spmv.SUM_ITEMS_PER_THREAD, spmv.SUM_THREADS)
    graphs = [("skewed", skewed_graph(seed + 20, weighted=True), (spmv.SUM_ITEMS_PER_THREAD,)),
              ("skewed unweighted", skewed_graph(seed + 21, weighted=False),
               (spmv.SUM_ITEMS_PER_THREAD,)),
              ("adversarial", adversarial_graph(seed + 22, True, tiles),
               (spmv.SUM_ITEMS_PER_THREAD, 1)),
              ("adversarial unweighted", adversarial_graph(seed + 23, False, tiles),
               (spmv.SUM_ITEMS_PER_THREAD, 1)),
              ("gapped", gapped_graph(seed + 24), (spmv.SUM_ITEMS_PER_THREAD,))]
    out = {}
    for name, g, ipts in graphs:
        adj = g.csc()
        v = adj.num_minors
        x = torch.randn(v, generator=gen).to(DEV)
        ids = torch.arange(v, dtype=torch.float32, device=DEV)
        xb = torch.where(torch.rand(v, generator=gen).to(DEV) < 0.05, ids, float("inf"))
        widths = [v] + [-(-v // k) for k in (2, 3, 4)] + ([500] if name == "gapped" else [])
        done = []
        for width in widths:
            segs = _partition.segments_for(adj, width) if width < v else []
            k = max(len(segs), 1)
            if name == "gapped" and width == 500:
                require(segs[4].num_edges == 0, "the gapped graph's range [2000, 2500) is empty")
            for ipt in ipts:
                calls = (spmv_sum.launches, spmv_minplus.launches)
                passes = (spmv_sum.segment_passes, spmv_minplus.segment_passes)
                with forced_segments(width), tile_constant(spmv, "SUM_ITEMS_PER_THREAD", ipt):
                    check_spmv_sum(adj, x)
                    check_spmv_minplus(adj, x)
                    check_spmv_minplus(adj, x, use_weights=False)
                    check_spmv_minplus(adj, xb, use_weights=False)
                require([spmv_sum.launches - calls[0], spmv_minplus.launches - calls[1]] == [2, 6],
                        f"{name}: one launch a call")
                require([spmv_sum.segment_passes - passes[0],
                         spmv_minplus.segment_passes - passes[1]] == [2 * k, 6 * k],
                        f"{name}: {k} segment passes a call at width {width}")
            done.append([width, k, [s.num_edges for s in segs]])
        out[name] = done
    log(f"column segments ([width, K, edges a range] by graph): {json.dumps(out)}; spmv_sum "
        f"within {TOL_SUM_REL}, spmv_minplus bit-exact (weighted, unweighted, BFS x), each "
        f"bit-equal on a second launch")


def step_boundary_graph(seed: int, groups: int, k: int, rows: int = 6000):
    """A CSC whose rows are built one by one so that every fourth row's
    last edge closes a step of ``groups`` edges of the k-item tile that
    holds it (steps counted from the tile's first edge), between empty
    rows, short rows and rows of groups - 1 .. 2 groups + 1 edges; row 1 a
    hub of 2^14 edges. Returns (graph, rows closing a step on the plan),
    at least 8 of them."""
    import bisect

    import cugraph_tpu_torch as ct
    from cugraph_tpu_torch.prims.cuda._partition import merge_path_tiles

    gen = torch.Generator().manual_seed(seed)
    deg, markers, edges = [0, 1 << 14], [0, (1 << 14) + 1], 1 << 14
    for i in range(rows):
        pos = edges + len(deg)  # the row's first item
        if i % 4 == 0:
            tile = pos // k
            e0 = tile * k - bisect.bisect_left(markers, tile * k)
            d = (e0 - edges) % groups or groups
            if pos + d > (tile + 1) * k:  # the row would leave its tile
                d = 1
        elif i % 4 == 3:
            d = int(torch.randint(groups - 1, 2 * groups + 2, (1,), generator=gen))
        else:
            d = int(torch.randint(0, 3, (1,), generator=gen)) if i % 4 == 1 else 0
        deg.append(d)
        edges += d
        markers.append(edges + len(deg) - 1)
    deg += [0, 0]
    v = len(deg)
    degt = torch.tensor(deg)
    dst = torch.repeat_interleave(torch.arange(v), degt)
    src = (torch.rand(dst.numel(), generator=gen) ** 3 * v).long()
    g = ct.from_edgelist(src, dst, torch.randn(dst.numel(), generator=gen), num_vertices=v,
                         device=DEV)
    offsets = torch.cat([torch.zeros(1, dtype=torch.long), degt.cumsum(0)])
    _, tile_edge = merge_path_tiles(offsets.to(torch.int32), edges, k)
    ends = offsets[1:][degt > 0]
    tile = torch.searchsorted(tile_edge.long(), ends - 1, right=True) - 1
    closing = int(((ends - tile_edge.long()[tile]) % groups == 0).sum())
    require(closing >= 8, f"rows closing a step of {groups} on {k}-item tiles: {closing}")
    return g, closing


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
                buf.data_ptr() + 4 * v, buf.data_ptr(), n_tiles, spmv.SUM_ITEMS_PER_THREAD, 0,
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

    # spmm_rows at F = 128 in the main path's bf16 mode, f32 beside it; F =
    # 129 (the wide layout's scalar loads, both modes) and F = 40 (narrow)
    # in f32
    f = 128
    xs = torch.randn(v, f, generator=gen, device=DEV)
    err_bf16 = check_spmm_rows(adj, xs, "bf16")
    err_f32 = check_spmm_rows(adj, xs, "f32")
    err_f40 = check_spmm_rows(adj, torch.randn(v, 40, generator=gen, device=DEV), "f32")
    x129 = torch.randn(v, f + 1, generator=gen, device=DEV)
    require(spmm_row.spmm_layout(f + 1)[:4] == (False, 32, 1, 1), "F = 129 takes the wide layout")
    err_f129 = check_spmm_rows(adj, x129, "f32")
    err_f129_bf16 = check_spmm_rows(adj, x129, "bf16")
    del x129
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
        f129_f32_max_abs_err=err_f129, f129_bf16_max_abs_err=err_f129_bf16,
    )
    del xs
    out["spmm_rows"]["narrow"] = narrow_full_shape(adj, graph_bytes, n_src, lib_a, gen)
    log(f"full-shape kernels (V={v}, E={e}, sources with out-edges={n_src}): checks ok")
    return out


def narrow_full_shape(adj, graph_bytes: int, n_src: int, lib_a, gen) -> dict:
    """spmm_rows in the narrow layout at NARROW_FULL_SHAPES on the main
    graph's CSC: checked against float64 (a second launch bit-equal),
    timed single and back to back, bound, CSR @ X beside it."""
    from cugraph_tpu_torch.prims.cuda import spmm_row, spmm_rows, spmm_rows_reference

    v, e = adj.num_majors, adj.num_edges
    out = {}
    for f, mode in NARROW_FULL_SHAPES:
        x = torch.randn(v, f, generator=gen, device=DEV)
        err = check_spmm_rows(adj, x, mode)
        b_ms, b_by = bound(graph_bytes + 4 * f * n_src + 4 * f * v, 2 * e * f)
        call = lambda: spmm_rows(adj, x, precision=mode)  # noqa: E731
        library = lambda: lib_a @ x  # noqa: E731
        out[f"f{f}_{mode}"] = dict(
            f=f, mode=mode, layout=spmm_row.spmm_layout(f)._asdict(), max_abs_err=err,
            tol=f"rel {TOL_SUM_REL} of the row's sum of |w x| vs float64",
            ms=median_ms(call, 20),
            plain_ms=median_ms(lambda: spmm_rows_reference(adj, x, precision=mode), 3),
            bound_ms=b_ms, bound_by=b_by, library_ms=median_ms(library, 20),
            **back_to_back(call, library, 20),
        )
        log(f"spmm_rows narrow F={f} {mode}: {json.dumps(out[f'f{f}_{mode}'])}")
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


def seeded_graphsage(seed: int, out_features: int = 64):
    """GraphSAGE(128 -> 128 -> out_features, 2 layers) with weights drawn
    from a fixed torch.Generator, uniform in +-1/sqrt(fan_in) like
    nn.Linear."""
    from cugraph_tpu_torch.gnn import GraphSAGE

    model = GraphSAGE(128, hidden_features=128, out_features=out_features, num_layers=2,
                      device=DEV)
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
    spmv_sum.segment_passes = spmv_minplus.segment_passes = 0

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
    segments = segment_counts(g.csc(), {"spmv_sum": spmv_sum, "spmv_minplus": spmv_minplus})
    log(f"main path seconds: {json.dumps(seconds)}")
    log(f"main path launches: {json.dumps(launches)}; column segments {json.dumps(segments)}")
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
    return dict(seconds=seconds, launches=launches, segments=segments, pagerank_iterations=iters,
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
    the runs, {kernel, memset or copy: [launches, device µs]} over them,
    and the device's busy seconds, the union of those operations'
    intervals (operations on two streams at once, such as NCCL's beside
    the compute stream, count once)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        sync()
        wall = time.perf_counter() - t
    busy_us, end = 0.0, -math.inf
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                              if e.device_type == DeviceType.CUDA):
        if stop > end:
            busy_us, end = busy_us + stop - max(start, end), stop
    return wall, {e.key: [e.count, e.self_device_time_total]
                  for e in prof.key_averages() if e.device_type == DeviceType.CUDA}, busy_us / 1e6


def warm_breakdown(phases) -> dict:
    """Each algorithm phase once more, after the counted run: its wall
    seconds warm, then its device time by kernel under torch.profiler.
    The idle share is 1 - (device busy) / (profiled wall), busy the union
    of the device's operation intervals."""
    out = {}
    for name, fn in phases.items():
        t = time.perf_counter()
        fn()
        sync()
        warm = time.perf_counter() - t
        wall, device, busy = profiled(fn)
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

    # paths to 1,024 seeded destinations, and the ring PageRank: the
    # counters set to 0 just before and read just after
    for k in counters.values():
        k.launches = 0
    dests = torch.randint(0, v, (MG_PATH_DESTINATIONS,), device=DEV,
                          generator=torch.Generator(device=DEV).manual_seed(seed + 9))
    t = time.perf_counter()
    paths, max_len = mg_algos.mg_extract_bfs_paths(mesh, mgg, dist_l, pred_l, dests)
    sync()
    seconds["mg_extract_bfs_paths"] = time.perf_counter() - t
    want, want_len = ct.extract_bfs_paths(g, rd, rp, dests)
    require(max_len == want_len and torch.equal(paths, want),
            "mg_extract_bfs_paths differs from extract_bfs_paths")
    t = time.perf_counter()
    ring_l, ring_iters = mg_algos.mg_pagerank(mesh, mgg, tol=0.0, max_iterations=50,
                                              gather_mode="ring")
    sync()
    seconds["mg_pagerank_ring"] = time.perf_counter() - t
    extra = {name: k.launches for name, k in counters.items()}
    require(extra["spmv_sum"] == ring_iters, "the ring PageRank must launch spmv_sum once an iteration")
    require(torch.equal(ring_l, pr_l), "ring mg_pagerank differs from all_gather on 1 x 1")
    warm = {}
    for mode in ("all_gather", "ring"):
        t = time.perf_counter()
        mg_algos.mg_pagerank(mesh, mgg, tol=0.0, max_iterations=50, gather_mode=mode)
        sync()
        warm[mode] = time.perf_counter() - t
    out["paths"] = dict(destinations=MG_PATH_DESTINATIONS, max_len=max_len,
                        seconds=seconds["mg_extract_bfs_paths"])
    out["ring"] = dict(bit_equal_all_gather=True, iterations=ring_iters, warm_s=warm)
    out["extra_launches"] = extra
    log(f"mg path paths and ring: {json.dumps({k: out[k] for k in ('paths', 'ring')})}, "
        f"launches {json.dumps(extra)}")

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
    for name in ("betweenness", "edge_betweenness"):
        require(launches[name]["spmm_rows"] > 0, f"spmm_rows was not launched by {name}")
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
    _, device, _ = profiled(call, 50)
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


# ------------------------------------------------- the benchmarks/ probes


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal shapes, types and bits (NaN and -0.0 included)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    as_int = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[a.dtype]
    return torch.equal(a.contiguous().view(as_int), b.contiguous().view(as_int))


def require_raises(fn, exc, msg: str) -> None:
    try:
        fn()
    except exc:
        return
    raise RuntimeError(f"check failed: {msg}")


def within_sum_tol(name: str, got, plain, abs_sum) -> float:
    """Each output within TOL_PROBE_REL of the sum of its terms' |.| (plus
    TOL_PROBE_ABS) of the plain version's: the atomics add in no fixed
    order. Returns the largest absolute difference."""
    err = (got.double() - plain.double()).abs()
    lim = TOL_PROBE_REL * abs_sum.double() + TOL_PROBE_ABS
    require(got.shape == plain.shape and bool((err <= lim).all()),
            f"{name}: beyond {TOL_PROBE_REL} x sum|terms| + {TOL_PROBE_ABS} of the plain version")
    return err.max().item() if err.numel() else 0.0


def probe_edge_cases(seed: int) -> dict:
    """The five probe kernels on small, ragged and adversarial inputs, each
    against its plain version on the card: stream_scale at lengths off
    whole float4s, 4 bytes off alignment and on IEEE specials; gather_rows
    at widths that take each copy unit (16, 8, 4, 2 B), a table 4 and 2
    bytes off alignment, one hot row, counts off whole groups of rows in
    flight, int64 ids; gather_window_sum at 32 and 64 lanes, 1 to 300
    edges a tile, every edge on one row; multiwin_reduce with every window
    on one start and the last valid start; seg_scan_rows with a short last
    tile, all or no flags, NaN flags, -0.0 and infinities. Each index out of
    range raises GraphError."""
    from cugraph_tpu_torch.prims.cuda import probes as pr
    from cugraph_tpu_torch.utils.error import GraphError

    gen = torch.Generator(device=DEV).manual_seed(seed + 11)
    counts = dict.fromkeys(PROBE_KERNELS, 0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=DEV)

    def randint(hi, *shape):
        return torch.randint(0, hi, shape, generator=gen, device=DEV)

    specials = torch.tensor([0.0, -0.0, float("inf"), -float("inf"), float("nan"), 1e-40,
                             -1e-45, 3.4e38, 1.0], device=DEV)
    xs = [randn(n) for n in (1, 3, 4, 5, 1027)] + [randn(4099)[1:], specials, randn(3, 128)]
    require(xs[5].data_ptr() % 16 == 4, "the stream_scale slice starts 4 bytes in")
    for x in xs:
        for a in (2.0, 1.000001, -0.5):
            require(same_bits(pr.stream_scale(x, a), pr.stream_scale_reference(x, a)),
                    f"stream_scale({tuple(x.shape)}, {a}) differs from its plain version")
            counts["stream_scale"] += 1

    tables = [randn(37, w) for w in (1, 3, 100, 128, 200)]
    tables += [randn(37, w).to(torch.bfloat16) for w in (1, 3, 128)]
    tables += [randn(38, 1)[1:], randn(38, 1).to(torch.bfloat16)[1:]]
    require(tables[-2].data_ptr() % 8 == 4 and tables[-1].data_ptr() % 4 == 2,
            "the gather_rows table slices start 4 and 2 bytes in")
    for table in tables:
        n = table.shape[0]
        for ids in (randint(n, 1), randint(n, 7), randint(n, 9), randint(n, 4, 33),
                    torch.zeros(64, dtype=torch.int32, device=DEV),
                    torch.full((13,), n - 1, device=DEV), randint(n, 0)):
            require(same_bits(pr.gather_rows(table, ids), pr.gather_rows_reference(table, ids)),
                    f"gather_rows({tuple(table.shape)} {table.dtype}, {tuple(ids.shape)}) "
                    "differs from its plain version")
            counts["gather_rows"] += 1
        for bad in (-1, n):
            require_raises(lambda: pr.gather_rows(table, torch.tensor([0, bad], device=DEV)),
                           GraphError, f"gather_rows took id {bad} of a {n}-row table")

    for width, tiles, edges in ((32, 4, 1), (64, 4, 7), (128, 8, 128), (32, 4, 300)):
        table = randn(300, width)
        srcs, dstl = randint(300, tiles, edges), randint(pr.WINDOW_ROWS, tiles, edges)
        for d in (dstl, torch.full_like(dstl, pr.WINDOW_ROWS - 1)):
            within_sum_tol(f"gather_window_sum({width}, {tiles}x{edges})",
                           pr.gather_window_sum(table, srcs, d),
                           pr.gather_window_sum_reference(table, srcs, d),
                           pr.gather_window_sum_reference(table.abs(), srcs, d))
            counts["gather_window_sum"] += 1
    table, srcs, dstl = randn(300, 32), randint(300, 4, 5), randint(pr.WINDOW_ROWS, 4, 5)
    for bad_s, bad_d in ((300, 0), (-1, 0), (0, pr.WINDOW_ROWS), (0, -1)):
        s, d = srcs.clone(), dstl.clone()
        s[1, 2], d[3, 4] = bad_s, bad_d
        require_raises(lambda: pr.gather_window_sum(table, s, d), GraphError,
                       f"gather_window_sum took srcs {bad_s} / dstl {bad_d}")

    out_rows = 3
    size = out_rows * pr.LANES
    for n_win, starts in ((1, None), (3, "same"), (5, "last"), (4, None)):
        vals = torch.rand(n_win * 8, pr.LANES, generator=gen, device=DEV)
        gdl = randint(pr.CAP_V, n_win * 8, pr.LANES)
        if starts == "same":
            wstart = torch.zeros(n_win, dtype=torch.int32, device=DEV)
            gdl = torch.full_like(gdl, pr.CAP_V - 1)
        elif starts == "last":
            wstart = torch.full((n_win,), size - pr.CAP_V, dtype=torch.int32, device=DEV)
        else:
            wstart = randint(size - pr.CAP_V + 1, n_win)
        within_sum_tol(f"multiwin_reduce({n_win} windows, {starts})",
                       pr.multiwin_reduce(wstart, vals, gdl, out_rows),
                       pr.multiwin_reduce_reference(wstart, vals, gdl, out_rows),
                       pr.multiwin_reduce_reference(wstart, vals.abs(), gdl, out_rows))
        counts["multiwin_reduce"] += 1
    for bad_w, bad_g in ((size - pr.CAP_V + 1, 0), (-1, 0), (0, pr.CAP_V), (0, -1)):
        wstart, gdl = torch.zeros(1, dtype=torch.int64, device=DEV), randint(pr.CAP_V, 8, pr.LANES)
        wstart[0], gdl[5, 7] = bad_w, bad_g
        vals = torch.rand(8, pr.LANES, generator=gen, device=DEV)
        require_raises(lambda: pr.multiwin_reduce(wstart, vals, gdl, out_rows), GraphError,
                       f"multiwin_reduce took wstart {bad_w} / gdl {bad_g}")

    for rows, width in ((1, 1), (511, 3), (512, 128), (513, 128), (1000, 200), (1537, 5)):
        v = randn(rows, width)
        v[0, 0], v[-1, -1] = -0.0, float("inf")
        for flags in ((torch.rand(rows, width, generator=gen, device=DEV) < 0.1).float(),
                      torch.ones(rows, width, device=DEV), torch.zeros(rows, width, device=DEV),
                      torch.where(torch.rand(rows, width, generator=gen, device=DEV) < 0.05,
                                  float("nan"), 0.0)):
            require(same_bits(pr.seg_scan_rows(v, flags), pr.seg_scan_rows_reference(v, flags)),
                    f"seg_scan_rows({rows}, {width}) differs from its plain version")
            counts["seg_scan_rows"] += 1
    sync()
    log(f"probe edge cases: every check passed, {json.dumps(counts)}")
    return counts


def probes_path(seed: int) -> dict:
    """The benchmarks/ probes' entry point (cugraph_tpu_torch.microbench)
    at the probes' shapes and at the two ceiling shapes (stream_scale at
    2^21 rows, gather_rows from a 2^21-row table), launch counters set to
    0 just before and read just after; then each kernel on small,
    adversarial inputs and at full shape against its plain version,
    timed, bounded, beside its library yardstick, and the measured copy
    and gather rates on a line of their own."""
    from cugraph_tpu_torch import microbench as mb
    from cugraph_tpu_torch.prims.cuda import probes as pr

    counters = {name: getattr(pr, name) for name in PROBE_KERNELS}
    for c in counters.values():
        c.launches = 0
    t = time.perf_counter()
    runs = [mb.run(device=DEV, seed=seed),
            mb.run(rows=PROBE_HBM_ROWS, names=("k1_copy",), device=DEV, seed=seed),
            mb.run(table_rows=PROBE_HBM_TABLE_ROWS, names=("gather_f32", "gather_bf16"),
                   device=DEV, seed=seed)]
    sync()
    seconds = time.perf_counter() - t
    launches = {n: c.launches for n, c in counters.items()}
    for r in sum(runs, []):
        log(f"  {mb.line(r)}  [rows={r['rows']} table_rows={r['table_rows']}]")
    log(f"probes path launches: {json.dumps(launches)}")
    require(all(launches.values()), "the probes' entry point must launch every probe kernel")
    # the kernels' times are the entry point's, on the same inputs as the
    # checks below: ms (single wrapper calls), back_to_back_ms (the wrapper
    # back to back) and kernel_b2b_ms (the launch alone, back to back)
    probe, hbm_copy, hbm_gather = ({r["name"]: r for r in run} for run in runs)

    def times(r):
        return {k: r[k] for k in ("ms", "back_to_back_ms", "kernel_b2b_ms")}

    edge = probe_edge_cases(seed)
    inp = mb.probe_inputs(sorted(set(sum(mb.NEEDS.values(), ()))), seed=seed, device=DEV)
    big = mb.probe_inputs(("x",), rows=PROBE_HBM_ROWS, seed=seed, device=DEV)
    big.update(mb.probe_inputs(("table", "srcs"), table_rows=PROBE_HBM_TABLE_ROWS, seed=seed,
                               device=DEV))
    out = {}

    # stream_scale: bit-equal, at the probe's 64 MB and at 1 GiB each way
    def copy_entry(x, a, r):
        y = pr.stream_scale(x, a)
        require(same_bits(y, pr.stream_scale_reference(x, a)),
                f"stream_scale({x.shape[0]} rows, {a}) differs from its plain version")
        check_relaunch("stream_scale", y, lambda: pr.stream_scale(x, a))
        b_ms, b_by = bound(8 * x.numel(), x.numel())
        return dict(max_abs_err=0.0, rows=x.shape[0], **times(r),
                    plain_ms=median_ms(lambda: pr.stream_scale_reference(x, a), 20),
                    bound_ms=b_ms, bound_by=b_by,
                    library_ms=median_ms(lambda: x.mul(a), 20),
                    library_back_to_back_ms=back_to_back_ms(lambda: x.mul(a), 20))

    out["stream_scale"] = dict(
        copy_entry(inp["x"], mb.COPY_SCALE["k1_copy"], probe["k1_copy"]),
        tol="bit-equal to the plain version (and on relaunch)",
        b0=copy_entry(inp["x"], mb.COPY_SCALE["b0_copy"], probe["b0_copy"]),
        hbm=copy_entry(big["x"], mb.COPY_SCALE["k1_copy"], hbm_copy["k1_copy"]))

    # gather_rows: bit-equal, f32 and bf16, from the L2-resident table and from HBM
    def gather_entry(table, srcs, r):
        y = pr.gather_rows(table, srcs)
        require(same_bits(y, pr.gather_rows_reference(table, srcs)),
                f"gather_rows({table.shape[0]} rows, {table.dtype}) differs from its plain version")
        check_relaunch("gather_rows", y, lambda: pr.gather_rows(table, srcs))
        e, ids64 = srcs.numel(), srcs.reshape(-1).long()
        distinct = int(torch.unique(srcs).numel())
        row = table.shape[1] * table.element_size()
        b_ms, b_by = bound(4 * e + distinct * row + e * row, 0)
        return dict(max_abs_err=0.0, table_rows=table.shape[0], dtype=str(table.dtype),
                    edges=e, distinct_rows=distinct, **times(r),
                    plain_ms=median_ms(lambda: pr.gather_rows_reference(table, srcs), 20),
                    bound_ms=b_ms, bound_by=b_by,
                    library_ms=median_ms(lambda: table.index_select(0, ids64), 20),
                    library_back_to_back_ms=back_to_back_ms(
                        lambda: table.index_select(0, ids64), 20),
                    grows_per_s=e / r["kernel_b2b_ms"] / 1e6,
                    gbps=2 * e * row / r["kernel_b2b_ms"] / 1e6)

    table, srcs = inp["table"], inp["srcs"]
    out["gather_rows"] = dict(
        gather_entry(table, srcs, probe["gather_f32"]),
        tol="bit-equal to the plain version (and on relaunch)",
        bf16=gather_entry(table.to(torch.bfloat16), srcs, probe["gather_bf16"]),
        hbm=gather_entry(big["table"], big["srcs"], hbm_gather["gather_f32"]),
        hbm_bf16=gather_entry(big["table"].to(torch.bfloat16), big["srcs"],
                              hbm_gather["gather_bf16"]))
    for dtype in (torch.float32, torch.bfloat16):
        tb = table.to(dtype)
        require(same_bits(mb.gather_chain(tb, srcs, 3),
                          mb.gather_chain(tb, srcs, 3, lambda t: pr.gather_rows_reference(t, srcs))),
                f"the {dtype} gather chain differs from its plain version")

    # gather_window_sum: within the sum tolerance of the plain version
    dstl = inp["dstl"]
    y = pr.gather_window_sum(table, srcs, dstl)
    plain = pr.gather_window_sum_reference(table, srcs, dstl)
    abs_sum = pr.gather_window_sum_reference(table.abs(), srcs, dstl)
    err = within_sum_tol("gather_window_sum", y, plain, abs_sum)
    within_sum_tol("gather_window_sum (relaunch)", pr.gather_window_sum(table, srcs, dstl), plain,
                   abs_sum)
    e = srcs.numel()
    distinct = int(torch.unique(srcs).numel())
    b_ms, b_by = bound(8 * e + distinct * 512 + y.numel() * 4, e * 128)
    out["gather_window_sum"] = dict(
        max_abs_err=err, tol=f"{TOL_PROBE_REL} x sum|terms| + {TOL_PROBE_ABS} a row entry "
        "(shared-memory atomics add in no fixed order)",
        edges=e, windows=y.shape[0] // pr.WINDOW_ROWS, distinct_rows=distinct,
        relaunch_bit_equal=same_bits(pr.gather_window_sum(table, srcs, dstl), y),
        **times(probe["gather_window_sum"]),
        plain_ms=median_ms(lambda: pr.gather_window_sum_reference(table, srcs, dstl), 20),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, library="none")

    # multiwin_reduce: within the sum tolerance; index_add_ over the
    # precomputed keys (global atomics alone) timed beside it
    wstart, vals, gdl = inp["wstart"], inp["vals"], inp["gdl"]
    rows = mb.MWR_OUT_ROWS
    y = pr.multiwin_reduce(wstart, vals, gdl, rows)
    plain = pr.multiwin_reduce_reference(wstart, vals, gdl, rows)
    abs_sum = pr.multiwin_reduce_reference(wstart, vals.abs(), gdl, rows)
    err = within_sum_tol("multiwin_reduce", y, plain, abs_sum)
    within_sum_tol("multiwin_reduce (relaunch)", pr.multiwin_reduce(wstart, vals, gdl, rows),
                   plain, abs_sum)
    keys = (wstart.long().repeat_interleave(pr.WINDOW_EDGE_ROWS * pr.LANES)
            + gdl.reshape(-1).long())
    flat_vals, acc = vals.reshape(-1), torch.zeros(rows * pr.LANES, device=DEV)
    n = vals.numel()
    b_ms, b_by = bound(8 * n + 4 * wstart.numel() + y.numel() * 4, n)
    out["multiwin_reduce"] = dict(
        max_abs_err=err, tol=f"{TOL_PROBE_REL} x sum|terms| + {TOL_PROBE_ABS} a slot "
        "(atomics add in no fixed order)",
        edges=n, windows=wstart.numel(), out_rows=rows, **times(probe["k6_multiwin_reduce"]),
        plain_ms=median_ms(lambda: pr.multiwin_reduce_reference(wstart, vals, gdl, rows), 20),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, library="none",
        index_add_over_keys_ms=median_ms(lambda: acc.index_add_(0, keys, flat_vals), 20),
        index_add_over_keys_b2b_ms=back_to_back_ms(lambda: acc.index_add_(0, keys, flat_vals), 20))

    # seg_scan_rows: bit-equal
    v, flags = inp["v"], inp["flags"]
    y = pr.seg_scan_rows(v, flags)
    require(same_bits(y, pr.seg_scan_rows_reference(v, flags)),
            "seg_scan_rows differs from its plain version at full shape")
    check_relaunch("seg_scan_rows", y, lambda: pr.seg_scan_rows(v, flags))
    n = v.numel()
    b_ms, b_by = bound(12 * n, n)
    out["seg_scan_rows"] = dict(
        max_abs_err=0.0, tol="bit-equal to the plain version (and on relaunch)", rows=v.shape[0],
        **times(probe["k8_seg_scan_reduce"]),
        plain_ms=median_ms(lambda: pr.seg_scan_rows_reference(v, flags), 5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, library="none")

    g, s = out["gather_rows"], out["stream_scale"]
    gathers = {"L2 f32": g, "L2 bf16": g["bf16"], "HBM f32": g["hbm"], "HBM bf16": g["hbm_bf16"]}
    rates = dict(
        copy_GBps={f"{m['rows']} rows": 8 * m["rows"] * 128 / m["kernel_b2b_ms"] / 1e6
                   for m in (s, s["hbm"])},
        gather_Grows_per_s={k: m["grows_per_s"] for k, m in gathers.items()},
        gather_GBps={k: m["gbps"] for k, m in gathers.items()},
        multiwin_shared_then_global_ms=out["multiwin_reduce"]["kernel_b2b_ms"],
        index_add_global_only_ms=out["multiwin_reduce"]["index_add_over_keys_b2b_ms"])
    log(f"probe rates (back-to-back, the card's time): {json.dumps(rates)}")
    timing = ("ms", "back_to_back_ms", "kernel_b2b_ms", "plain_ms", "bound_ms", "library_ms")
    log(f"probes path: checks ok, "
        f"{json.dumps({k: {t: m.get(t) for t in timing} for k, m in out.items()})}")
    return dict(seconds=seconds, launches=launches, kernels=out, rates=rates, edge_cases=edge,
                microbench=sum(runs, []))


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

    import cugraph_tpu_torch as ct
    from cugraph_tpu_torch.dist.mg_graph import distribute_edgelist_chunks

    v = 1 << scale
    with one_rank_mesh() as mesh:
        shards = ct.mg_rmat_edgelist(mesh, scale, 16 * v, seed=seed, scramble=True)
        t = time.perf_counter()
        mgg = distribute_edgelist_chunks(mesh, ct.rmat_chunk_source(shards), num_vertices=v)
        sync()
        seconds = time.perf_counter() - t
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
    # core_number's warm run (21.8 s, 2,239 rounds) is left out to keep
    # the script inside its time; its first call is timed above
    out["warm"] = warm_breakdown({k: fn for k, fn in phases.items() if k != "core_number"})
    # the graph and the results the MG community path is held to
    refs = dict(g=g, wcc=wcc, core_number=core, louvain=results["louvain"],
                leiden=results["leiden"])
    return out, refs


# ------------------------------------------------------------- API path


def external_ids(ids):
    """Distinct sparse int64 external ids: id * API_ID_MULTIPLIER mod 2^64,
    a bijection (the multiplier is odd), as a host array."""
    import numpy as np

    return (ids.cpu().numpy().astype(np.uint64) * np.uint64(API_ID_MULTIPLIER)).view(np.int64)


def reference_fa2(g, pos, forces, speed) -> tuple:
    """One FA2 step with the default options in float64, every pair at once
    ((V, V) temporaries): the JAX package's step written out apart from
    the port's blocked one. Returns (pos, forces, speed, size): size is
    each coordinate's scale for an f32 error, its step factor times the
    sum of the absolute values of its force's terms, plus |pos|."""
    csr = g.csr()
    deg = (csr.offsets[1:] - csr.offsets[:-1]).double() + 1
    s, d = csr.majors.long(), csr.minors.long()
    pos, forces, speed = pos.double(), forces.double(), speed.double()
    diff = pos[:, None, :] - pos[None, :, :]
    rep = 2.0 * deg[:, None] * deg[None, :] / ((diff * diff).sum(-1) + 1e-9)
    rep.fill_diagonal_(0.0)
    f_rep = (rep[:, :, None] * diff).sum(1)
    terms = (rep[:, :, None] * diff.abs()).sum(1)
    del diff, rep
    f_grav = -deg[:, None] * pos / (torch.sqrt((pos * pos).sum(-1)) + 1e-9)[:, None]
    ediff = pos[d] - pos[s]
    edist = torch.sqrt((ediff * ediff).sum(-1)) + 1e-9
    coef = edist / deg[s] / edist  # unit weights
    f_attr = torch.zeros_like(pos).index_add_(0, s, coef[:, None] * ediff)
    terms += f_grav.abs() + torch.zeros_like(pos).index_add_(0, s, (coef[:, None] * ediff).abs())
    new = f_rep + f_grav + f_attr
    swing = torch.sqrt(((forces - new) ** 2).sum(-1))
    traction = 0.5 * torch.sqrt(((forces + new) ** 2).sum(-1))
    target = (deg * traction).sum() / ((deg * swing).sum() + 1e-9)
    speed = speed * torch.clamp(target / torch.clamp(speed, min=1e-9), 0.5, 1.5)
    factor = (speed / (1.0 + torch.sqrt(speed * swing)))[:, None]
    pos = pos + new * factor
    return pos, new, speed, factor * terms + pos.abs()


def fa2_step_errors(g, steps: int) -> list:
    """FA2 is chaotic in f32 (a close pair's repulsion goes as 1 / distance),
    so the port is held to the float64 step one step at a time: from the
    float64 run's state rounded to f32, the port's step (the blocked
    repulsion, default options) against the float64 step. Each error is
    the largest of |pos - ref| / size over the coordinates (size from
    reference_fa2), as a sum's error is taken against the sum of its
    terms' absolute values. The run starts at the port's default start
    (seed 0, drawn in float64, kept in float32)."""
    import numpy as np

    from cugraph_tpu_torch.algos import layout

    v = g.num_vertices
    fg = layout._fa2_graph(g, 1.0)
    pos = torch.from_numpy(
        np.random.default_rng(0).uniform(-100, 100, (v, 2)).astype(np.float32)).to(DEV)
    forces = torch.zeros_like(pos)
    speed = torch.ones((), dtype=torch.float32, device=DEV)
    require(torch.equal(layout.force_atlas2(g, max_iter=0), pos), "fa2's default start")
    errors = []
    for _ in range(steps):
        # both steps from the same f32 state
        pos, forces, speed = pos.float(), forces.float(), speed.float()
        got, _, _ = layout._fa2_step(fg, pos, forces, speed, 1.0, 1.0, 2.0, False, True, False)
        pos, forces, speed, size = reference_fa2(g, pos, forces, speed)
        errors.append(((got.double() - pos).abs() / size).max().item())
    return errors


def api_path(scale: int, small_scale: int, seed: int) -> dict:
    """The user-facing layer at RMAT ``scale``: the graph built through
    api.Graph from a pandas frame of sparse int64 ids (NumberMap timed
    apart), the dataframe algorithms beside the port's core calls,
    serialization, the expensive checks; then the spanning trees at
    ``small_scale``, hungarian on 2,048 x 2,048 and force_atlas2 at scale
    14. Each part timed, with the launch counters set to 0 just before
    and read just after, and checked by code that does not run through
    it."""
    import networkx as nx
    import numpy as np
    import pandas as pd
    import scipy.optimize as spo

    import cugraph_tpu_torch as ct
    from cugraph_tpu_torch import api
    from cugraph_tpu_torch.api import algorithms as alg
    from cugraph_tpu_torch.core import serialize
    from cugraph_tpu_torch.core.renumber import NumberMap
    from cugraph_tpu_torch.prims.cuda import (
        assemble_chunks,
        cumsum_flat,
        spmm_rows,
        spmv_minplus,
        spmv_sum,
    )
    from cugraph_tpu_torch.utils import validation
    from cugraph_tpu_torch.utils.error import GraphError

    counters = {"spmv_sum": spmv_sum, "spmv_minplus": spmv_minplus, "spmm_rows": spmm_rows,
                "cumsum_flat": cumsum_flat, "assemble_chunks": assemble_chunks}
    seconds, launches = {}, {}

    def run(name, fn):
        """Time fn; its launches are added to those of earlier calls of
        the same name."""
        for c in counters.values():
            c.launches = 0
        t = time.perf_counter()
        out = fn()
        sync()
        seconds[name] = time.perf_counter() - t
        prev = launches.get(name, {})
        launches[name] = {n: prev.get(n, 0) + c.launches for n, c in counters.items()}
        return out

    def raises(fn) -> bool:
        try:
            fn()
        except GraphError:
            return True
        return False

    out = {}
    # --- graph build through the API, NumberMap timed apart
    src, dst, v = rmat_edges(scale, seed)
    e = src.numel()
    df = pd.DataFrame({"source": external_ids(src), "destination": external_ids(dst)})
    del src, dst
    run("graph_first", lambda: api.Graph(device=DEV).from_pandas_edgelist(df))
    # the build's first pass alone, as from_pandas_edgelist calls it
    run("numbermap", lambda: NumberMap.renumber(df, "source", "destination", device=DEV))
    G = run("graph_warm", lambda: api.Graph(device=DEV).from_pandas_edgelist(df))
    out["graph"] = dict(rows=e, vertices=G.number_of_vertices(), edges_stored=G.core.num_edges,
                        seconds=[seconds["graph_first"], seconds["graph_warm"]],
                        numbermap_seconds=seconds["numbermap"],
                        numbermap_share=seconds["numbermap"] / seconds["graph_warm"])
    # the internal ids against compute_renumber_map over numpy's codes:
    # np.unique's sorted ids, each row's code its rank there (searched on
    # the card: return_inverse would argsort all 2E ids on the host)
    t = time.perf_counter()
    allv = np.concatenate([df["source"].to_numpy(), df["destination"].to_numpy()])
    uniq = np.unique(allv)
    codes = torch.searchsorted(torch.from_numpy(uniq).to(DEV), torch.from_numpy(allv).to(DEV))
    del allv
    new_to_old = ct.compute_renumber_map(codes[:e], codes[e:], len(uniq), device=DEV)
    del codes
    require(np.array_equal(G.vertex_ids_external(), uniq[new_to_old.cpu().numpy()]),
            "NumberMap's internal ids differ from compute_renumber_map over np.unique's codes")
    out["graph"]["reference_seconds"] = time.perf_counter() - t
    absent = external_ids(torch.tensor([v]))  # the image of an id past the R-MAT ids
    v = G.number_of_vertices()  # the ids that occur in an edge
    gen = np.random.default_rng(seed)
    ids = gen.integers(0, v, API_ROUNDTRIP_IDS)
    t = time.perf_counter()
    back = G.to_internal(G.to_external(ids))
    out["graph"]["roundtrip_seconds"] = time.perf_counter() - t
    require(np.array_equal(back, ids), "to_internal(to_external(ids)) does not round-trip")
    require(raises(lambda: G.to_internal(absent)), "an unknown external id must raise")
    log(f"api graph: {json.dumps(out['graph'])}")

    # --- the dataframe algorithms beside the port's core calls
    core = G.core
    ext = G.to_external
    vid = G.vertex_ids_external()
    start_ext = vid[:1]
    start_int = G.to_internal(start_ext)
    csr = core.csr()
    half = API_JACCARD_PAIRS // 2
    pick = torch.randint(0, core.num_edges, (half,), device=DEV,
                         generator=torch.Generator(device=DEV).manual_seed(seed + 12))
    p1 = torch.cat([csr.majors[pick], torch.randint(0, v, (half,), device=DEV, dtype=torch.int32)])
    p2 = torch.cat([csr.minors[pick], torch.randint(0, v, (half,), device=DEV, dtype=torch.int32)])
    pairs_ext = (ext(p1), ext(p2))
    starts_int = gen.integers(0, v, SAMPLE_STARTS)
    starts_ext = ext(starts_int)

    def sample_gen():
        return torch.Generator(device=DEV).manual_seed(seed + 13)

    def host(t):
        return t.cpu().numpy()

    def pred_ext(p):
        p = host(p)
        return np.where(p >= 0, ext(np.maximum(p, 0)), -1)

    def vframe(**cols):
        return pd.DataFrame({"vertex": vid, **cols})

    pairs = {
        # tol 1e-9: the default 1e-5 stops after one iteration at this V
        # (the loop runs while the L1 change exceeds V * tol)
        "pagerank": (lambda: alg.pagerank(G, tol=API_PAGERANK_TOL),
                     lambda: ct.pagerank(core, tol=API_PAGERANK_TOL, max_iterations=100),
                     lambda r: vframe(pagerank=host(r[0]))),
        "bfs": (lambda: alg.bfs(G, start_ext),
                lambda: ct.bfs(core, start_int),
                lambda r: vframe(distance=host(r[0]), predecessor=pred_ext(r[1]))),
        "sssp": (lambda: alg.sssp(G, start_ext),
                 lambda: ct.sssp(core, start_int),
                 lambda r: vframe(distance=host(r[0]), predecessor=pred_ext(r[1]))),
        "connected_components": (lambda: alg.connected_components(G),
                                 lambda: ct.weakly_connected_components(core),
                                 lambda r: vframe(labels=host(r))),
        "jaccard": (lambda: alg.jaccard(G, pairs=pairs_ext),
                    lambda: ct.jaccard(core, pairs=(p1, p2)),
                    lambda r: pd.DataFrame({"first": ext(r[0]), "second": ext(r[1]),
                                            "jaccard_coeff": host(r[2])})),
        "uniform_neighbor_sample": (
            lambda: alg.uniform_neighbor_sample(G, starts_ext, list(SAMPLE_FANOUTS),
                                                generator=sample_gen()),
            lambda: ct.uniform_neighbor_sample(core, starts_int, list(SAMPLE_FANOUTS),
                                               generator=sample_gen()),
            lambda r: pd.DataFrame({"sources": ext(r["sources"]),
                                    "destinations": ext(r["destinations"]),
                                    "hop_id": host(r["hop"])})),
    }
    algos, core_results = {}, {}
    for name, (wrapper, core_call, as_frame) in pairs.items():
        got = run(f"api_{name}", wrapper)
        res = core_results[name] = run(f"core_{name}", core_call)
        t = time.perf_counter()
        want = as_frame(res)
        convert_s = time.perf_counter() - t
        pd.testing.assert_frame_equal(got, want, check_dtype=False, check_exact=True)
        require(launches[f"api_{name}"] == launches[f"core_{name}"],
                f"api {name} launched {launches[f'api_{name}']}, "
                f"its core call {launches[f'core_{name}']}")
        # warm: wrapper and core call in turns, the median of each
        warm = {"api": [], "core": []}
        for _ in range(API_WARM_REPS):
            for side, fn in (("api", wrapper), ("core", core_call)):
                run(f"{side}_{name}_warm", fn)
                warm[side].append(seconds[f"{side}_{name}_warm"])
        for side in warm:
            seconds[f"{side}_{name}_warm"] = statistics.median(warm[side])
        algos[name] = dict(
            rows=len(got), launches=launches[f"api_{name}"],
            warm_launches=launches[f"api_{name}_warm"],
            api_s=[seconds[f"api_{name}"], seconds[f"api_{name}_warm"]],
            core_s=[seconds[f"core_{name}"], seconds[f"core_{name}_warm"]],
            layer_s=seconds[f"api_{name}_warm"] - seconds[f"core_{name}_warm"],
            warm_s=warm, check_frame_s=convert_s)
    require(algos["pagerank"]["launches"]["spmv_sum"] > 0, "api pagerank must launch spmv_sum")
    require(algos["bfs"]["launches"]["spmv_minplus"] > 0, "api bfs must launch spmv_minplus")
    out["algorithms"] = algos
    log(f"api algorithms: {json.dumps(algos)}")

    # the kernels on this graph against their plain versions, and the core
    # calls the frames were held to against the float64 PageRank and the
    # BFS over spmv_minplus_reference (outside run(): not counted)
    kgen = torch.Generator(device=DEV).manual_seed(seed + 15)
    adj, nv = core.csc(), core.num_vertices
    x = torch.rand(nv, generator=kgen, device=DEV) / nv
    sum_err = check_spmv_sum(adj, x)
    ids = torch.arange(nv, dtype=torch.float32, device=DEV)
    xb = torch.where(torch.rand(nv, generator=kgen, device=DEV) < 0.1, ids, float("inf"))
    check_spmv_minplus(adj, xb, use_weights=False)
    pr, iters = core_results["pagerank"]
    pr_err = rel_err(pr, reference_pagerank(core, iters))
    require(pr_err <= TOL_CENTRALITY_REL, f"api graph pagerank error {pr_err} > {TOL_CENTRALITY_REL}")
    rd, rp = reference_bfs(core, int(start_int[0]))
    dist, pred = core_results["bfs"]
    require(torch.equal(dist, rd) and torch.equal(pred, rp),
            "api graph bfs differs from the reference")
    out["kernel_checks"] = dict(
        spmv_sum_max_abs_err=sum_err, spmv_sum_tol=f"rel {TOL_SUM_REL} of the row's sum of |x|",
        spmv_minplus="bit-exact, +inf pattern equal", pagerank_iterations=iters,
        pagerank_rel_err=pr_err, pagerank_tol=TOL_CENTRALITY_REL, bfs="equal to the reference")
    log(f"api kernel checks: {json.dumps(out['kernel_checks'])}")
    del G, core, csr, pick, p1, p2, adj, x, xb, ids, core_results, pr, dist, pred, rd, rp
    torch.cuda.empty_cache()

    # --- serialization of the s21 graph, and the expensive checks on its edges
    src, dst, v = rmat_edges(scale, seed)
    g = ct.from_edgelist(src, dst, num_vertices=v, device=DEV)
    blob = run("serialize", lambda: serialize.serialize_graph(g))
    g2 = run("deserialize", lambda: serialize.deserialize_graph(blob, device=DEV))
    for a, b in ((g.csr(), g2.csr()), (g.csc(), g2.csc())):
        require(all(torch.equal(getattr(a, k), getattr(b, k))
                    for k in ("offsets", "majors", "minors")) and b.weights is None,
                "the loaded graph's CSR or CSC differs from the original")
    out["serialize"] = dict(bytes=len(blob), edges=g.num_edges, save_s=seconds["serialize"],
                            load_s=seconds["deserialize"])
    del blob, g2
    validation.set_expensive_checks(True)
    try:
        run("check_edgelist", lambda: validation.check_edgelist(src, dst, None, v))
        bad = dst.clone()
        bad[-1] = v
        require(raises(lambda: validation.check_edgelist(src, bad, None, v)),
                "check_edgelist must raise on an id out of range")
    finally:
        validation.set_expensive_checks(False)
    out["check_edgelist"] = dict(edges=src.numel(), seconds=seconds["check_edgelist"])
    del g, src, dst, bad
    torch.cuda.empty_cache()
    log(f"api serialize, checks: {json.dumps([out['serialize'], out['check_edgelist']])}")

    # --- spanning trees on the weighted symmetrized small-scale graph
    s_src, s_dst, s_v = rmat_edges(small_scale, seed)
    wgen = torch.Generator(device=DEV).manual_seed(seed + 9)
    gsw = ct.from_edgelist(s_src, s_dst, 1.0 - torch.rand(s_src.numel(), generator=wgen, device=DEV),
                           num_vertices=s_v, symmetrize=True, device=DEV)
    trees = {}
    n_wcc = int(torch.unique(ct.weakly_connected_components(gsw)).numel())
    scsr = gsw.csr()
    keys = scsr.majors.long() * s_v + scsr.minors.long()  # sorted: CSR order
    for name in ("minimum_spanning_tree", "maximum_spanning_tree"):
        ts, td, tw = run(name, lambda: getattr(ct, name)(gsw))
        require(ts.numel() == s_v - n_wcc, f"{name}: {ts.numel()} edges, V - components "
                f"{s_v - n_wcc}")
        tk = ts.long() * s_v + td.long()
        pos = torch.searchsorted(keys, tk).clamp(max=keys.numel() - 1)
        require(bool((keys[pos] == tk).all()) and torch.equal(scsr.weights[pos], tw),
                f"{name}: a tree edge is not in the graph with its weight")
        trees[name] = dict(edges=ts.numel(), total=float(tw.double().sum()),
                           seconds=seconds[name], launches=launches[name])
    require(trees["minimum_spanning_tree"]["total"] <= trees["maximum_spanning_tree"]["total"],
            "the minimum tree weighs more than the maximum tree")
    # the total weight against networkx's tree at scale 12 (symmetric weights)
    t_src, t_dst, t_v = rmat_edges(12, seed)
    g12 = ct.from_edgelist(t_src, t_dst, 1.0 - torch.rand(t_src.numel(), generator=wgen, device=DEV),
                           num_vertices=t_v, symmetrize=True, device=DEV)
    a, b, w = (host(x) for x in ct.core.decompress_to_edgelist(g12))
    G12 = nx.Graph()
    G12.add_weighted_edges_from((int(x), int(y), float(z)) for x, y, z in zip(a, b, w) if x < y)
    nx_total = nx.minimum_spanning_tree(G12).size(weight="weight")
    total12 = float(ct.minimum_spanning_tree(g12)[2].double().sum())
    require(abs(total12 - nx_total) <= 1e-9 * nx_total,
            f"scale-12 tree weight {total12} vs networkx {nx_total}")
    trees.update(scale=small_scale, edges_stored=gsw.num_edges, components=n_wcc,
                 scale12_total=total12, scale12_networkx=nx_total)
    out["spanning_trees"] = trees
    log(f"api spanning trees: {json.dumps(trees)}")
    del gsw, scsr, keys, g12

    # --- hungarian on a complete bipartite graph
    n = HUNGARIAN_SIDE
    cost = np.random.default_rng(seed + 14).random((n, n)).astype(np.float32)
    workers = np.arange(n, dtype=np.int32)
    gh = ct.from_edgelist(np.repeat(workers, n), np.tile(workers + n, n), cost.reshape(-1),
                          num_vertices=2 * n, device=DEV)
    total, assign = run("hungarian", lambda: ct.hungarian(gh, workers))
    rows, cols = spo.linear_sum_assignment(cost.astype(np.float64))
    ref = float(cost.astype(np.float64)[rows, cols].sum())
    require(abs(total - ref) <= 1e-9 * ref, f"hungarian cost {total} vs scipy {ref}")
    require(np.array_equal(np.sort(host(assign)), workers + n), "the assignment is no permutation")
    require(abs(float(cost[workers, host(assign) - n].astype(np.float64).sum()) - ref)
            <= 1e-9 * ref, "the assignment does not cost what hungarian returned")
    out["hungarian"] = dict(workers=n, tasks=n, edges=gh.num_edges, cost=total, scipy_cost=ref,
                            seconds=seconds["hungarian"])
    del gh

    # --- force atlas 2 on the symmetrized scale-14 graph
    f_src, f_dst, f_v = rmat_edges(FA2_SCALE, seed)
    g14 = ct.from_edgelist(f_src, f_dst, num_vertices=f_v, symmetrize=True, device=DEV)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    pos = run("force_atlas2", lambda: ct.force_atlas2(g14))
    peak = torch.cuda.max_memory_allocated() - base
    require(bool(torch.isfinite(pos).all()) and pos.shape == (f_v, 2), "fa2 positions")
    unblocked = 20 * f_v * f_v
    require(peak < unblocked / 4, f"fa2 peak {peak} B, the unblocked step's {unblocked}")
    # the port's default start: seed 0, drawn in float64, kept in float32
    fa2_err = fa2_step_errors(g14, FA2_CHECK_STEPS)
    require(max(fa2_err) <= TOL_FA2_STEP_REL, f"fa2 steps against float64: {fa2_err} of max |pos|")
    wall, device, busy = profiled(lambda: ct.force_atlas2(g14, max_iter=FA2_PROFILED_STEPS))
    top = sorted(device.items(), key=lambda kv: -kv[1][1])[:3]
    out["force_atlas2"] = dict(
        vertices=f_v, edges=g14.num_edges, iterations=500, seconds=seconds["force_atlas2"],
        peak_bytes=peak, unblocked_bytes=unblocked, step_errors_f64=fa2_err,
        profiled_iterations=FA2_PROFILED_STEPS, profiled_s=wall, device_busy_s=busy,
        idle_share=1 - busy / wall if busy else None, top_kernels_ms=[[k[:80], c, us / 1e3] for k, (c, us) in top])
    log(f"api hungarian, fa2: {json.dumps([out['hungarian'], out['force_atlas2']])}")
    out["seconds"], out["launches"] = seconds, launches
    return out


# ---------------------------------------------------------- train path


def block_loss(model, block, feats, labels):
    """Cross-entropy over a block's seeds (compact ids [0, num_seeds))."""
    ids = block.n_ids.long()
    out = model(block.graph, feats[ids])
    n = block.num_seeds
    return torch.nn.functional.cross_entropy(out[:n], labels[ids][:n])


class PlainSpmm(torch.autograd.Function):
    """SpmmRowsFunction's contract in plain torch, any dtype: Y = A r(X)
    over the CSC, dX = A^T r(dY) over the CSR, r rounding each operand to
    bf16 in "bf16" mode (none in "f32"), the sums in the tensors' dtype;
    each edge scaled by its weight where ``use_weights``."""

    @staticmethod
    def forward(ctx, x, csc, csr, precision, use_weights):
        from cugraph_tpu_torch.prims.cuda import spmm_rows_reference

        ctx.csr, ctx.precision, ctx.use_weights = csr, precision, use_weights
        return spmm_rows_reference(csc, x, precision=precision, use_weights=use_weights)

    @staticmethod
    def backward(ctx, dy):
        from cugraph_tpu_torch.prims.cuda import spmm_rows_reference

        dx = spmm_rows_reference(ctx.csr, dy, precision=ctx.precision, use_weights=ctx.use_weights)
        return dx, None, None, None, None


def loss_edges(block):
    """A block edge mask (in CSC order) of the edges the seeds' outputs
    read: into a seed (the second layer's aggregation), or into a seed's
    in-neighbour or a seed (the first layer's)."""
    c, n = block.graph.csc(), block.num_seeds
    dst, src = c.majors.long(), c.minors.long()
    field = torch.zeros(block.graph.num_vertices, dtype=torch.bool, device=dst.device)
    field[:n] = True
    field[src[dst < n]] = True
    return field[dst]


def drop_edges(block, every: int):
    """The block's CSC and CSR with weight 0 on 1 in ``every`` of the
    distinct edges the loss reads (by key src * V + dst, the first of
    them always) and 1 elsewhere: the same edges in both."""
    g, v = block.graph, block.graph.num_vertices
    c = g.csc()
    keys = (c.minors.long() * v + c.majors.long())[loss_edges(block)].unique()[::every]

    def masked(adj, src, dst):
        keep = ~torch.isin(src.long() * v + dst.long(), keys)
        return dataclasses.replace(adj, weights=keep.float())

    return masked(c, c.minors, c.majors), masked(g.csr(), g.csr().majors, g.csr().minors)


def reference_block_loss(model, block, feats, labels, precision="bf16", drop_every=0):
    """The loss and each parameter's gradient by float64 autograd through
    the plain versions: the model's layers by hand, the mean aggregation
    by PlainSpmm (in "bf16", the mode the port takes on the card above
    DENSE_MAX_VERTICES, its backward rounding each term of dY as the
    kernel does). ``precision="f32"`` leaves the rounding out and
    ``drop_every`` > 0 drops edges the loss reads (drop_edges): what a
    faulty aggregation would read against the sound reference."""
    params = {k: p.detach().double().requires_grad_() for k, p in model.named_parameters()}
    g = block.graph
    csc, csr = drop_edges(block, drop_every) if drop_every else (g.csc(), g.csr())
    deg = g.in_degrees().double().clamp(min=1)[:, None]
    ids = block.n_ids.long()
    h = feats[ids].double()
    for i in range(len(model.convs)):
        def lin(part, x):
            return x @ params[f"convs.{i}.lin_{part}.weight"].T + params[f"convs.{i}.lin_{part}.bias"]

        nbr = PlainSpmm.apply(h, csc, csr, precision, bool(drop_every)) / deg
        h = lin("self", h) + lin("nbr", nbr)
        if i < len(model.convs) - 1:
            h = torch.relu(h)
    h = h / h.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    n = block.num_seeds
    loss = torch.nn.functional.cross_entropy(h[:n], labels[ids][:n])
    loss.backward()
    return loss.detach(), {k: p.grad for k, p in params.items()}


def check_block(g, block) -> dict:
    """Every block edge is a graph edge under n_ids (keys src * V + dst
    found in the graph's sorted CSR keys); the seeds take compact ids
    [0, num_seeds)."""
    v = g.num_vertices
    csr = g.csr()
    keys = csr.majors.long() * v + csr.minors.long()
    b = block.graph.csr()
    got = block.n_ids[b.majors.long()].long() * v + block.n_ids[b.minors.long()].long()
    pos = torch.searchsorted(keys, got).clamp(max=keys.numel() - 1)
    require(bool((keys[pos] == got).all()), "a block edge is not a graph edge under n_ids")
    require(torch.equal(block.n_ids[: block.num_seeds], block.seed_ids),
            "n_ids[:num_seeds] differs from seed_ids")
    return dict(vertices=block.graph.num_vertices, edges=block.graph.num_edges)


def minibatch_trainer(g, seed: int) -> dict:
    """examples/train_graphsage.py's loop at the main path's width:
    NeighborLoader (batch SAMPLE_STARTS, fanouts SAMPLE_FANOUTS, shuffled)
    -> block -> GraphSAGE(128 -> 128 -> TRAIN_CLASSES) -> cross-entropy
    over the seeds -> backward -> Adam(lr 1e-3), TRAIN_STEPS steps, the
    counters set to 0 just before each step and read just after. The
    loader's two parts run one after the other as its iterator runs them,
    each timed: the sample, then the block built from it."""
    from cugraph_tpu_torch.gnn import NeighborLoader
    from cugraph_tpu_torch.prims.cuda import spmm_rows
    from cugraph_tpu_torch.prims.dense_spmm import DENSE_MAX_VERTICES

    v = g.num_vertices
    gen = torch.Generator(device=DEV).manual_seed(seed + 12)
    feats = torch.randn(v, 128, generator=gen, device=DEV)
    labels = torch.randint(0, TRAIN_CLASSES, (v,), generator=gen, device=DEV)
    model = seeded_graphsage(seed + 13, TRAIN_CLASSES)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    loader = NeighborLoader(g, torch.arange(v, device=DEV), SAMPLE_FANOUTS,
                            batch_size=SAMPLE_STARTS, shuffle=True, seed=seed,
                            generator=torch.Generator(device=DEV).manual_seed(seed + 14))
    def epochs():
        while True:
            yield from loader._seed_batches()

    batches = epochs()
    parts = {k: [] for k in ("sample", "block_build", "forward", "backward", "optimizer", "step")}
    losses, launches, blocks = [], [], []
    step1 = None
    for step in range(TRAIN_STEPS):
        spmm_rows.launches = 0
        t0 = time.perf_counter()
        batch = next(batches)
        res = loader._sample(batch)
        sync()
        ta = time.perf_counter()
        block = loader._build_block(batch, res)
        sync()
        t1 = time.perf_counter()
        loss = block_loss(model, block, feats, labels)
        sync()
        t2 = time.perf_counter()
        opt.zero_grad()
        loss.backward()
        sync()
        t3 = time.perf_counter()
        if step == 0:  # the gradients of step 1, before Adam moves anything
            grads = {k: p.grad.clone() for k, p in model.named_parameters()}
            ref_loss, ref_grads = reference_block_loss(model, block, feats, labels)

            def errors(loss, grads):
                return dict({k: rel_err(grads[k], ref_grads[k]) for k in grads},
                            loss=abs(loss.item() - ref_loss.item()) / abs(ref_loss.item()))

            step1 = dict(loss=loss.item(), ref_loss=ref_loss.item(), rel_err=errors(loss, grads),
                         block_edges=block.graph.num_edges,
                         loss_edges=int(loss_edges(block).sum()))
            # what a faulty aggregation reads against the same reference
            step1["faulty_reads"] = {
                name: max(errors(*reference_block_loss(model, block, feats, labels, **kw)).values())
                for name, kw in (("no_bf16_rounding", dict(precision="f32")),
                                 (f"drop_1_in_{TRAIN_DROP_EVERY}_loss_edges",
                                  dict(drop_every=TRAIN_DROP_EVERY)))}
            t3b = time.perf_counter()
        opt.step()
        sync()
        t4 = time.perf_counter()
        launches.append(spmm_rows.launches)
        losses.append(loss.item())
        blocks.append(check_block(g, block))
        require(block.graph.num_vertices > DENSE_MAX_VERTICES,
                f"a block of {block.graph.num_vertices} vertices takes the dense branch")
        opt_s = t4 - (t3b if step == 0 else t3)
        for k, dt in (("sample", ta - t0), ("block_build", t1 - ta), ("forward", t2 - t1),
                      ("backward", t3 - t2), ("optimizer", opt_s), ("step", t3 - t0 + opt_s)):
            parts[k].append(dt)
    log(f"train path: spmm_rows launches by step {launches}; losses {losses}")
    require(all(n == 3 for n in launches), "a trainer step must launch spmm_rows 3 times")
    require(all(math.isfinite(x) for x in losses), "a trainer loss is not finite")
    for k, err in step1["rel_err"].items():
        require(err <= TOL_TRAIN_STEP1_REL, f"step 1 {k} error {err} > {TOL_TRAIN_STEP1_REL}")
    log(f"train path step 1 vs float64 autograd: {json.dumps(step1)}")

    # 10 Adam steps on the last block lower its loss
    spmm_rows.launches = 0
    fixed = []
    for _ in range(TRAIN_FIXED_STEPS):
        loss = block_loss(model, block, feats, labels)
        opt.zero_grad()
        loss.backward()
        opt.step()
        fixed.append(loss.item())
    with torch.no_grad():
        fixed.append(block_loss(model, block, feats, labels).item())
    sync()
    fixed_launches = spmm_rows.launches
    require(fixed[-1] < fixed[0], f"{TRAIN_FIXED_STEPS} Adam steps did not lower the loss: {fixed}")

    batches = iter(loader)  # the loader's own iterator, for the profiled step
    next(batches)  # the epoch's shuffle, outside the profile

    def one_step():
        loss = block_loss(model, next(batches), feats, labels)
        opt.zero_grad()
        loss.backward()
        opt.step()

    wall, device, busy = profiled(one_step)
    median = {k: statistics.median(x) for k, x in parts.items()}
    out = dict(steps=TRAIN_STEPS, launches_by_step=launches, losses=losses, step1=step1,
               fixed_block_losses=fixed, median_s=median,
               seeds_per_s=SAMPLE_STARTS / median["step"],
               blocks=dict(vertices=[b["vertices"] for b in blocks],
                           edges=[b["edges"] for b in blocks]),
               profiled_step=dict(wall_s=wall, device_busy_s=busy,
                                  idle_share=1 - busy / wall if busy else None,
                                  top_kernels_ms=[[k[:80], c, us / 1e3] for k, (c, us) in sorted(
                                      device.items(), key=lambda kv: -kv[1][1])[:5]]),
               launches={"minibatch_steps": {"spmm_rows": sum(launches)},
                         "fixed_block_steps": {"spmm_rows": fixed_launches}})
    log(f"train path minibatch: median s {json.dumps(median)}, "
        f"{out['seeds_per_s']:.0f} seeds/s, profiled step {json.dumps(out['profiled_step'])}")
    return out


def mg_train_step(g, seed: int) -> dict:
    """make_sage_train_step on a 1 x 1 NCCL mesh (its own group, made and
    destroyed here), F = 128 -> 128 -> 64, lr 1e-2, MG_TRAIN_STEPS steps,
    the counters set to 0 just before each step and read just after. Step
    1's update is held against p - lr * g with g by autograd through the
    single-device spmm_aggregate on the card (bf16 too), its loss against
    the single-device loss; spmm_rows over the rank's out_block (the
    backward's product) checked and timed against its plain version."""
    from cugraph_tpu_torch.dist import distribute_graph, mg_gnn
    from cugraph_tpu_torch.dist.mg_graph import shard_vertex_values
    from cugraph_tpu_torch.gnn import spmm_aggregate
    from cugraph_tpu_torch.prims.cuda import spmm_rows, spmm_rows_reference

    v = g.num_vertices
    lr = 1e-2
    gen = torch.Generator(device=DEV).manual_seed(seed + 15)
    params = mg_gnn.init_sage_params(gen, 128, 128, 64, device=DEV)
    feats_g = torch.randn(v, 128, generator=gen, device=DEV)
    targets_g = torch.randn(v, 64, generator=gen, device=DEV)

    # the single-device step-1 loss and gradients
    leaves = {k: p.clone().requires_grad_() for k, p in params.items()}
    agg = spmm_aggregate(g, feats_g, op="mean")
    h = torch.relu(feats_g @ leaves["w_self1"] + agg @ leaves["w_nbr1"])
    out = h @ leaves["w_self2"] + spmm_aggregate(g, h, op="mean") @ leaves["w_nbr2"]
    sg_loss = ((out - targets_g) ** 2).sum() / v
    sg_grads = dict(zip(leaves, torch.autograd.grad(sg_loss, list(leaves.values()))))
    dy = torch.randn(v, 128, generator=gen, device=DEV)  # a dY of the second aggregation
    del agg, h, out

    seconds = {}
    t = time.perf_counter()
    with one_rank_mesh() as mesh:
        sync()
        seconds["setup"] = time.perf_counter() - t
        t = time.perf_counter()
        mgg = distribute_graph(mesh, g)
        sync()
        seconds["mg_graph"] = time.perf_counter() - t
        feats, targets = shard_vertex_values(mesh, mgg, feats_g), shard_vertex_values(mesh, mgg, targets_g)
        step = mg_gnn.make_sage_train_step(mesh, mgg, lr=lr)
        launches, losses, step_s, p = [], [], [], params
        for i in range(MG_TRAIN_STEPS):
            spmm_rows.launches = 0
            t = time.perf_counter()
            new, loss = step(p, feats, targets)
            sync()
            step_s.append(time.perf_counter() - t)
            launches.append(spmm_rows.launches)
            losses.append(loss.item())
            if i == 0:
                upd_err = {}
                for k in new:
                    diff = (new[k] - (params[k] - lr * sg_grads[k])).abs()
                    excess = (diff - 2.0**-22 * params[k].abs()).clamp(min=0).max()
                    upd_err[k] = (excess / (lr * sg_grads[k].abs().max())).item()
            p = new
        log(f"mg train: spmm_rows launches by step {launches}; losses {losses}; seconds {step_s}")
        require(all(n == 3 for n in launches), "an MG train step must launch spmm_rows 3 times")
        require(all(math.isfinite(x) for x in losses), "an MG train loss is not finite")
        loss_rel = abs(losses[0] - sg_loss.item()) / abs(sg_loss.item())
        require(loss_rel <= TOL_MG_TRAIN_REL, f"MG loss {losses[0]} vs single-device {sg_loss.item()}")
        for k, err in upd_err.items():
            require(err <= TOL_MG_TRAIN_REL, f"MG step 1 update of {k}: error {err} of lr * max |g|")
        wall, device, busy = profiled(lambda: step(p, feats, targets))

        # the backward's product: spmm_rows over out_block on a dY
        blk = mgg.out_block
        rows, e = blk.num_majors, blk.num_edges
        n_dst = int((mgg.in_block.degrees() > 0).sum())  # dY rows the data needs
        lib = sparse_csr(blk)
        b_ms, b_by = bound(4 * (rows + 1) + 4 * e + 4 * 128 * n_dst + 4 * 128 * rows,
                           2 * e * 128)
        out_block = dict(
            max_abs_err=check_spmm_rows(blk, dy, "bf16"), mode="bf16",
            ms=median_ms(lambda: spmm_rows(blk, dy, precision="bf16"), 10),
            plain_ms=median_ms(lambda: spmm_rows_reference(blk, dy, precision="bf16"), 3),
            bound_ms=b_ms, bound_by=b_by, library_ms=median_ms(lambda: lib @ dy, 10),
            block=dict(majors=rows, minors=blk.num_minors, edges=e, needed_dy_rows=n_dst))
    res = dict(seconds=seconds, step_s=step_s, losses=losses, launches_by_step=launches,
               sg_loss=sg_loss.item(), loss_rel_err=loss_rel, update_rel_err=upd_err,
               warm_step=dict(wall_s=wall, device_busy_s=busy,
                              idle_share=1 - busy / wall if busy else None),
               out_block=out_block, launches={"mg_train_steps": {"spmm_rows": sum(launches)}})
    log(f"mg train checks: {json.dumps({k: res[k] for k in ('loss_rel_err', 'update_rel_err', 'warm_step', 'out_block')})}")
    return res


def train_path(g, seed: int) -> dict:
    """Phase 11: the minibatch trainer, then the MG train step."""
    t = time.perf_counter()
    out = dict(minibatch=minibatch_trainer(g, seed))
    out["mg"] = mg_train_step(g, seed)
    out["launches"] = dict(out["minibatch"]["launches"], **out["mg"]["launches"])
    out["path_s"] = time.perf_counter() - t
    log(f"train path: {out['path_s']:.1f} s, launches {json.dumps(out['launches'])}")
    return out


# ---------------------------------------------------- MG weighted path


def mg_weighted_path(g, seed: int) -> dict:
    """Phase 12: the weighted s21 graph on a 1 x 1 NCCL mesh (its own
    group): mg_sssp(0), mg_katz_centrality, mg_eigenvector_centrality and
    mg_hits, each with the counters set to 0 just before and read just
    after, against the single-device results: SSSP distances and
    predecessors equal, the centralities within TOL_CENTRALITY_REL. Katz
    and eigenvector run MG_CENTRALITY_ITERATIONS iterations on both
    sides."""
    import cugraph_tpu_torch as ct
    from cugraph_tpu_torch.dist import distribute_graph, mg_algos
    from cugraph_tpu_torch.dist.mg_graph import unshard_vertex_values
    from cugraph_tpu_torch.prims.cuda import spmm_rows, spmv_minplus, spmv_sum

    counters = {"spmv_sum": spmv_sum, "spmv_minplus": spmv_minplus, "spmm_rows": spmm_rows}
    alpha = 1.0 / (int(g.out_degrees().max()) + 1)  # the single-device default
    fixed = dict(max_iterations=MG_CENTRALITY_ITERATIONS, tol=0.0)
    seconds, launches, results = {}, {}, {}
    with one_rank_mesh() as mesh:
        mgg = distribute_graph(mesh, g)
        phases = {
            "mg_sssp": lambda: mg_algos.mg_sssp(mesh, mgg, 0),
            "mg_katz": lambda: mg_algos.mg_katz_centrality(mesh, mgg, alpha, **fixed),
            "mg_eigenvector": lambda: mg_algos.mg_eigenvector_centrality(mesh, mgg, **fixed),
            "mg_hits": lambda: mg_algos.mg_hits(mesh, mgg),
        }
        for name, fn in phases.items():
            for c in counters.values():
                c.launches = 0
            t = time.perf_counter()
            res = fn()
            sync()
            seconds[name] = time.perf_counter() - t
            launches[name] = {n: c.launches for n, c in counters.items()}
            res = res if isinstance(res, tuple) else (res,)
            results[name] = tuple(unshard_vertex_values(mgg, r) for r in res)
        log(f"mg weighted path seconds: {json.dumps(seconds)}")
        log(f"mg weighted path launches: {json.dumps(launches)}")
        require(launches["mg_sssp"]["spmv_minplus"] > 0, "spmv_minplus was not launched by mg_sssp")
        for name in ("mg_katz", "mg_eigenvector", "mg_hits"):
            require(launches[name]["spmv_sum"] > 0, f"spmv_sum was not launched by {name}")
        warm = warm_breakdown(phases)
    out = dict(seconds=seconds, launches=launches, warm=warm)
    dist_, pred = results["mg_sssp"]
    rd, rp = ct.sssp(g, 0)
    require(torch.equal(dist_, rd), "mg_sssp distances differ from the single-device sssp")
    require(torch.equal(pred, rp), "mg_sssp predecessors differ from the single-device sssp")
    out["sssp"] = dict(reached=int(torch.isfinite(rd).sum()), rounds=launches["mg_sssp"]["spmv_minplus"])
    refs = {"mg_katz": (ct.katz_centrality(g, alpha, **fixed)[0],),
            "mg_eigenvector": (ct.eigenvector_centrality(g, **fixed)[0],),
            "mg_hits": ct.hits(g)[:2]}
    for name, ref in refs.items():
        err = max(rel_err(a, b.double()) for a, b in zip(results[name], ref))
        require(err <= TOL_CENTRALITY_REL, f"{name} error {err} > {TOL_CENTRALITY_REL}")
        out[name] = dict(rel_err=err, spmv_sum=launches[name]["spmv_sum"])
    log(f"mg weighted path checks: {json.dumps({k: out[k] for k in ('sssp', *refs)})}")
    return out


# -------------------------------------------------- MG analytics path


def check_mg_sample(g, seeds, res, fanouts, with_replacement) -> dict:
    """The MG sampler's compressed result on the graph ``g``: every edge
    an edge with its weight, hops in order; hop h holds, frontier row by
    row, min(K, deg) slots of each row's vertex (K if deg > 0, with
    replacement), the next frontier is hop h's destinations; without
    replacement no row takes an edge id twice."""
    adj = g.csr()
    keys = sorted_edge_keys(adj)
    deg = adj.degrees().long()
    src, dst, w, eid, hop = (res[k] for k in ("sources", "destinations", "weights", "edge_ids",
                                               "hop"))
    require(bool((hop[1:] >= hop[:-1]).all()), "MG sample: hops out of order")
    mult, lo = edge_multiplicity(keys, src, dst, adj.num_minors)
    require(bool((mult > 0).all()), "MG sample: a sampled edge is not in the graph")
    if w is not None:
        require(weights_match(adj, lo, mult, w), "MG sample: sampled weights are not the edges'")
    frontier, counts = seeds.long(), []
    for h, k in enumerate(fanouts):
        per_row = deg[frontier].clamp(max=k) if not with_replacement else (deg[frontier] > 0) * k
        in_hop = hop == h
        counts.append(int(in_hop.sum()))
        require(counts[-1] == int(per_row.sum()), f"MG sample hop {h}: slots != min(K, deg)")
        row = torch.arange(frontier.numel(), device=DEV).repeat_interleave(per_row)
        require(torch.equal(src[in_hop].long(), frontier[row]),
                f"MG sample hop {h}: a slot's source is not its frontier vertex")
        if not with_replacement:
            pair = torch.unique(row * (1 << 40) + eid[in_hop])
            require(pair.numel() == counts[-1], f"MG sample hop {h}: a row took an edge twice")
        frontier = dst[in_hop].long()
    return dict(edges_by_hop=counts)


def check_mg_walks(g, starts, walks) -> dict:
    """Every step an edge, or -1 after a sink (a vertex of out-degree 0)
    and -1 from then on."""
    adj = g.csr()
    keys = sorted_edge_keys(adj)
    deg = adj.degrees()
    require(torch.equal(walks[:, 0], starts.to(walks.dtype)), "MG walks: starts")
    a, b = walks[:, :-1], walks[:, 1:]
    dead = b < 0
    require(bool((dead[:, 1:] >= dead[:, :-1]).all()), "MG walks: a walk came back after -1")
    live = ~dead
    mult, _ = edge_multiplicity(keys, a[live], b[live], adj.num_minors)
    require(bool((mult > 0).all()), "MG walks: a step is not an edge")
    ended = dead & (a >= 0)
    require(bool((deg[a[ended].long()] == 0).all()), "MG walks: a walk ended at a vertex with edges")
    return dict(steps=int(live.sum()), ended=int(dead[:, -1].sum()))


def seeded_pairs(g, n: int, seed: int):
    """n seeded pairs on ``g``'s card: half its CSR edges, half drawn
    vertex pairs."""
    adj = g.csr()
    gen = torch.Generator(device=DEV).manual_seed(seed)
    e = torch.randint(0, adj.num_edges, (n // 2,), generator=gen, device=DEV)
    r = torch.randint(0, g.num_vertices, (2, n - n // 2), generator=gen, device=DEV)
    return (torch.cat([adj.majors[e].long(), r[0]]), torch.cat([adj.minors[e].long(), r[1]]))


def mg_analytics_path(scale: int, small_scale: int, seed: int) -> dict:
    """Phase 13: the MG modules of the last slice on a 1 x 1 NCCL mesh,
    each against the port's single-device result on the same graph, each
    with the counters set to 0 just before and read just after:

    - at ``small_scale``, symmetrized and weighted: mg_triangle_count equal
      to triangle_count per vertex; mg_jaccard, mg_sorensen and mg_overlap
      on MG_PAIRS seeded pairs (half edges), plain and weighted, within
      TOL_MG_SIMILARITY of jaccard, sorensen and overlap;
    - at ``scale`` (the weighted main graph): mg_uniform_neighbor_sample
      SAMPLE_FANOUTS from SAMPLE_STARTS seeds, without and with
      replacement, "replicate" and "shuffle" equal for one generator
      seed, each checked by check_mg_sample; mg_random_walks of
      MG_WALKERS x MG_WALK_LENGTH (check_mg_walks); mg_betweenness and
      mg_edge_betweenness (k = MG_BC_K, ``seed``) within
      TOL_MG_BETWEENNESS_REL of the single-device ones, with as many
      spmm_rows launches, and within TOL_BETWEENNESS_REL of the float64
      ``reference_brandes`` on the same sources;
    - at ``small_scale``: an MGPropertyGraph of the edges as a frame,
      GraphStore.sample_neighbors ([MG_STORE_FANOUT] from SAMPLE_STARTS
      seeds, "in" and "out"), every edge an edge of the frame.

    First-call and warm seconds, idle shares and each phase's peak
    bytes."""
    import numpy as np
    import pandas as pd

    import cugraph_tpu_torch as ct
    from cugraph_tpu_torch.algos.centrality import sample_sources
    from cugraph_tpu_torch.dist import distribute_edgelist, distribute_graph
    from cugraph_tpu_torch.dist import mg_centrality, mg_sampling, mg_similarity
    from cugraph_tpu_torch.dist.mg_property_graph import MGPropertyGraph
    from cugraph_tpu_torch.gnn import GraphStore
    from cugraph_tpu_torch.prims.cuda import spmm_rows, spmv_minplus, spmv_sum

    counters = {"spmv_sum": spmv_sum, "spmv_minplus": spmv_minplus, "spmm_rows": spmm_rows}
    seconds, launches, peak, results = {}, {}, {}, {}

    def run(name, fn):
        for c in counters.values():
            c.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        results[name] = fn()
        sync()
        seconds[name] = time.perf_counter() - t
        launches[name] = {n: c.launches for n, c in counters.items()}
        peak[name] = torch.cuda.max_memory_allocated()

    out = {}
    with one_rank_mesh() as mesh:
        # the small graph: symmetrized, weighted
        src, dst, v_small = rmat_edges(small_scale, seed)
        wgen = torch.Generator(device=DEV).manual_seed(seed + 5)
        w = 1.0 - torch.rand(src.numel(), generator=wgen, device=DEV)
        gs = ct.from_edgelist(src, dst, w, num_vertices=v_small, symmetrize=True, device=DEV)
        t = time.perf_counter()
        mgs = distribute_edgelist(mesh, src, dst, w, num_vertices=v_small, symmetrize=True)
        sync()
        seconds["mg_graph_small"] = time.perf_counter() - t
        frame = pd.DataFrame({"src": src.cpu().numpy(), "dst": dst.cpu().numpy()})
        del src, dst, w
        pairs = seeded_pairs(gs, MG_PAIRS, seed)
        phases = {"mg_triangle_count": lambda: mg_similarity.mg_triangle_count(mesh, mgs)}
        for kind in ("jaccard", "sorensen", "overlap"):
            for wt in (False, True):
                phases[f"mg_{kind}{'_weighted' if wt else ''}"] = (
                    lambda kind=kind, wt=wt: mg_similarity.mg_similarity(mesh, mgs, pairs, kind, wt))
        for name, fn in phases.items():
            run(name, fn)
        run("triangle_count", lambda: ct.triangle_count(gs))
        require(torch.equal(results["mg_triangle_count"], results["triangle_count"].long()),
                "mg_triangle_count differs from triangle_count")
        out["triangles"] = dict(total=int(results["triangle_count"].long().sum()) // 3,
                                vertices=v_small, edges=gs.num_edges)
        sim = {}
        for kind in ("jaccard", "sorensen", "overlap"):
            for wt in (False, True):
                name = f"mg_{kind}{'_weighted' if wt else ''}"
                want = getattr(ct, kind)(gs, pairs, use_weight=wt)[2]
                err = (results[name] - want).abs().max().item()
                require(err <= TOL_MG_SIMILARITY, f"{name} error {err} > {TOL_MG_SIMILARITY}")
                sim[name] = err
        out["similarity_max_abs_err"] = sim
        warm = warm_breakdown(phases)

        # the MG store over the small graph's edges as a frame
        pg = MGPropertyGraph(mesh)
        t = time.perf_counter()
        pg.add_edge_data(frame, ("src", "dst"))
        seconds["mg_property_graph_add_edge_data"] = time.perf_counter() - t
        store = GraphStore(pg, device=DEV)
        ids = torch.from_numpy(frame["src"].to_numpy().copy())
        pick = torch.randint(0, ids.numel(), (SAMPLE_STARTS,),
                             generator=torch.Generator().manual_seed(seed + 6))
        store_seeds = ids[pick].to(DEV)  # vertices with an out-edge, ids of the frame
        edge_keys = torch.from_numpy(np.unique(frame["src"].to_numpy().astype(np.int64) * v_small
                                               + frame["dst"].to_numpy())).to(DEV)
        store_phases = {}
        for edge_dir in ("in", "out"):
            store_phases[f"store_sample_{edge_dir}"] = (
                lambda edge_dir=edge_dir: store.sample_neighbors(
                    store_seeds, fanout=MG_STORE_FANOUT, edge_dir=edge_dir,
                    generator=torch.Generator(device=DEV).manual_seed(seed)))
        for name, fn in store_phases.items():
            run(name, fn)
            df = results[name]
            probe = torch.from_numpy(df["sources"].to_numpy().astype(np.int64) * v_small
                                     + df["destinations"].to_numpy()).to(DEV)
            pos = torch.searchsorted(edge_keys, probe).clamp(max=edge_keys.numel() - 1)
            require(len(df) > 0 and bool((edge_keys[pos] == probe).all()),
                    f"{name}: a sampled edge is not an edge of the frame")
            out[name] = dict(edges=len(df))
        warm.update(warm_breakdown(store_phases))
        del gs, mgs, pg, store, frame, edge_keys, store_phases
        torch.cuda.empty_cache()

        # the main graph, weighted
        g = rmat_graph(scale, seed, weighted=True)
        t = time.perf_counter()
        mgg = distribute_graph(mesh, g)
        sync()
        seconds["mg_graph"] = time.perf_counter() - t
        gen = torch.Generator(device=DEV).manual_seed(seed + 1)
        seeds = torch.randint(0, g.num_vertices, (SAMPLE_STARTS,), generator=gen, device=DEV)
        walk_starts = torch.randint(0, g.num_vertices, (MG_WALKERS,), generator=gen, device=DEV)
        main_phases = {}
        for repl in (False, True):
            for method in ("replicate", "shuffle"):
                main_phases[f"mg_sample_{method}{'_replace' if repl else ''}"] = (
                    lambda method=method, repl=repl: mg_sampling.mg_uniform_neighbor_sample(
                        mesh, mgg, seeds, SAMPLE_FANOUTS, with_replacement=repl, method=method,
                        generator=torch.Generator(device=DEV).manual_seed(seed)))
        main_phases["mg_random_walks"] = lambda: mg_sampling.mg_random_walks(
            mesh, mgg, walk_starts, MG_WALK_LENGTH,
            generator=torch.Generator(device=DEV).manual_seed(seed))
        main_phases["mg_betweenness"] = lambda: mg_centrality.mg_betweenness_centrality(
            mesh, g, k=MG_BC_K, seed=seed)
        main_phases["mg_edge_betweenness"] = lambda: mg_centrality.mg_edge_betweenness_centrality(
            mesh, g, k=MG_BC_K, seed=seed)
        for name, fn in main_phases.items():
            run(name, fn)
        run("betweenness", lambda: ct.betweenness_centrality(g, k=MG_BC_K, seed=seed))
        run("edge_betweenness", lambda: ct.edge_betweenness_centrality(g, k=MG_BC_K, seed=seed))
        for repl in (False, True):
            suffix = "_replace" if repl else ""
            a, b = results[f"mg_sample_replicate{suffix}"], results[f"mg_sample_shuffle{suffix}"]
            for key in ("sources", "destinations", "weights", "edge_ids", "hop"):
                require(torch.equal(a[key], b[key]),
                        f"mg sample{suffix}: replicate and shuffle differ in {key}")
            out[f"mg_sample{suffix}"] = check_mg_sample(g, seeds, a, SAMPLE_FANOUTS, repl)
        out["mg_random_walks"] = check_mg_walks(g, walk_starts, results["mg_random_walks"])
        v = g.num_vertices
        delta, edge = reference_brandes(g, sample_sources(v, MG_BC_K, seed, DEV))
        refs = {"betweenness": delta * (v / MG_BC_K) / ((v - 1) * (v - 2)),
                "edge_betweenness": edge * (v / MG_BC_K) / (v * (v - 1))}
        for name in ("betweenness", "edge_betweenness"):
            err = rel_err(results[f"mg_{name}"], results[name].double())
            require(err <= TOL_MG_BETWEENNESS_REL,
                    f"mg_{name} error {err} > {TOL_MG_BETWEENNESS_REL}")
            ref_err = rel_err(results[f"mg_{name}"], refs[name])
            require(ref_err <= TOL_BETWEENNESS_REL,
                    f"mg_{name} error {ref_err} against float64 > {TOL_BETWEENNESS_REL}")
            n_mg, n_sg = launches[f"mg_{name}"]["spmm_rows"], launches[name]["spmm_rows"]
            require(n_mg > 0 and n_mg == n_sg,
                    f"mg_{name} launched spmm_rows {n_mg} times, the single-device one {n_sg}")
            out[f"mg_{name}"] = dict(rel_err=err, float64_rel_err=ref_err, spmm_rows=n_mg)
        warm.update(warm_breakdown(main_phases))
    log(f"mg analytics path seconds: {json.dumps(seconds)}")
    log(f"mg analytics path launches: {json.dumps(launches)}")
    log(f"mg analytics path peak bytes: {json.dumps(peak)}")
    out.update(seconds=seconds, peak_bytes=peak, warm=warm,
               launches={k: v for k, v in launches.items() if k.startswith(("mg_", "store_"))},
               single_device_launches={k: v for k, v in launches.items()
                                       if not k.startswith(("mg_", "store_"))})
    log(f"mg analytics path checks: {json.dumps({k: out[k] for k in out if k not in ('seconds', 'peak_bytes', 'warm', 'launches', 'single_device_launches')})}")
    return out


# ------------------------------------------------ one-rank NCCL groups


@contextlib.contextmanager
def one_rank_mesh():
    """A 1 x 1 mesh on its own one-rank group (NCCL on the card, gloo
    where DEV is the CPU), each group's communicator made by a first
    collective; the group is destroyed on the way out."""
    import torch.distributed as dist

    from cugraph_tpu_torch.dist import initialize_distributed, make_mesh

    initialize_distributed(device=DEV, init_method=f"tcp://127.0.0.1:{free_port()}",
                           world_size=1, rank=0)
    try:
        mesh = make_mesh((1, 1), device=DEV)
        for group in (None, mesh.row_group, mesh.col_group):
            dist.all_reduce(torch.zeros(1, device=DEV), group=group)
        yield mesh
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------------- fault path


def fault_path(seed: int) -> dict:
    """Each entry point that takes vertex ids from its caller, given one
    id out of range on the card, must raise GraphError before any device
    gather reads it (an out-of-range index in torch's CUDA indexing
    kernels trips a device-side assert, and the process loses its CUDA
    context): pagerank's personalization, the four similarity pairs, the
    starts of the sampler, the walks and node2vec, extract_bfs_paths'
    destinations, mg_pagerank's personalization on a 1 x 1 NCCL mesh.
    modularity takes any integer labels. Then one spmv_sum and one
    spmv_minplus on the same process, each against its plain version:
    the context is alive. No error is caught but the one each call must
    raise."""
    import cugraph_tpu_torch as ct
    from cugraph_tpu_torch.dist import distribute_graph, mg_algos
    from cugraph_tpu_torch.prims.cuda import spmm_rows, spmv_minplus, spmv_sum
    from cugraph_tpu_torch.utils.error import GraphError

    counters = {"spmv_sum": spmv_sum, "spmv_minplus": spmv_minplus, "spmm_rows": spmm_rows}
    src, dst, v = rmat_edges(12, seed)
    g = ct.from_edgelist(src, dst, num_vertices=v, symmetrize=True, device=DEV)
    w = 1.0 - torch.rand(src.numel(), generator=torch.Generator(device=DEV).manual_seed(seed + 3),
                         device=DEV)
    gw = ct.from_edgelist(src, dst, w, num_vertices=v, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    dist_, pred = ct.bfs(g, 0)
    calls = {
        "pagerank.personalization": lambda bad: ct.pagerank(g, personalization=([0, bad], [1.0, 1.0])),
        # -1 marks an empty slot among the sampler's starts: -2 is the bad id
        "uniform_neighbor_sample.start_vertices": lambda bad: ct.uniform_neighbor_sample(
            gw, [0, -2 if bad == -1 else bad], [4, 4], generator=gen),
        "random_walks.start_vertices": lambda bad: ct.random_walks(gw, [bad], 8, generator=gen),
        "random_walks_biased.start_vertices": lambda bad: ct.random_walks(
            gw, [bad], 8, biased=True, generator=gen),
        "node2vec.start_vertices": lambda bad: ct.node2vec(gw, [bad], 8, generator=gen),
        "extract_bfs_paths.destinations": lambda bad: ct.extract_bfs_paths(g, dist_, pred, [1, bad]),
    }
    for kind in ("jaccard", "sorensen", "overlap", "cosine"):
        calls[f"{kind}.pairs"] = lambda bad, fn=getattr(ct, kind): fn(g, pairs=([0, 1], [bad, 2]))
    raised = {}
    for c in counters.values():
        c.launches = 0
    for name, call in calls.items():
        for bad in (v, -1):
            try:
                call(bad)
                raised[f"{name}[{bad}]"] = "returned"
            except GraphError as exc:
                raised[f"{name}[{bad}]"] = str(exc)
    with one_rank_mesh() as mesh:
        mgg = distribute_graph(mesh, g)
        for bad in (v, -1):
            try:
                mg_algos.mg_pagerank(mesh, mgg, personalization=([0, bad], [1.0, 1.0]))
                raised[f"mg_pagerank.personalization[{bad}]"] = "returned"
            except GraphError as exc:
                raised[f"mg_pagerank.personalization[{bad}]"] = str(exc)
    launches = {n: c.launches for n, c in counters.items()}
    log(f"fault path: {json.dumps(raised)}")
    for name, msg in raised.items():
        require(msg != "returned" and "out of range" in msg, f"{name} did not raise: {msg}")
    # modularity: labels + 2^40 and labels - 7 give the labels' Q
    labels = ct.louvain(g)[0].long()
    q = [ct.modularity(g, labels + shift) for shift in (0, 1 << 40, -7)]
    require(max(q) - min(q) <= TOL_MODULARITY, f"modularity moves with the label names: {q}")
    # the CUDA context is alive: both SpMVs against their plain versions
    csc = g.csc()
    x = torch.rand(v, generator=torch.Generator(device=DEV).manual_seed(seed + 1), device=DEV)
    err_sum = check_spmv_sum(csc, x)
    ids = torch.arange(v, dtype=torch.float32, device=DEV)
    check_spmv_minplus(csc, torch.where(x < 0.1, ids, float("inf")), use_weights=False)
    log(f"fault path: {len(raised)} raises, modularity under renamed labels {q}; spmv_sum "
        f"(abs err {err_sum:.3e}) and spmv_minplus agree with their plain versions after them")
    return dict(raised=raised, launches=launches, modularity_renamed=q,
                spmv_sum_abs_err=err_sum, spmv_minplus_exact=True)


# ---------------------------------------------------- MG community path


def mg_community_path(g, refs: dict, seed: int) -> dict:
    """mg_wcc, mg_core_number, mg_louvain and mg_leiden on the community
    path's symmetrized graph, on a 1 x 1 NCCL mesh, each with the
    counters set to 0 just before and read just after: WCC and core
    numbers bit-equal to the single-device results (``refs``, from the
    community path); Louvain and Leiden's Q within TOL_MG_Q of
    modularity64 of their labels, their levels, beside the single-device
    Q, and whether the labels are equal. First-call and warm seconds, idle shares and
    peak bytes, as the community path gives them."""
    from cugraph_tpu_torch.dist import distribute_graph, mg_algos, mg_community
    from cugraph_tpu_torch.dist.mg_graph import unshard_vertex_values
    from cugraph_tpu_torch.prims.cuda import spmm_rows, spmv_minplus, spmv_sum

    counters = {"spmv_sum": spmv_sum, "spmv_minplus": spmv_minplus, "spmm_rows": spmm_rows}
    seconds, launches, results, counts = {}, {}, {}, {}
    torch.cuda.reset_peak_memory_stats()
    with one_rank_mesh() as mesh:
        t = time.perf_counter()
        mgg = distribute_graph(mesh, g)
        sync()
        seconds["mg_graph"] = time.perf_counter() - t
        phases = {
            "mg_wcc": lambda: mg_algos.mg_wcc(mesh, mgg),
            "mg_core_number": lambda: mg_algos.mg_core_number(mesh, mgg, "incoming_outgoing"),
            "mg_louvain": lambda: mg_community.mg_louvain(mesh, mgg),
            "mg_leiden": lambda: mg_community.mg_leiden(mesh, mgg),
        }
        for name, fn in phases.items():
            for c in counters.values():
                c.launches = 0
            t = time.perf_counter()
            results[name] = fn()
            sync()
            seconds[name] = time.perf_counter() - t
            launches[name] = {n: c.launches for n, c in counters.items()}
        counts = dict(wcc_sweeps=mg_algos.mg_wcc.sweeps, core_rounds=mg_algos.mg_core_number.rounds,
                      louvain_levels=mg_community.mg_louvain.levels,
                      leiden_levels=mg_community.mg_leiden.levels)
        wcc = unshard_vertex_values(mgg, results["mg_wcc"])
        core = unshard_vertex_values(mgg, results["mg_core_number"])
        log(f"mg community path seconds: {json.dumps(seconds)}")
        log(f"mg community path launches: {json.dumps(launches)}, {json.dumps(counts)}")
        out = dict(seconds=seconds, launches=launches, counts=counts,
                   max_memory_allocated=torch.cuda.max_memory_allocated())
        out["warm"] = warm_breakdown(phases)
    require(launches["mg_wcc"]["spmv_minplus"] == 2 * counts["wcc_sweeps"],
            "mg_wcc must launch spmv_minplus twice a sweep")
    require(launches["mg_core_number"]["spmv_sum"] == 2 * counts["core_rounds"],
            "mg_core_number must launch spmv_sum twice a round (both directions)")
    require(torch.equal(wcc, refs["wcc"]), "mg_wcc differs from weakly_connected_components")
    require(torch.equal(core, refs["core_number"]), "mg_core_number differs from core_number")
    for name in ("louvain", "leiden"):
        labels, q = results[f"mg_{name}"]
        sg_labels, sg_q = refs[name]
        q64 = modularity64(g, labels)
        require(abs(q - q64) <= TOL_MG_Q, f"mg_{name} Q {q} vs float64 {q64}")
        require(labels.shape == (g.num_vertices,) and labels.device.type == DEV.type,
                f"mg_{name} labels")
        out[f"mg_{name}"] = dict(modularity=q, modularity64=q64, abs_err=abs(q - q64),
                                 levels=counts[f"{name}_levels"],
                                 single_device_modularity=sg_q,
                                 communities=int(torch.unique(labels).numel()),
                                 labels_equal_single_device=bool(torch.equal(labels, sg_labels)))
    out["wcc"] = dict(components=int(torch.unique(wcc).numel()), sweeps=counts["wcc_sweeps"])
    out["core_number"] = dict(max=int(core.max()), rounds=counts["core_rounds"])
    log(f"mg community path checks: {json.dumps({k: out[k] for k in ('wcc', 'core_number', 'mg_louvain', 'mg_leiden')})}")
    return out


# --------------------------------------------------------- service path


def service_path(scale: int, seed: int) -> dict:
    """A CugraphTpuServer on localhost over the scale-``scale`` R-MAT
    edges (each once) written as a CSV to a temporary directory: PageRank, BFS, SSSP,
    WCC and Katz asked for through CugraphTpuClient, each against the
    port's api.algorithms call on a Graph built from the same frame
    (timed beside it); then distribute_graph([1, 1]) (the handler starts
    its own one-rank NCCL group) and the MG-routed results against the
    single-device ones, and one MG-routed uniform_neighbor_sample request
    (SAMPLE_FANOUTS from the frame's first SAMPLE_STARTS sources), each of
    its edges an edge of the frame."""
    import os
    import tempfile

    import numpy as np
    import pandas as pd

    from cugraph_tpu_torch import api
    from cugraph_tpu_torch.prims.cuda import spmm_rows, spmv_minplus, spmv_sum
    from cugraph_tpu_torch.service import CugraphTpuClient, CugraphTpuServer

    counters = {"spmv_sum": spmv_sum, "spmv_minplus": spmv_minplus, "spmm_rows": spmm_rows}
    src, dst, v = rmat_edges(scale, seed)
    # the handler builds simple graphs: each edge once
    frame = pd.DataFrame({"src": src.cpu().numpy(), "dst": dst.cpu().numpy()}).drop_duplicates()
    del src, dst
    gapi = api.Graph(directed=True, device=DEV).from_pandas_edgelist(frame, "src", "dst")
    alpha = 1.0 / (int(gapi.core.in_degrees().max()) + 1)
    requests = {
        "pagerank": ((), dict(tol=1e-6), lambda: api.algorithms.pagerank(gapi, tol=1e-6), "pagerank"),
        "bfs": ((0,), {}, lambda: api.algorithms.bfs(gapi, 0), "distance"),
        "sssp": ((0,), {}, lambda: api.algorithms.sssp(gapi, 0), "distance"),
        "wcc": ((), {}, lambda: api.algorithms.weakly_connected_components(gapi), "labels"),
        "katz_centrality": ((), dict(alpha=alpha, tol=1e-6),
                            lambda: api.algorithms.katz_centrality(gapi, alpha=alpha, tol=1e-6),
                            "katz_centrality"),
    }
    seconds, launches, out = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "edges.csv")
        t = time.perf_counter()
        frame.to_csv(path, index=False)
        seconds["write_csv"] = time.perf_counter() - t
        server = CugraphTpuServer(port=0, device=DEV)
        server.start()
        try:
            client = CugraphTpuClient(port=server.port)
            t = time.perf_counter()
            client.load_csv_as_edge_data(path, vertex_col_names=["src", "dst"])
            seconds["load_csv_as_edge_data"] = time.perf_counter() - t
            info = client.get_graph_info(0)
            require(info["num_edges"] == len(frame), f"graph info {info}")

            def ask(prefix):
                res = {}
                for name, (args, kw, core, col) in requests.items():
                    for c in counters.values():
                        c.launches = 0
                    t = time.perf_counter()
                    res[name] = client.call(name, *args, **kw)
                    seconds[f"{prefix}{name}_request"] = time.perf_counter() - t
                    launches[f"{prefix}{name}"] = {n: c.launches for n, c in counters.items()}
                return res

            single = ask("")
            for name, (args, kw, core, col) in requests.items():
                t = time.perf_counter()
                df = core()
                sync()
                seconds[f"{name}_core"] = time.perf_counter() - t
                got = dict(zip(single[name]["vertex"], single[name][col]))
                want = dict(zip(df["vertex"].tolist(), df[col].tolist()))
                require(got == want, f"service {name} differs from api.algorithms.{name}")
            t = time.perf_counter()
            out["distribute_graph"] = client.call("distribute_graph", 0, [1, 1])
            seconds["distribute_graph_request"] = time.perf_counter() - t
            multi = ask("mg_")
            for name, (args, kw, core, col) in requests.items():
                a = np.asarray(multi[name][col], dtype=np.float64)
                b = np.asarray(single[name][col], dtype=np.float64)
                require(multi[name]["vertex"] == single[name]["vertex"], f"mg {name} vertices")
                if name in ("pagerank", "katz_centrality"):
                    err = float(np.abs(a - b).max() / np.abs(b).max())
                    require(err <= TOL_CENTRALITY_REL, f"mg {name} error {err}")
                    out[f"mg_{name}_rel_err"] = err
                else:
                    require(np.array_equal(a, b), f"mg {name} differs from the single-device one")
            starts = frame["src"].iloc[:SAMPLE_STARTS].to_numpy()
            for c in counters.values():
                c.launches = 0
            t = time.perf_counter()
            sample = client.call("uniform_neighbor_sample", starts.tolist(), list(SAMPLE_FANOUTS))
            seconds["mg_uniform_neighbor_sample_request"] = time.perf_counter() - t
            launches["mg_uniform_neighbor_sample"] = {n: c.launches for n, c in counters.items()}
            keys = np.unique(frame["src"].to_numpy().astype(np.int64) * v
                             + frame["dst"].to_numpy())
            probe = (np.asarray(sample["sources"], dtype=np.int64) * v
                     + np.asarray(sample["destinations"], dtype=np.int64))
            pos = np.searchsorted(keys, probe).clip(max=len(keys) - 1)
            require(len(probe) > 0 and bool((keys[pos] == probe).all()),
                    "an MG-routed sampled edge is not an edge of the frame")
            out["mg_sample"] = dict(edges=len(probe))
        finally:
            server.stop()
    import torch.distributed as dist

    require(not dist.is_initialized(), "the server's stop must end the handler's group")
    require(launches["pagerank"]["spmv_sum"] > 0 and launches["mg_pagerank"]["spmv_sum"] > 0,
            "service pagerank must launch spmv_sum")
    require(launches["bfs"]["spmv_minplus"] > 0 and launches["mg_wcc"]["spmv_minplus"] > 0,
            "service bfs and MG wcc must launch spmv_minplus")
    out.update(seconds=seconds, launches=launches, num_edges=len(frame), vertices=v)
    log(f"service path seconds: {json.dumps(seconds)}")
    log(f"service path launches: {json.dumps(launches)}")
    return out


# -------------------------------------------------------- examples path


def examples_path() -> dict:
    """Both example scripts' main() on the card at their default sizes:
    the trainer's loss must fall (the mean of its last 3 steps under that
    of its first 3); community detection prints its Q. The trainer's
    blocks at its default scale 14 hold fewer than DENSE_MAX_VERTICES
    vertices and take the dense branch, so it runs once more at
    EXAMPLE_SPARSE_SCALE, where they take spmm_rows, which must run."""
    import contextlib as _cl
    import io

    from cugraph_tpu_torch.examples import community_detection, train_graphsage
    from cugraph_tpu_torch.prims.cuda import spmm_rows, spmv_minplus, spmv_sum

    counters = {"spmv_sum": spmv_sum, "spmv_minplus": spmv_minplus, "spmm_rows": spmm_rows}
    out, launches, seconds = {}, {}, {}
    for name, main_fn, argv in (
            ("train_graphsage", train_graphsage.main, []),
            ("train_graphsage_sparse", train_graphsage.main, ["--scale", str(EXAMPLE_SPARSE_SCALE)]),
            ("community_detection", community_detection.main, [])):
        for c in counters.values():
            c.launches = 0
        buf = io.StringIO()
        t = time.perf_counter()
        with _cl.redirect_stdout(buf):
            out[name] = main_fn(argv + ["--device", DEV.type])
        sync()
        seconds[name] = time.perf_counter() - t
        launches[name] = {n: c.launches for n, c in counters.items()}
        log(f"examples path {name}: {buf.getvalue().strip()}")
    for name in ("train_graphsage", "train_graphsage_sparse"):
        losses = out[name]["losses"]
        require(all(math.isfinite(x) for x in losses), f"a {name} loss is not finite")
        require(sum(losses[-3:]) < sum(losses[:3]), f"the {name} loss did not fall: {losses}")
    require(launches["train_graphsage_sparse"]["spmm_rows"] > 0,
            "the trainer at EXAMPLE_SPARSE_SCALE must launch spmm_rows")
    log(f"examples path: {json.dumps(launches)}, seconds {json.dumps(seconds)}")
    return dict(launches=launches, seconds=seconds, train=out["train_graphsage"],
                train_sparse=out["train_graphsage_sparse"], community=out["community_detection"])


# ----------------------------------------------------------------- main

SOURCES = {
    "spmv_sum": ("cugraph_tpu_torch/csrc/spmv.cu", "cugraph_tpu/prims/pallas/spmv3.py:862"),
    "spmv_minplus": ("cugraph_tpu_torch/csrc/spmv.cu", "cugraph_tpu/prims/pallas/spmv2.py:1675"),
    "spmm_rows": ("cugraph_tpu_torch/csrc/spmm_row.cu", "cugraph_tpu/prims/pallas/spmm_row.py:225"),
    "cumsum_flat": ("cugraph_tpu_torch/csrc/scan.cu", "cugraph_tpu/prims/pallas/scan.py:41"),
    "assemble_chunks": ("cugraph_tpu_torch/csrc/assemble.cu",
                        "cugraph_tpu/prims/pallas/spmv2.py:1605"),
    "stream_scale": ("cugraph_tpu_torch/csrc/probes.cu", "benchmarks/microbench_tpu.py:56"),
    "gather_rows": ("cugraph_tpu_torch/csrc/probes.cu", "benchmarks/microbench4_rowgather.py:42"),
    "gather_window_sum": ("cugraph_tpu_torch/csrc/probes.cu",
                          "benchmarks/microbench4_rowgather.py:68"),
    "multiwin_reduce": ("cugraph_tpu_torch/csrc/probes.cu", "benchmarks/microbench_tpu.py:294"),
    "seg_scan_rows": ("cugraph_tpu_torch/csrc/probes.cu", "benchmarks/microbench_tpu.py:354"),
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
    # a site as def / pallas_call; microbench3_tpu.py's bodies go through
    # block_call (29 / 34)
    "stream_scale": ["benchmarks/microbench_tpu.py:67",
                     "benchmarks/microbench3_tpu.py:69 (copy_kern, block_call 29 / 34)"],
    "gather_rows": ["benchmarks/microbench4_rowgather.py:53",
                    "benchmarks/microbench5_rowgather.py:26 / 36",
                    "benchmarks/microbench6_bf16row.py:26 / 36"],
    "gather_window_sum": ["benchmarks/microbench4_rowgather.py:120"],
    "multiwin_reduce": ["benchmarks/microbench_tpu.py:335",
                        "benchmarks/microbench3_tpu.py:187 (mwr_kern; mwr_call 219 / 220)"],
    "seg_scan_rows": ["benchmarks/microbench_tpu.py:379",
                      "benchmarks/microbench3_tpu.py:237 (seg_kern, block_call 29 / 34)"],
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
    segment_checks(args.seed)
    g = rmat_graph(args.scale, args.seed)
    kernels = full_shape_kernels(g, args.seed)
    del g
    torch.cuda.empty_cache()
    log(f"kernel checks: {time.perf_counter() - t:.1f} s")

    # 3b. vertex ids out of range raise, and the CUDA context stays alive
    fpath = fault_path(args.seed)

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

    # 7b. the benchmarks/ probes' entry point and its five kernels
    probes = probes_path(args.seed)
    torch.cuda.empty_cache()

    # 8. sampling and link prediction
    spath = sampling_path(g, min(SMALL_SCALE, args.scale), args.seed)
    del g
    torch.cuda.empty_cache()

    # 9. community path, then the MG community path on its graph
    cpath, refs = community_path(args.scale, min(SMALL_SCALE, args.scale), args.seed)
    t = time.perf_counter()
    mcpath = mg_community_path(refs.pop("g"), refs, args.seed)
    mcpath["path_s"] = time.perf_counter() - t
    log(f"mg community path: {mcpath['path_s']:.1f} s")
    del refs
    torch.cuda.empty_cache()

    # 10. the API path
    t = time.perf_counter()
    apath = api_path(args.scale, min(SMALL_SCALE, args.scale), args.seed)
    apath["path_s"] = time.perf_counter() - t
    log(f"api path: {apath['path_s']:.1f} s")
    torch.cuda.empty_cache()

    # 11. the training path, on the main path's unweighted graph
    g = rmat_graph(args.scale, args.seed)
    tpath = train_path(g, args.seed)
    del g
    torch.cuda.empty_cache()

    # 12. the MG weighted path
    t = time.perf_counter()
    mwpath = mg_weighted_path(rmat_graph(args.scale, args.seed, weighted=True), args.seed)
    mwpath["path_s"] = time.perf_counter() - t
    log(f"mg weighted path: {mwpath['path_s']:.1f} s")
    torch.cuda.empty_cache()

    # 13. the MG analytics path: similarity, triangles, sampling, walks,
    # betweenness and the MG GNN store
    t = time.perf_counter()
    mapath = mg_analytics_path(args.scale, min(SMALL_SCALE, args.scale), args.seed)
    mapath["path_s"] = time.perf_counter() - t
    log(f"mg analytics path: {mapath['path_s']:.1f} s")
    torch.cuda.empty_cache()

    # 14. the service over HTTP on localhost, then (15.) the example scripts
    t = time.perf_counter()
    svpath = service_path(min(SERVICE_SCALE, args.scale), args.seed)
    svpath["path_s"] = time.perf_counter() - t
    log(f"service path: {svpath['path_s']:.1f} s")
    t = time.perf_counter()
    expath = examples_path()
    expath["path_s"] = time.perf_counter() - t
    log(f"examples path: {expath['path_s']:.1f} s")

    def counted(name, launches):
        """A path's launches of ``name``: its count where ``launches`` is
        {kernel: n}, the sum over its phases where it is {phase: {kernel:
        n}}; None where the path holds no counter of ``name``."""
        if not isinstance(launches.get(name, {}), dict):
            return launches[name]
        got = [n[name] for n in launches.values() if isinstance(n, dict) and name in n]
        return sum(got) if got else None

    mg_launches = {k: n + mgp["extra_launches"][k] for k, n in mgp["launches"].items()}
    paths = dict(main_path=path["launches"], mg_path=mg_launches, weighted_path=wpath["launches"],
                 gradient_path=path["gradient"]["launches"], scan_assemble_path=scan["launches"],
                 probes_path=probes["launches"], sampling_path=spath["launches"],
                 community_path=cpath["launches"], api_path=apath["launches"],
                 train_path=tpath["launches"], mg_weighted_path=mwpath["launches"],
                 mg_analytics_path=mapath["launches"], fault_path=fpath["launches"],
                 mg_community_path=mcpath["launches"], service_path=svpath["launches"],
                 examples_path=expath["launches"])
    lines = []
    for name, m in dict(kernels, **scan["kernels"], **probes["kernels"]).items():
        source, replaces = SOURCES[name]
        # only the paths that count the kernel: each count was set to 0
        # just before the path and read just after it
        by_path = {p: n for p, l in paths.items() if (n := counted(name, l)) is not None}
        own = next(p for p in ("scan_assemble_path", "probes_path", "main_path") if p in by_path)
        launches = by_path[own]
        extra = {"weighted": weighted[name]} if name in weighted else {}
        if name in mgp["block"]:
            extra["mg_block"] = mgp["block"][name]
        if name == "spmm_rows":
            extra["out_block"] = tpath["mg"]["out_block"]
        if name in path["segments"]:
            extra["segments"] = dict(k=path["segments"]["k"], **path["segments"][name])
        lines.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            also_replaces=ALSO_REPLACES[name], launches=launches,
            launches_by_path=by_path, **m, **extra,
        ))
    log(f"total: {time.perf_counter() - t_start:.1f} s after device setup")
    print(json.dumps({"kernels": lines, "scale": args.scale, "main_path": path,
                      "mg_path": mgp, "weighted_path": wpath, "scan_assemble_path": scan,
                      "probes_path": probes, "sampling_path": spath, "community_path": cpath,
                      "api_path": apath,
                      "train_path": tpath, "mg_weighted_path": mwpath,
                      "mg_analytics_path": mapath, "fault_path": fpath,
                      "mg_community_path": mcpath, "service_path": svpath,
                      "examples_path": expath, "card": smi}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
