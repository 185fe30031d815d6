// One dense level of BFS, for sm_90a: a bottom-up pull over the CSC.
//
// Replaces no TPU kernel. The JAX package runs a dense BFS level as a
// min-plus SpMV (spmv2.py:_sort_reduce_call, reduce="min"; the port's
// spmv_minplus, which SSSP, mg_bfs and the tools still launch): every
// stored edge is read and every row reduced, then the rows already visited
// are thrown away. This kernel computes the same level from what the
// level keeps: for each unvisited row v, the smallest in-neighbour of v on
// the frontier, its predecessor (Beamer, Asanovic & Patterson, "Direction-
// Optimizing Breadth-First Search", SC'12: the bottom-up step, as GAP's
// reference BFS runs it). Two facts make most of a sweep unnecessary and
// keep the result bit for bit:
//   - a visited row's value is never used, so it reads no minor;
//   - each CSC row holds its in-neighbours in ascending id order (the
//     adjacency is sorted by (major, minor)), so the first frontier
//     in-neighbour an ascending scan finds is the smallest: a row stops at
//     its first hit.
//
// Bound on an H100 SXM: memory, in two streams. The minors the level scans
// (4 B each, read once) and, for each, a 4-byte gather of the frontier's
// bitmap: V / 8 bytes (2 MB at 2^24 vertices, where min-plus's f32 x was
// 64 MB and needed 3 column segments, so 3 passes over the rows), which
// the L2 holds, so one pass suffices. An unvisited row reads its offsets
// (4 B); every row its visited flag (1 B) and writes new (1 B); a found row
// writes dist and pred (4 B each). Measured (PERF.md §6), a dense level is
// bound by the gathers, not by the bytes: a level that scans nearly every
// edge (GAP's Urand at s24, frontier 0.2%) takes ~3.2 ms for 534M minors,
// 2.1 GB, where the bytes alone take 0.7 ms. What the design does about it:
//   - the rows the level can skip read nothing more, and a row stops at the
//     chunk of its first hit (at s24 a query's dense levels scan 15% of the
//     stored edges their full sweeps would read on GAP's Kron, 43% on Urand);
//   - a summary of the frontier, a bit for each 64 ids (32 KB at 2^24), is
//     tested before the bitmap: read through the read-only path (__ldg),
//     an SM's L1 keeps it, so where the frontier is small most gathers end
//     there, not in the L2 (the first dense level on Urand at 8 lanes, 4.66
//     -> 3.04 ms; the summary staged in shared memory was no faster);
//   - a lane loads kMinorsPerLane minors (__ldcs, evict first, so that they
//     do not push the bitmap out of the L2) before it tests any, so each
//     group keeps that many gathers in flight;
//   - a warp's 32 rows are written by their own lanes at the end, so the
//     stores of new, dist, pred and visited are coalesced.
//
// Design. Three launches on the caller's stream, with no atomics on the
// outputs: every row is written by exactly one thread, so the same bits
// come out every run.
//   1. pack: the frontier (bool, V bytes) into the bitmap, one thread a
//      pair of words from four 16-byte loads, and the summary, a warp's 32
//      pairs one word by a ballot.
//   2. light rows (in-degree <= heavy_degree): each warp takes 32
//      consecutive rows, finds the active ones (unvisited, with an
//      in-edge) with one ballot, and hands them out to its groups of
//      kLanes lanes in rank order; a group scans its row in chunks of
//      kLanes * kMinorsPerLane ascending minors and stops at the first
//      chunk with a hit, whose lowest position (smallest minor j first,
//      then the lowest lane) is the smallest frontier in-neighbour. This
//      launch also writes new = 0 for every visited row, heavy or light.
//   3. heavy rows (in-degree > heavy_degree, listed once per adjacency,
//      prims/cuda/_partition.py): a block reads kThreads of them at a time,
//      lists the unvisited ones in shared memory, and scans each with the
//      whole block: a first chunk of kThreads minors (a hub's first hit is
//      often early), then chunks of kThreads * kMinorsPerLane, a block-wide
//      vote per chunk (__syncthreads_or), the lowest hit position by a
//      shared atomicMin. Without it an unvisited hub scanned by a few lanes
//      holds up its query (kron24.bfs's p95 12% higher with no heavy row:
//      _partition.py, PULL_HEAVY_DEGREE).
// The grids are the resident blocks of the card (occupancy), looping over
// their rows, so each block adds its count once: counts[0] += the minors
// it read, one atomicAdd at its end; block 0 of the light rows adds the
// stored edges (what a full sweep of the level reads) to counts[1]. The
// query path never reads them.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinorsPerLane = 4;
// lanes of a group that scans one row. A query's dense levels from one
// seeded root on the benchmark's s24 graphs (H100, time_spmv.py --bfs;
// PERF.md §6), with a block a row above 256 in-edges: Urand 7.92 ms at 4
// lanes, 8.64 at 8; Kron 4.15, 3.96 (16 and 32 lanes were slower on both
// graphs). Retune by editing this and rebuilding.
constexpr int kLanes = 4;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxDevices = 64;

// u is on the frontier: its block of 64 ids has one (the summary, 32 KB
// at 2^24 ids, which an SM's L1 keeps), and then its own bit (the L2)
__device__ __forceinline__ bool on_frontier(const unsigned* __restrict__ bits,
                                            const unsigned* __restrict__ summary, int u) {
  if (((__ldg(summary + (u >> 11)) >> ((u >> 6) & 31)) & 1u) == 0) return false;
  return (__ldg(bits + (u >> 5)) >> (u & 31)) & 1u;
}

// The 32 bool bytes at p (each 0 or 1) as one word, bit i = p[i]: two
// 16-byte loads where the bytes are 16-byte aligned and all present
__device__ __forceinline__ unsigned pack32(const unsigned char* __restrict__ p, long long have,
                                           bool aligned) {
  unsigned word = 0;
  if (aligned && have >= 32) {
    const uint4* q4 = reinterpret_cast<const uint4*>(p);
    const uint4 a = __ldcs(q4), b = __ldcs(q4 + 1);
    const unsigned q[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      // the four bytes of q[k] to bits 4k .. 4k + 3
      const unsigned x = q[k];
      word |= ((x & 1u) | ((x >> 7) & 2u) | ((x >> 14) & 4u) | ((x >> 21) & 8u)) << (4 * k);
    }
  } else {
    for (int i = 0; i < 32 && i < have; ++i) word |= static_cast<unsigned>(p[i] != 0) << i;
  }
  return word;
}

// One thread per 64 ids t: bits[2t], bits[2t + 1] (bit i of bits[w] =
// frontier[32 w + i]) and summary bit t (any of the 64 on the frontier),
// a warp's 32 summary bits one word. aligned: frontier starts on 16 bytes.
__global__ void __launch_bounds__(kThreads)
pack_kernel(const unsigned char* __restrict__ frontier, unsigned* __restrict__ bits,
            unsigned* __restrict__ summary, int n, int pairs, bool aligned) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  bool any = false;
  if (t < pairs) {
    const long long base = 64LL * t;
    const unsigned lo = pack32(frontier + base, n - base, aligned);
    const unsigned hi = pack32(frontier + base + 32, n - base - 32, aligned);
    bits[2 * t] = lo;
    bits[2 * t + 1] = hi;
    any = (lo | hi) != 0;
  }
  const unsigned word = __ballot_sync(kFullMask, any);
  if ((threadIdx.x & 31) == 0 && t < pairs) summary[t >> 5] = word;
}

// The block's minors scanned into counts[0], one atomicAdd.
__device__ __forceinline__ void add_scanned(unsigned long long scanned,
                                            unsigned long long* __restrict__ counts) {
  __shared__ unsigned long long part[kWarps];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) scanned += __shfl_down_sync(kFullMask, scanned, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) part[warp] = scanned;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long s = 0;
    for (int i = 0; i < kWarps; ++i) s += part[i];
    atomicAdd(counts, s);
  }
}

// Rows of in-degree <= heavy_degree, a group of kLanes lanes each, and
// new = 0 for every visited row.
__global__ void __launch_bounds__(kThreads)
light_kernel(const int* __restrict__ offsets, const int* __restrict__ minors,
             const unsigned* __restrict__ bits, const unsigned* __restrict__ summary,
             unsigned char* __restrict__ visited, int* __restrict__ dist, int* __restrict__ pred,
             unsigned char* __restrict__ next, unsigned long long* __restrict__ counts, int n,
             int heavy_degree, int depth) {
  constexpr int kGroups = 32 / kLanes;
  constexpr int kChunk = kLanes * kMinorsPerLane;
  __shared__ int row_start[kWarps][32];
  __shared__ int row_deg[kWarps][32];
  __shared__ int row_hit[kWarps][32];  // a row's smallest frontier in-neighbour, or -1
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int group = lane / kLanes, sub = lane % kLanes;
  const unsigned gmask = ((1u << kLanes) - 1u) << (group * kLanes);
  unsigned long long scanned = 0;
  const long long stride = 32LL * kWarps * gridDim.x;
  for (long long base = 32LL * (static_cast<long long>(blockIdx.x) * kWarps + warp); base < n;
       base += stride) {
    const int v = static_cast<int>(base) + lane;
    int start = 0, deg = 0;
    bool writes = v < n, active = false;  // writes: this launch writes row v
    if (writes && !visited[v]) {  // a visited row reads no offset
      start = __ldcs(offsets + v);
      deg = __ldcs(offsets + v + 1) - start;
      writes = deg <= heavy_degree;
      active = writes && deg > 0;
    }
    row_start[warp][lane] = start;
    row_deg[warp][lane] = deg;
    unsigned todo = __ballot_sync(kFullMask, active);
    __syncwarp();
    // this group's rows: the active ones of rank group, group + kGroups, ...
    for (int k = 0; k < group; ++k) todo &= todo - 1;
    while (todo != 0) {
      const int r = __ffs(todo) - 1;
      const int s0 = row_start[warp][r], d = row_deg[warp][r];
      int hit = -1;  // the smallest in-neighbour on the frontier
      for (int c = 0; c < d && hit < 0; c += kChunk) {
        int u[kMinorsPerLane];
        bool on[kMinorsPerLane];
#pragma unroll
        for (int j = 0; j < kMinorsPerLane; ++j) {
          const int i = c + j * kLanes + sub;
          u[j] = i < d ? __ldcs(minors + s0 + i) : -1;
        }
#pragma unroll
        for (int j = 0; j < kMinorsPerLane; ++j) on[j] = u[j] >= 0 && on_frontier(bits, summary, u[j]);
        if (sub == 0) scanned += min(d - c, kChunk);
#pragma unroll
        for (int j = 0; j < kMinorsPerLane; ++j) {
          const unsigned b = __ballot_sync(gmask, on[j]) & gmask;
          const int u_b = __shfl_sync(gmask, u[j], b != 0 ? __ffs(b) - 1 : lane);
          if (hit < 0 && b != 0) hit = u_b;
        }
      }
      if (sub == 0) row_hit[warp][r] = hit;
      for (int k = 0; k < kGroups; ++k) todo &= todo - 1;
    }
    __syncwarp();
    // each lane writes its own row, so the warp's stores are coalesced
    if (writes) {
      const int hit = active ? row_hit[warp][lane] : -1;
      next[v] = hit >= 0;
      if (hit >= 0) {
        dist[v] = depth + 1;
        pred[v] = hit;
        visited[v] = 1;
      }
    }
    __syncwarp();  // the rows' slots are read before the next 32 overwrite them
  }
  add_scanned(scanned, counts);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    atomicAdd(counts + 1, static_cast<unsigned long long>(__ldg(offsets + n)));
  }
}

// Unvisited rows of in-degree > heavy_degree (heavy_rows, ascending), a
// block each. A block takes the heavy rows in batches of up to kThreads,
// sized so that the batches cover the grid: each thread reads one row's
// visited flag (and, unvisited, its offsets), the unvisited rows are listed
// in shared memory (in order, by warp ballots), and the block then scans
// them one by one, so a visited hub costs one thread one flag.
__global__ void __launch_bounds__(kThreads)
heavy_kernel(const int* __restrict__ offsets, const int* __restrict__ minors,
             const unsigned* __restrict__ bits, const unsigned* __restrict__ summary,
             const int* __restrict__ heavy_rows, int n_heavy,
             unsigned char* __restrict__ visited, int* __restrict__ dist, int* __restrict__ pred,
             unsigned char* __restrict__ next, unsigned long long* __restrict__ counts,
             int depth) {
  __shared__ int row_id[kThreads], row_start[kThreads], row_deg[kThreads];
  __shared__ int warp_rows[kWarps];
  __shared__ int first;  // the lowest position of a hit in the row
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned long long scanned = 0;
  const int batch = min(kThreads, static_cast<int>((n_heavy + gridDim.x - 1) / gridDim.x));
  for (long long base = static_cast<long long>(blockIdx.x) * batch; base < n_heavy;
       base += static_cast<long long>(gridDim.x) * batch) {
    const long long h = base + tid;
    int v = 0, start = 0, deg = 0;
    bool todo = false;
    if (tid < batch && h < n_heavy) {
      v = __ldg(heavy_rows + h);
      todo = !visited[v];
      if (todo) {
        start = __ldg(offsets + v);
        deg = __ldg(offsets + v + 1) - start;
      }
    }
    const unsigned mask = __ballot_sync(kFullMask, todo);
    if (lane == 0) warp_rows[warp] = __popc(mask);
    __syncthreads();
    int slot = __popc(mask & ((1u << lane) - 1u)), rows = 0;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) slot += warp_rows[w];
      rows += warp_rows[w];
    }
    if (todo) {
      row_id[slot] = v;
      row_start[slot] = start;
      row_deg[slot] = deg;
    }
    __syncthreads();
    for (int k = 0; k < rows; ++k) {
      const int r = row_id[k], s0 = row_start[k], d = row_deg[k];
      if (tid == 0) first = INT_MAX;
      __syncthreads();
      for (int c = 0; c < d; c += kThreads * (c == 0 ? 1 : kMinorsPerLane)) {
        // the first chunk one minor a thread, since a hub's first hit is
        // often early; later ones kMinorsPerLane
        const int per = c == 0 ? 1 : kMinorsPerLane;
        int u[kMinorsPerLane];
#pragma unroll
        for (int j = 0; j < kMinorsPerLane; ++j) {
          const int i = c + j * kThreads + tid;
          u[j] = j < per && i < d ? __ldcs(minors + s0 + i) : -1;
        }
        int mine = INT_MAX;  // this thread's lowest hit position (j ascending)
#pragma unroll
        for (int j = kMinorsPerLane - 1; j >= 0; --j) {
          if (u[j] >= 0 && on_frontier(bits, summary, u[j])) mine = c + j * kThreads + tid;
        }
        if (tid == 0) scanned += min(d - c, per * kThreads);
        if (__syncthreads_or(mine != INT_MAX)) {
          if (mine != INT_MAX) atomicMin(&first, mine);
          __syncthreads();
          break;
        }
      }
      if (tid == 0) {
        if (first != INT_MAX) {
          dist[r] = depth + 1;
          pred[r] = __ldg(minors + s0 + first);
          visited[r] = 1;
          next[r] = 1;
        } else {
          next[r] = 0;
        }
      }
      __syncthreads();  // first is read before the next row resets it
    }
  }
  add_scanned(scanned, counts);
}

// The blocks of `kernel` the card holds at once (its SMs times the
// occupancy), kept per device and kernel (slot 0 light, 1 heavy): the grid
// of a row loop.
int resident_blocks(const void* kernel, int slot) {
  static int cache[kMaxDevices][2];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices) return 0;
  int& kept = cache[dev][slot];
  if (kept == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0) !=
        cudaSuccess) {
      return 0;
    }
    kept = sms * (per_sm > 0 ? per_sm : 1);
  }
  return kept;
}

}  // namespace

// C interface, loaded with ctypes. offsets (n + 1) and minors are the CSC's
// (int32, each row's minors ascending); frontier, visited and next are
// bool (one byte) of n; dist and pred int32 of n, written where a row is
// found (dist = depth + 1); bits is scratch of 2 p + ceil(p / 32) words, p =
// ceil(n / 64): the frontier's bitmap, then its summary (a bit a 64 ids);
// heavy_rows the n_heavy ascending ids of the rows of in-degree >
// heavy_degree; counts two uint64 added to (minors read, stored edges).
// The launches go on the caller's stream and do not synchronise; the
// return value is cudaGetLastError() after them.
extern "C" int cgt_bfs_pull_level(const int* offsets, const int* minors,
                                  const unsigned char* frontier, unsigned* bits,
                                  unsigned char* visited, int* dist, int* pred,
                                  unsigned char* next, const int* heavy_rows, int n_heavy,
                                  unsigned long long* counts, int n, int heavy_degree, int depth,
                                  void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int pairs = (n + 63) / 64;
  unsigned* summary = bits + 2 * static_cast<long long>(pairs);
  const bool aligned = reinterpret_cast<unsigned long long>(frontier) % 16 == 0;
  pack_kernel<<<(pairs + kThreads - 1) / kThreads, kThreads, 0, s>>>(frontier, bits, summary, n,
                                                                     pairs, aligned);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  int most = resident_blocks(reinterpret_cast<const void*>(light_kernel), 0);
  if (most == 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long needed = (static_cast<long long>(n) + 32 * kWarps - 1) / (32 * kWarps);
  light_kernel<<<static_cast<int>(needed < most ? needed : most), kThreads, 0, s>>>(
      offsets, minors, bits, summary, visited, dist, pred, next, counts, n, heavy_degree, depth);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0 || n_heavy <= 0) return rc;
  most = resident_blocks(reinterpret_cast<const void*>(heavy_kernel), 1);
  if (most == 0) return static_cast<int>(cudaErrorInvalidValue);
  heavy_kernel<<<n_heavy < most ? n_heavy : most, kThreads, 0, s>>>(
      offsets, minors, bits, summary, heavy_rows, n_heavy, visited, dist, pred, next, counts,
      depth);
  return static_cast<int>(cudaGetLastError());
}
