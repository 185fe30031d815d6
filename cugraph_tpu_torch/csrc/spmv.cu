// SpMV over the CSC of a graph, for sm_90a: spmv_sum and spmv_minplus.
//
// Replaces these TPU kernels (cugraph_tpu/prims/pallas/):
//   spmv_sum:     spmv3.py:_keyed_reduce_call (862), with the
//                 spmv2.py:_expand_call (1507) and _slab_benes_call (1582)
//                 stages in front of it fused in; also covers
//                 spmv2.py:_sort_reduce_call (1675) reduce="sum" and, with
//                 weights, the v1 windowed pull SpMV spmv.py:_make_reduce_kernel
//                 (194, via pull_spmv 224 / 260), whose XLA gather of
//                 x[src] * w in front of it is fused in the same way.
//   spmv_minplus: spmv2.py:_sort_reduce_call (1675) reduce="min" and
//                 spmv3.py:_keyed_min_call (944), with the min-variant
//                 _expand_call and _slab_benes_call fused in.
// The TPU splits the gather into expand / Benes / reduce stages because
// Mosaic cannot gather across vregs. A GPU gathers natively, so one pass
// over the CSC computes the joint result:
//   spmv_sum:     y[d] = sum over edges s->d of w * x[s]   (w = 1 if unweighted)
//   spmv_minplus: y[d] = min over edges s->d of x[s] + w   (w = 0 if unweighted;
//                 +inf where d has no in-edge)
//
// Bound on an H100 SXM: memory. Per launch the kernel must read offsets
// (V+1)*4 B, minors E*4 B, x (4 B per source row that has an out-edge) and
// weights E*4 B if any, and write y V*4 B: about 159 MB at RMAT scale 21
// (V = 2^21, E = 2^25, unweighted), or ~48 us at 3.35 TB/s. The arithmetic
// (E adds or mins) is negligible against 67 TFLOP/s. What both kernels
// wait on is the E gathers of x: 8 MB of x stays in the L2, but each
// 4-byte gather costs a 32-byte sector from it (1.07 GB at scale 21)
// wherever the SM's L1 misses, and at that rate it runs as fast as
// cuSPARSE's CSR SpMV, ~5x the DRAM bound.
//
// Design: edge-balanced tiles (merge path, Merrill & Garland, SC'16;
// prims/cuda/_partition.py), one kernel body for both functions, templated
// on the reduction (SumOp, MinPlusOp: identity, combine, per-edge value),
// as the TPU's _sort_reduce_call switches one body between sum and min with
// IDENT and merge (spmv2.py:1689-1693). The rows and edges of the CSC form
// one sequence of V + E items, and each block of 256 threads takes one tile
// of 256 * items_per_thread of them, so a hub row is reduced by many blocks
// and no block waits on a long row. The block first stages its tile in
// shared memory with coalesced loads: the end of each row that ends in the
// tile, and the edge value (w * x[s] or x[s] + w) of each edge (every
// gather of the tile in flight at once; x is 8 MB at scale 21 and stays in
// the 50 MB L2). Each thread then finds its own start on the merge path by
// a binary search in shared memory and walks its run of items in order,
// writing the rows that begin and end in its run to y. The partial row a
// thread leaves goes into a segmented scan across the block's threads
// (fixed order, in shared memory), whose results complete the row that a
// later thread of the block ends. The row the tile enters partway goes to
// carry slot 0 of the tile and the row it leaves partway to slot 1 of a
// (tiles, 2) f32 buffer; a fix-up kernel combines each cut row's carries in
// tile order and writes it. A row with no edges ends with the identity, so
// spmv_minplus writes +inf there with no extra pass. There are no atomics,
// so the result is the same from run to run. The TPU's hi/lo bf16 split
// does not carry over: sums are IEEE f32, and the min is exact (its one
// rounding is the x + w add, which the plain version does the same way).
// The plan and the tile size are shared, so a CSC planned for one function
// is not planned again for the other.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

// y[d] = sum over edges s->d of w * x[s]
struct SumOp {
  static __device__ __forceinline__ float identity() { return 0.0f; }
  static __device__ __forceinline__ float combine(float a, float b) { return a + b; }
  static __device__ __forceinline__ float edge(float xs, float w) { return w * xs; }
  static __device__ __forceinline__ float edge(float xs) { return xs; }
};

// y[d] = min over edges s->d of x[s] + w; unweighted adds 0, as the plain
// version does (so -0 becomes +0 there too)
struct MinPlusOp {
  static __device__ __forceinline__ float identity() { return CUDART_INF_F; }
  static __device__ __forceinline__ float combine(float a, float b) { return fminf(a, b); }
  static __device__ __forceinline__ float edge(float xs, float w) { return xs + w; }
  static __device__ __forceinline__ float edge(float xs) { return xs + 0.0f; }
};

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr unsigned kFullMask = 0xffffffffu;

// One block per tile. The tile covers rows r0 .. r1 and edges e0 .. e1 - 1;
// rows r0 .. r1 - 1 end inside it, row r1 (if it has edges here) goes on.
// Dynamic shared memory: row_end[256 * items_per_thread] (int, the local
// edge index where each local row ends), then val[256 * items_per_thread].
template <class Op>
__global__ void __launch_bounds__(kThreads)
spmv_tiles_kernel(const int* __restrict__ offsets, const int* __restrict__ minors,
                  const float* __restrict__ weights, const float* __restrict__ x,
                  const int* __restrict__ tile_row, const int* __restrict__ tile_edge,
                  float* __restrict__ y, float* __restrict__ carry, int items_per_thread) {
  extern __shared__ int smem[];
  __shared__ int run_row[kThreads];
  __shared__ float run_sum[kThreads];  // combined value of a warp's last run
  const int tile_items = kThreads * items_per_thread;
  int* row_end = smem;
  float* val = reinterpret_cast<float*>(smem + tile_items);
  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int r0 = __ldg(tile_row + tile), r1 = __ldg(tile_row + tile + 1);
  const int e0 = __ldg(tile_edge + tile), e1 = __ldg(tile_edge + tile + 1);
  const int nr = r1 - r0, ne = e1 - e0;
  // row r0 began in an earlier tile (r0 < V for every tile)
  const bool head = __ldg(offsets + r0) < e0;
  for (int i = tid; i < nr; i += kThreads) row_end[i] = __ldg(offsets + r0 + i + 1) - e0;
  if (weights != nullptr) {
#pragma unroll 4
    for (int i = tid; i < ne; i += kThreads)
      val[i] = Op::edge(__ldg(x + __ldg(minors + e0 + i)), __ldg(weights + e0 + i));
  } else {
#pragma unroll 4
    for (int i = tid; i < ne; i += kThreads) val[i] = Op::edge(__ldg(x + __ldg(minors + e0 + i)));
  }
  __syncthreads();

  // this thread's start on the merge path: the rows among 0 .. nr - 1
  // whose end marker (position row_end[i] + i) lies before diagonal d
  const int d = min(tid * items_per_thread, nr + ne);
  int lo = max(0, d - ne), hi = min(d, nr);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (row_end[mid] + mid < d) lo = mid + 1;
    else hi = mid;
  }
  int r = lo, el = d - lo;
  const int d_end = min(d + items_per_thread, nr + ne);
  float acc = Op::identity();
  int first_row = -1;  // the first row this thread ends, written after the scan
  float first_acc = Op::identity();
  for (int k = d; k < d_end; ++k) {
    if (r < nr && el == row_end[r]) {  // the end marker of local row r
      if (first_row < 0) {
        first_row = r;
        first_acc = acc;
      } else {
        y[r0 + r] = acc;
      }
      acc = Op::identity();
      ++r;
    } else {
      acc = Op::combine(acc, val[el++]);
    }
  }

  // Inclusive segmented scan of the threads' partial rows (rows r do not
  // decrease with tid, so each row's threads are one run), in a fixed
  // order: a shuffle tree within each warp, then the warps' run totals.
  const int lane = tid & 31, warp = tid >> 5;
  float run = acc;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(kFullMask, run, off);
    const int up_row = __shfl_up_sync(kFullMask, r, off);
    if (lane >= off && up_row == r) run = Op::combine(run, up);
  }
  const int warp_first = __shfl_sync(kFullMask, r, 0);
  if (lane == 31) {
    run_row[warp] = r;  // the row of the warp's last run, and its sum
    run_sum[warp] = run;
    run_row[kWarpsPerBlock + warp] = warp_first;
  }
  __syncthreads();
  if (r == warp_first) {  // the run may have begun in earlier warps
    for (int w = warp - 1; w >= 0 && run_row[w] == r; --w) {
      run = Op::combine(run, run_sum[w]);
      if (run_row[kWarpsPerBlock + w] != r) break;
    }
  }
  // run now combines this row's items in threads 0 .. tid of the block
  const float before = __shfl_up_sync(kFullMask, run, 1);
  const int before_row = __shfl_up_sync(kFullMask, r, 1);
  if (first_row >= 0) {
    // earlier threads of the block that left this row partway
    float sum = first_acc;
    if (lane > 0) {
      if (before_row == first_row) sum = Op::combine(before, first_acc);
    } else if (warp > 0 && run_row[warp - 1] == first_row) {
      // lane 0: the previous warp's last run, with the warps before it
      float prev = run_sum[warp - 1];
      if (run_row[kWarpsPerBlock + warp - 1] == first_row) {
        for (int w = warp - 2; w >= 0 && run_row[w] == first_row; --w) {
          prev = Op::combine(prev, run_sum[w]);
          if (run_row[kWarpsPerBlock + w] != first_row) break;
        }
      }
      sum = Op::combine(prev, first_acc);
    }
    if (first_row == 0 && head) carry[2 * static_cast<size_t>(tile)] = sum;
    else y[r0 + first_row] = sum;
  }
  if (tid == kThreads - 1) {
    // the last thread's run is row r1 (local nr); its value, if the tile
    // holds edges of it, is the tile's carry
    const bool has = nr == 0 ? ne > 0 : row_end[nr - 1] < ne;
    if (has) carry[2 * static_cast<size_t>(tile) + (nr == 0 && head ? 0 : 1)] = run;
  }
}

// One thread per tile boundary t = 1 .. num_tiles - 1. A boundary that
// cuts row r = tile_row[t] where r began in tile t - 1 owns r: y[r] = slot 1
// of tile t - 1 combined with slot 0 of tiles t .. last, in that order,
// where last is the tile that holds r's end marker (position
// offsets[r + 1] + r).
template <class Op>
__global__ void __launch_bounds__(kThreads)
spmv_fixup_kernel(const int* __restrict__ offsets, const int* __restrict__ tile_row,
                  const int* __restrict__ tile_edge, const float* __restrict__ carry,
                  float* __restrict__ y, int num_tiles, long long items_per_tile) {
  const int t = blockIdx.x * kThreads + threadIdx.x + 1;
  if (t >= num_tiles) return;
  const int r = __ldg(tile_row + t);
  const int start = __ldg(offsets + r);
  if (start >= __ldg(tile_edge + t)) return;  // t does not cut a row
  const long long prev = static_cast<long long>(__ldg(tile_row + t - 1)) + __ldg(tile_edge + t - 1);
  if (static_cast<long long>(start) + r < prev) return;  // an earlier boundary owns r
  const long long last = (static_cast<long long>(__ldg(offsets + r + 1)) + r) / items_per_tile;
  float acc = __ldg(carry + 2 * static_cast<size_t>(t - 1) + 1);
#pragma unroll 4
  for (long long tt = t; tt <= last; ++tt) acc = Op::combine(acc, __ldg(carry + 2 * tt));
  y[r] = acc;
}

// Both launches on the caller's stream: the tiles, then (with more than one
// tile) the fix-up of the rows cut by a tile boundary.
template <class Op>
int launch(const int* offsets, const int* minors, const float* weights, const float* x,
           const int* tile_row, const int* tile_edge, float* carry, float* y, int num_tiles,
           int items_per_thread, void* stream) {
  if (num_tiles > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int tile_items = kThreads * items_per_thread;
    const size_t smem = 2 * sizeof(int) * static_cast<size_t>(tile_items);
    if (smem > 48 * 1024) {
      cudaError_t rc = cudaFuncSetAttribute(
          spmv_tiles_kernel<Op>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (rc != cudaSuccess) return static_cast<int>(rc);
    }
    spmv_tiles_kernel<Op><<<num_tiles, kThreads, smem, s>>>(
        offsets, minors, weights, x, tile_row, tile_edge, y, carry, items_per_thread);
    if (num_tiles > 1) {
      const unsigned blocks = (num_tiles - 1 + kThreads - 1) / kThreads;
      spmv_fixup_kernel<Op><<<blocks, kThreads, 0, s>>>(offsets, tile_row, tile_edge, carry, y,
                                                         num_tiles, tile_items);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, loaded with ctypes. weights may be null (unweighted). The
// launches go on the caller's stream and do not synchronise; the return
// value is cudaGetLastError() after them. tile_row / tile_edge (num_tiles +
// 1 int32 each) are the merge-path plan for 256 * items_per_thread items a
// tile; carry is (num_tiles, 2) f32 scratch.
extern "C" int cgt_spmv_sum(const int* offsets, const int* minors, const float* weights,
                            const float* x, const int* tile_row, const int* tile_edge,
                            float* carry, float* y, int num_tiles, int items_per_thread,
                            void* stream) {
  return launch<SumOp>(offsets, minors, weights, x, tile_row, tile_edge, carry, y, num_tiles,
                       items_per_thread, stream);
}

extern "C" int cgt_spmv_minplus(const int* offsets, const int* minors, const float* weights,
                                const float* x, const int* tile_row, const int* tile_edge,
                                float* carry, float* y, int num_tiles, int items_per_thread,
                                void* stream) {
  return launch<MinPlusOp>(offsets, minors, weights, x, tile_row, tile_edge, carry, y,
                           num_tiles, items_per_thread, stream);
}
