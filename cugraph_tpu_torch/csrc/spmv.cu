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
// (E adds or mins) is negligible against 67 TFLOP/s.
//
// Design: one warp per destination row. Lanes stride over the row's
// segment [offsets[d], offsets[d+1]) so the minors loads coalesce; the
// x[s] gathers are random, but x is 8 MB at scale 21 and stays in the
// 50 MB L2. Each lane keeps one f32 partial; a __shfl_down_sync tree
// combines them. There are no atomics, so the result is deterministic.
// The TPU's hi/lo bf16 split does not carry over: sums are IEEE f32.
// The min is exact (no rounding besides the x + w add, which the plain
// version does the same way). Rows are not tiered by degree yet: a hub
// row is walked by one warp, which is the known tail of this version.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr unsigned kFullMask = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
spmv_sum_kernel(const int* __restrict__ offsets, const int* __restrict__ minors,
                const float* __restrict__ weights, const float* __restrict__ x,
                float* __restrict__ y, int num_rows) {
  // row is uniform across the warp, so whole warps exit together and the
  // full-mask shuffles below see all 32 lanes
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= num_rows) return;
  const int beg = __ldg(offsets + row);
  const int end = __ldg(offsets + row + 1);
  float acc = 0.0f;
  if (weights != nullptr) {
#pragma unroll 4
    for (int e = beg + lane; e < end; e += 32)
      acc += __ldg(weights + e) * __ldg(x + __ldg(minors + e));
  } else {
#pragma unroll 4
    for (int e = beg + lane; e < end; e += 32) acc += __ldg(x + __ldg(minors + e));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(kFullMask, acc, o);
  if (lane == 0) y[row] = acc;
}

__global__ void __launch_bounds__(kThreads)
spmv_minplus_kernel(const int* __restrict__ offsets, const int* __restrict__ minors,
                    const float* __restrict__ weights, const float* __restrict__ x,
                    float* __restrict__ y, int num_rows) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= num_rows) return;
  const int beg = __ldg(offsets + row);
  const int end = __ldg(offsets + row + 1);
  // +inf is the identity: a lane with no slot, or a row with no in-edge,
  // contributes nothing
  float acc = CUDART_INF_F;
#pragma unroll 4
  for (int e = beg + lane; e < end; e += 32) {
    const float w = weights != nullptr ? __ldg(weights + e) : 0.0f;
    acc = fminf(acc, __ldg(x + __ldg(minors + e)) + w);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc = fminf(acc, __shfl_down_sync(kFullMask, acc, o));
  if (lane == 0) y[row] = acc;
}

}  // namespace

// C interface, loaded with ctypes. weights may be null (unweighted). The
// launch goes on the caller's stream and does not synchronise; the return
// value is cudaGetLastError() after the launch.
extern "C" int cgt_spmv_sum(const int* offsets, const int* minors, const float* weights,
                            const float* x, float* y, int num_rows, void* stream) {
  if (num_rows > 0) {
    const unsigned blocks = (num_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
    spmv_sum_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        offsets, minors, weights, x, y, num_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cgt_spmv_minplus(const int* offsets, const int* minors, const float* weights,
                                const float* x, float* y, int num_rows, void* stream) {
  if (num_rows > 0) {
    const unsigned blocks = (num_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
    spmv_minplus_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        offsets, minors, weights, x, y, num_rows);
  }
  return static_cast<int>(cudaGetLastError());
}
