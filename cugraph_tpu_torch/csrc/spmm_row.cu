// Row SpMM over the CSC of a graph, for sm_90a: spmm_rows.
//
// Replaces the TPU kernel cugraph_tpu/prims/pallas/spmm_row.py:_range_call
// (225), reached through row_spmm (431): per source range it reads T = 256
// rows from a VMEM table and reduces them into a destination window with a
// weighted one-hot (W = 512, T) matmul on the MXU. A GPU gathers rows
// natively, so the one-hot matmul has no counterpart here:
//   Y[d, :] = sum over edges s->d of w * X[s, :]   (w = 1 if unweighted)
// for X (V, F) f32, any F, tuned for F = 128. Two modes, as row_spmm has:
//   f32:  IEEE f32 products and accumulation;
//   bf16: w and X rounded to bf16 (round to nearest even) before the
//         multiply, products accumulated in f32. The product of two bf16
//         values is exact in f32, so this mode differs from its plain
//         version only in summation order.
//
// Bound on an H100 SXM: memory. The kernel must read offsets (V+1)*4 B,
// minors E*4 B, weights E*4 B if any, each source row of X that has an
// out-edge once (F*4 B), and write Y V*F*4 B: about 2.3 GB at RMAT scale 21
// with F = 128, or ~0.68 ms at 3.35 TB/s. Without reuse, the E*F*4 B of row
// gathers (17.2 GB) would take ~5.1 ms; the degree-descending renumbering
// puts hub rows at low ids, which helps L2 (50 MB) reuse. The 2*E*F flops
// take ~0.13 ms at 67 TFLOP/s f32, so they do not bound it.
//
// Design: one warp per destination row. At F = 128 each lane owns 4
// columns and moves them as one float4, so a gathered row is one 512 B
// coalesced warp load. The warp reads 32 in-edges (minor, weight) at a
// time, one per lane, and broadcasts them with __shfl_sync; the
// accumulators stay in registers. Other F loop over 128-column chunks,
// scalar where F % 4 != 0. No atomics: the result is deterministic. Rows
// are not tiered by degree yet: a hub row is walked by one warp, which is
// the known tail of this version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kChunk = 128;  // columns per warp pass: 32 lanes x 4
constexpr unsigned kFullMask = 0xffffffffu;

template <bool kBf16>
__device__ __forceinline__ float operand(float v) {
  if (kBf16) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

template <bool kBf16, bool kVec4>
__global__ void __launch_bounds__(kThreads)
spmm_rows_kernel(const int* __restrict__ offsets, const int* __restrict__ minors,
                 const float* __restrict__ weights, const float* __restrict__ x,
                 float* __restrict__ y, int num_rows, int f) {
  // row is uniform across the warp, so whole warps exit together and the
  // full-mask shuffles below see all 32 lanes
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= num_rows) return;
  const int beg = __ldg(offsets + row);
  const int end = __ldg(offsets + row + 1);
  for (int c0 = 0; c0 < f; c0 += kChunk) {
    const int c = c0 + lane * 4;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int base = beg; base < end; base += 32) {
      const int e = base + lane;
      int s_lane = 0;
      float w_lane = 1.0f;
      if (e < end) {
        s_lane = __ldg(minors + e);
        if (weights != nullptr) w_lane = operand<kBf16>(__ldg(weights + e));
      }
      const int n = min(32, end - base);  // uniform across the warp
#pragma unroll 8
      for (int j = 0; j < n; ++j) {
        const int s = __shfl_sync(kFullMask, s_lane, j);
        const float w = __shfl_sync(kFullMask, w_lane, j);
        const float* xr = x + static_cast<size_t>(s) * f + c;
        float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (kVec4) {
          if (c < f) {
            const float4 q = __ldg(reinterpret_cast<const float4*>(xr));
            v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
          }
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (c + k < f) v[k] = __ldg(xr + k);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[k] += w * operand<kBf16>(v[k]);
      }
    }
    float* yr = y + static_cast<size_t>(row) * f + c;
    if (kVec4) {
      if (c < f) *reinterpret_cast<float4*>(yr) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (c + k < f) yr[k] = acc[k];
    }
  }
}

template <bool kBf16, bool kVec4>
void launch(const int* offsets, const int* minors, const float* weights, const float* x,
            float* y, int num_rows, int f, cudaStream_t stream) {
  const unsigned blocks = (num_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  spmm_rows_kernel<kBf16, kVec4><<<blocks, kThreads, 0, stream>>>(
      offsets, minors, weights, x, y, num_rows, f);
}

}  // namespace

// C interface, loaded with ctypes. weights may be null (unweighted).
// bf16 != 0 selects the bf16 operand mode. vec4 != 0 requires f % 4 == 0
// and 16-byte aligned x and y (the wrapper checks). The launch goes on the
// caller's stream and does not synchronise; the return value is
// cudaGetLastError() after the launch.
extern "C" int cgt_spmm_rows(const int* offsets, const int* minors, const float* weights,
                             const float* x, float* y, int num_rows, int f, int bf16,
                             int vec4, void* stream) {
  if (num_rows > 0 && f > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (bf16) {
      if (vec4) launch<true, true>(offsets, minors, weights, x, y, num_rows, f, s);
      else launch<true, false>(offsets, minors, weights, x, y, num_rows, f, s);
    } else {
      if (vec4) launch<false, true>(offsets, minors, weights, x, y, num_rows, f, s);
      else launch<false, false>(offsets, minors, weights, x, y, num_rows, f, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
