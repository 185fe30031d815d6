// Inclusive prefix sum of a flat f32 array, for sm_90a: cumsum_flat.
//
// Replaces this TPU kernel (cugraph_tpu/prims/pallas/):
//   scan.py:_scan_kernel (41), launched by cumsum_flat (59, pallas_call 71).
// The TPU kernel walks (1536, 128) tiles in grid order on one core: a
// lane prefix and a row prefix by log-step rolls (Mosaic has no cumsum
// primitive) plus a running total carried in SMEM from one grid step to
// the next. Blocks of a GPU run in no order and carry nothing, so the
// carry becomes a second level:
//   1. tile_scan<false>: each block scans its tile of 4096 elements and
//      writes only the tile's total;
//   2. scan_totals: one block turns the totals into exclusive tile
//      offsets, in place (8192 totals at 33.5M elements, two passes);
//   3. tile_scan<true>: each block scans its tile again and adds its
//      offset.
// Within a block, a thread owns 4 consecutive elements (staged through
// shared memory so that the loads coalesce), a warp scans the threads'
// sums with shuffles, and one warp scans the 32 warp totals. Passes 1 and
// 3 compute a tile's total by the same additions, so tile ends agree with
// the next tile's offset up to the rounding of the totals' scan.
//
// Bound on an H100 SXM: memory. The function must read n * 4 B and write
// n * 4 B: 268 MB at n = 2^25, ~80 us at 3.35 TB/s. This design reads the
// input twice (passes 1 and 3), so it cannot beat 1.5x that bound; a
// single-pass scan with decoupled look-back is later work.
//
// Rounding: sums are IEEE f32, in a tree within each tile and across tile
// offsets, so the error at element i is a few tens of ulps of the prefix
// of |x| up to i, not the n ulps of a sequential f32 sum.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_inclusive_scan(float v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(kFullMask, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

// Exclusive scan of one value per thread across the block; *total gets
// the block's sum. warp_sums holds kWarps floats; the block must not
// touch it between two calls without a __syncthreads (this function ends
// with one).
__device__ __forceinline__ float block_exclusive_scan(float v, float* warp_sums,
                                                      float* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float inc = warp_inclusive_scan(v, lane);
  float exc = __shfl_up_sync(kFullMask, inc, 1);
  if (lane == 0) exc = 0.0f;
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    // kWarps == 32: one warp scans the warp totals
    const float s = warp_inclusive_scan(warp_sums[lane], lane);
    __syncwarp();
    warp_sums[lane] = s;
  }
  __syncthreads();
  const float warp_off = warp > 0 ? warp_sums[warp - 1] : 0.0f;
  *total = warp_sums[kWarps - 1];
  __syncthreads();
  return warp_off + exc;
}

// Stage elements [base, base + kTile) of x into tile (0 past n), with
// coalesced loads; returns this thread's 4 consecutive elements.
__device__ __forceinline__ float4 load_tile(const float* __restrict__ x, long long base,
                                            long long n, float* tile) {
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long idx = base + i * kThreads + threadIdx.x;
    // plain loads: scan_totals reads the array it later overwrites
    tile[i * kThreads + threadIdx.x] = idx < n ? x[idx] : 0.0f;
  }
  __syncthreads();
  const float4 v = reinterpret_cast<const float4*>(tile)[threadIdx.x];
  __syncthreads();
  return v;
}

template <bool kWrite>
__global__ void __launch_bounds__(kThreads)
tile_scan(const float* __restrict__ x, float* __restrict__ y, float* __restrict__ totals,
          long long n) {
  __shared__ __align__(16) float tile[kTile];
  __shared__ float warp_sums[kWarps];
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const float4 v = load_tile(x, base, n, tile);
  const float p0 = v.x, p1 = p0 + v.y, p2 = p1 + v.z, p3 = p2 + v.w;
  float total;
  const float exc = block_exclusive_scan(p3, warp_sums, &total);
  if (!kWrite) {
    if (threadIdx.x == 0) totals[blockIdx.x] = total;
    return;
  }
  const float off = totals[blockIdx.x] + exc;
  float4 out;
  out.x = off + p0;
  out.y = off + p1;
  out.z = off + p2;
  out.w = off + p3;
  reinterpret_cast<float4*>(tile)[threadIdx.x] = out;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long idx = base + i * kThreads + threadIdx.x;
    if (idx < n) y[idx] = tile[i * kThreads + threadIdx.x];
  }
}

// totals[b] <- sum of totals[0..b) for b in [0, count), one block, in
// passes of kTile with a running carry.
__global__ void __launch_bounds__(kThreads) scan_totals(float* __restrict__ totals, int count) {
  __shared__ __align__(16) float tile[kTile];
  __shared__ float warp_sums[kWarps];
  float carry = 0.0f;
  for (long long base = 0; base < count; base += kTile) {
    const float4 v = load_tile(totals, base, count, tile);
    const float p0 = v.x, p1 = p0 + v.y, p2 = p1 + v.z, p3 = p2 + v.w;
    float pass_total;
    const float off = carry + block_exclusive_scan(p3, warp_sums, &pass_total);
    float4 out;  // exclusive: each element gets the sum before it
    out.x = off;
    out.y = off + p0;
    out.z = off + p1;
    out.w = off + p2;
    reinterpret_cast<float4*>(tile)[threadIdx.x] = out;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const long long idx = base + i * kThreads + threadIdx.x;
      if (idx < count) totals[idx] = tile[i * kThreads + threadIdx.x];
    }
    __syncthreads();
    carry += pass_total;
  }
}

}  // namespace

// C interface, loaded with ctypes. scratch holds ceil(n / 4096) floats
// (the tile totals, then their offsets). The launches go on the caller's
// stream and do not synchronise; the return value is cudaGetLastError()
// after them.
extern "C" int cgt_cumsum_flat(const float* x, float* y, float* scratch, long long n,
                               void* stream) {
  if (n > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const long long tiles = (n + kTile - 1) / kTile;
    if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    const unsigned grid = static_cast<unsigned>(tiles);
    tile_scan<false><<<grid, kThreads, 0, s>>>(x, y, scratch, n);
    scan_totals<<<1, kThreads, 0, s>>>(scratch, static_cast<int>(tiles));
    tile_scan<true><<<grid, kThreads, 0, s>>>(x, y, scratch, n);
  }
  return static_cast<int>(cudaGetLastError());
}
