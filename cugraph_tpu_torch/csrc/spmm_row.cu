// Row SpMM over the CSC of a graph, for sm_90a: spmm_rows.
//
// Replaces the TPU kernel cugraph_tpu/prims/pallas/spmm_row.py:_range_call
// (225), reached through row_spmm (431): per source range it reads T = 256
// rows from a VMEM table and reduces them into a destination window with a
// weighted one-hot (W = 512, T) matmul on the MXU. The one-hot matmul
// exists because Mosaic cannot gather; a GPU gathers rows natively, so it
// has no counterpart here, and neither do tensor cores: the 2*E*F flops
// (8.6 GFLOP at RMAT scale 21, F = 128) take ~0.13 ms on the CUDA cores at
// 67 TFLOP/s, far below the gathers. The function:
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
// out-edge once (F*4 B), and write Y V*F*4 B: ~1.75 GB at RMAT scale 21
// with F = 128, or ~0.52 ms at 3.35 TB/s. What it does move is E row
// gathers, 17.2 GB in f32 (8.6 GB from a bf16 copy) of 32-byte sectors out
// of the L2 (50 MB; the degree-descending renumbering keeps hub rows
// there), and that rate, not DRAM's, sets its time.
//
// Design: edge-balanced tiles (merge path, prims/cuda/_partition.py). The
// rows and edges of the CSC form one sequence of V + E items; each warp
// takes one tile of `items_per_tile` of them (1,024 by default), so a hub
// row of 1.2e5 edges is walked by ~120 warps, not by one. At F = 128 each
// lane owns 4 columns, so a gathered row is one coalesced warp load (512 B,
// or 256 B from the bf16 copy); the warp reads 32 in-edges (minor, weight)
// at a time, one per lane, broadcasts them with __shfl_sync, and issues
// kAhead = 8 row gathers before it adds any of them. A gather
// is kept as loaded (RowSlice) and converted only at its add: a conversion
// next to its load makes the next gather wait for it, which serialises the
// warp's gathers. Registers, not a cp.async ring in shared memory: a
// gathered row is used once, by the warp that loaded it, and 24-32
// resident warps x 8 rows in flight keep 48-128 KB a SM on the way
// (Little's law asks ~16 KB).
// A row that begins and ends inside the tile is written straight to Y (an
// empty row as 0). The row the tile enters partway goes to carry slot 0 of
// the tile and the row it leaves partway to slot 1, a (tiles, 2, F) f32
// buffer; the fix-up kernel then sums each cut row's carries in tile order
// and writes it. Every Y row is written once, there are no atomics, and the
// result is the same from run to run.
//
// bf16 mode with vec4 gathers from a bf16 copy of X made in the same call
// (the same rounding, so the same result): half the gather sectors, and no
// rounding in the loop over E * F values, for one pass over X; on an H100
// it beat rounding in the loop by a fifth (PERF.md §6). The scalar path
// (F % 4 != 0) rounds in the loop.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kChunk = 128;  // columns per warp pass: 32 lanes x 4
constexpr int kAhead = 8;  // row gathers a warp issues before it adds the first
constexpr unsigned kFullMask = 0xffffffffu;

template <bool kBf16>
__device__ __forceinline__ float operand(float v) {
  if (kBf16) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

// The mode's operands of four values: in bf16 mode, two rounding
// instructions of two values each (cvt.rn.bf16x2.f32), then exact widening
// on the integer pipe (the first value of a pair is its low half).
template <bool kBf16>
__device__ __forceinline__ void operands4(float v[4]) {
  if (kBf16) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    const unsigned a = *reinterpret_cast<const unsigned*>(&lo);
    const unsigned b = *reinterpret_cast<const unsigned*>(&hi);
    v[0] = __uint_as_float(a << 16);
    v[1] = __uint_as_float(a & 0xffff0000u);
    v[2] = __uint_as_float(b << 16);
    v[3] = __uint_as_float(b & 0xffff0000u);
  }
}

// Columns c .. c+3 of one gathered row, as loaded: what a warp keeps in
// flight. load() only issues the load, and get() converts later, at the
// add: a conversion next to its load would make the next gather wait for
// this one. A slice of the bf16 copy stays packed (2 registers, not 4), so
// twice as many fit in flight for the same registers.
template <bool kVec4, typename TIn>
struct RowSlice;

template <>
struct RowSlice<true, float> {  // f32, 16 B a lane
  float4 q;
  __device__ __forceinline__ void load(const float* __restrict__ x, int s, int f, int c) {
    q = c < f ? __ldg(reinterpret_cast<const float4*>(x + static_cast<size_t>(s) * f + c))
              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  template <bool kBf16>
  __device__ __forceinline__ void get(float v[4]) const {
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    operands4<kBf16>(v);
  }
};

template <>
struct RowSlice<true, __nv_bfloat16> {  // the bf16 copy (vec4 only), 8 B a lane
  uint2 q;
  __device__ __forceinline__ void load(const __nv_bfloat16* __restrict__ x, int s, int f,
                                       int c) {
    q = c < f ? __ldg(reinterpret_cast<const uint2*>(x + static_cast<size_t>(s) * f + c))
              : make_uint2(0u, 0u);
  }
  // already rounded. A bf16 is the high half of its f32, so widening is a
  // shift or a mask on the integer pipe; __bfloat162float is a cvt on
  // sm_90, whose lower rate would be paid E * F times.
  template <bool kBf16>
  __device__ __forceinline__ void get(float v[4]) const {
    v[0] = __uint_as_float(q.x << 16);
    v[1] = __uint_as_float(q.x & 0xffff0000u);
    v[2] = __uint_as_float(q.y << 16);
    v[3] = __uint_as_float(q.y & 0xffff0000u);
  }
};

template <>
struct RowSlice<false, float> {  // any F, one value at a time
  float a[4];
  __device__ __forceinline__ void load(const float* __restrict__ x, int s, int f, int c) {
    const float* xr = x + static_cast<size_t>(s) * f + c;
#pragma unroll
    for (int k = 0; k < 4; ++k) a[k] = c + k < f ? __ldg(xr + k) : 0.0f;
  }
  template <bool kBf16>
  __device__ __forceinline__ void get(float v[4]) const {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = a[k];
    operands4<kBf16>(v);
  }
};

template <bool kVec4>
__device__ __forceinline__ void store4(float* __restrict__ dst, int f, int c, const float a[4]) {
  if (kVec4) {
    if (c < f) *reinterpret_cast<float4*>(dst + c) = make_float4(a[0], a[1], a[2], a[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (c + k < f) dst[c + k] = a[k];
  }
}

// One warp per tile. The tile covers rows r0 .. r1 and edges e0 .. e1 - 1;
// rows r0 .. r1 - 1 end inside it, row r1 (if it has edges here) goes on.
template <bool kBf16, bool kVec4, typename TIn>
__global__ void __launch_bounds__(kThreads)
spmm_tiles_kernel(const int* __restrict__ offsets, const int* __restrict__ minors,
                  const float* __restrict__ weights, const TIn* __restrict__ x,
                  const int* __restrict__ tile_row, const int* __restrict__ tile_edge,
                  float* __restrict__ y, float* __restrict__ carry, int num_tiles, int f) {
  // tile is uniform across the warp, so whole warps exit together and the
  // full-mask shuffles below see all 32 lanes
  const int tile = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (tile >= num_tiles) return;
  const int r0 = __ldg(tile_row + tile), r1 = __ldg(tile_row + tile + 1);
  const int e0 = __ldg(tile_edge + tile), e1 = __ldg(tile_edge + tile + 1);
  // row r0 began in an earlier tile (r0 < V for every tile)
  const bool head = __ldg(offsets + r0) < e0;
  float* head_slot = carry + (static_cast<size_t>(tile) * 2) * f;
  float* tail_slot = head_slot + f;

  for (int c0 = 0; c0 < f; c0 += kChunk) {
    const int c = c0 + lane * 4;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    bool has = false;  // acc holds an edge of row r
    int r = r0;
    // the ends of rows base .. base + 31, one per lane (INT_MAX past r1 - 1)
    int base = r0;
    int end_lane = base + lane < r1 ? __ldg(offsets + base + lane + 1) : INT_MAX;
    int cur_end = __shfl_sync(kFullMask, end_lane, 0);

    // write row r (complete) and move to row r + 1; uniform across the warp
    auto finish_row = [&]() {
      float* dst = (r == r0 && head) ? head_slot : y + static_cast<size_t>(r) * f;
      store4<kVec4>(dst, f, c, acc);
      acc[0] = acc[1] = acc[2] = acc[3] = 0.0f;
      has = false;
      ++r;
      if (r - base == 32) {
        base = r;
        end_lane = base + lane < r1 ? __ldg(offsets + base + lane + 1) : INT_MAX;
      }
      cur_end = __shfl_sync(kFullMask, end_lane, r - base);
    };

    // (minor, weight) of the batch of 32 edges after the current one, one
    // a lane, loaded while the current batch's rows are gathered; a weight
    // becomes an operand of the mode only when its batch is current
    int s_next = 0;
    float w_next = 1.0f;
    auto load_batch = [&](int e) {
      if (e < e1) {
        s_next = __ldg(minors + e);
        if (weights != nullptr) w_next = __ldg(weights + e);
      }
    };
    load_batch(e0 + lane);
    for (int eb = e0; eb < e1; eb += 32) {
      const int s_lane = s_next;
      const float w_lane = weights != nullptr ? operand<kBf16>(w_next) : 1.0f;
      load_batch(eb + 32 + lane);
      const int n = min(32, e1 - eb);  // uniform across the warp
      for (int j0 = 0; j0 < n; j0 += kAhead) {
        // kAhead gathers with nothing between them. Past the batch's end,
        // s_lane still holds a valid row (a minor of this tile or row 0),
        // so the gather is harmless and needs no branch; its value is not
        // added.
        RowSlice<kVec4, TIn> v[kAhead];
#pragma unroll
        for (int u = 0; u < kAhead; ++u)
          v[u].load(x, __shfl_sync(kFullMask, s_lane, j0 + u), f, c);
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          const float w = __shfl_sync(kFullMask, w_lane, j0 + u);
          if (j0 + u < n) {
            while (eb + j0 + u >= cur_end) finish_row();
            float a[4];
            v[u].template get<kBf16>(a);
#pragma unroll
            for (int k = 0; k < 4; ++k) acc[k] += w * a[k];
            has = true;
          }
        }
      }
    }
    while (r < r1) finish_row();  // rows that end after the tile's last edge
    if (has) store4<kVec4>((r == r0 && head) ? head_slot : tail_slot, f, c, acc);
  }
}

// One warp per tile boundary t = 1 .. num_tiles - 1. A boundary that cuts
// row r = tile_row[t] where r began in tile t - 1 owns r: Y[r] = slot 1 of
// tile t - 1 plus slot 0 of tiles t .. last, in that order, where last is
// the tile that holds r's end marker (position offsets[r + 1] + r).
template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
spmm_fixup_kernel(const int* __restrict__ offsets, const int* __restrict__ tile_row,
                  const int* __restrict__ tile_edge, const float* __restrict__ carry,
                  float* __restrict__ y, int num_tiles, long long items_per_tile, int f) {
  const int t = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5) + 1;
  const int lane = threadIdx.x & 31;
  if (t >= num_tiles) return;
  const int r = __ldg(tile_row + t);
  const int start = __ldg(offsets + r);
  if (start >= __ldg(tile_edge + t)) return;  // t does not cut a row
  const long long prev = static_cast<long long>(__ldg(tile_row + t - 1)) + __ldg(tile_edge + t - 1);
  if (static_cast<long long>(start) + r < prev) return;  // an earlier boundary owns r
  const long long last = (static_cast<long long>(__ldg(offsets + r + 1)) + r) / items_per_tile;
  for (int c0 = 0; c0 < f; c0 += kChunk) {
    const int c = c0 + lane * 4;
    RowSlice<kVec4, float> slot;
    float acc[4], v[4];
    slot.load(carry + (static_cast<size_t>(t - 1) * 2 + 1) * f, 0, f, c);
    slot.template get<false>(acc);
#pragma unroll 4
    for (long long tt = t; tt <= last; ++tt) {
      slot.load(carry + static_cast<size_t>(tt) * 2 * f, 0, f, c);
      slot.template get<false>(v);
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[k] += v[k];
    }
    store4<kVec4>(y + static_cast<size_t>(r) * f, f, c, acc);
  }
}

__global__ void to_bf16_kernel(const float4* __restrict__ x, uint2* __restrict__ xb,
                               long long n4) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n4;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const float4 q = __ldg(x + i);
    __nv_bfloat162 lo = __floats2bfloat162_rn(q.x, q.y);
    __nv_bfloat162 hi = __floats2bfloat162_rn(q.z, q.w);
    xb[i] = make_uint2(*reinterpret_cast<unsigned*>(&lo), *reinterpret_cast<unsigned*>(&hi));
  }
}

template <bool kBf16, bool kVec4, typename TIn>
void launch_tiles(const int* offsets, const int* minors, const float* weights, const TIn* x,
                  const int* tile_row, const int* tile_edge, float* y, float* carry,
                  int num_tiles, int f, cudaStream_t stream) {
  const unsigned blocks = (num_tiles + kWarpsPerBlock - 1) / kWarpsPerBlock;
  spmm_tiles_kernel<kBf16, kVec4, TIn><<<blocks, kThreads, 0, stream>>>(
      offsets, minors, weights, x, tile_row, tile_edge, y, carry, num_tiles, f);
}

}  // namespace

// C interface, loaded with ctypes. weights may be null (unweighted).
// tile_row / tile_edge (num_tiles + 1 int32 each) are the merge-path plan
// for items_per_tile; carry is (num_tiles, 2, f) f32 scratch. bf16 != 0
// selects the bf16 operand mode; with vec4 it needs x_bf16, (rows of x, f)
// bf16 scratch for the rounded copy of x (ignored otherwise). vec4 != 0
// requires f % 4 == 0 and 16-byte aligned x, y and carry (the wrapper
// checks). The launches go on the caller's stream and do not synchronise;
// the return value is cudaGetLastError() after them.
extern "C" int cgt_spmm_rows(const int* offsets, const int* minors, const float* weights,
                             const float* x, void* x_bf16, long long x_elems,
                             const int* tile_row, const int* tile_edge, float* carry, float* y,
                             int num_tiles, long long items_per_tile, int f, int bf16,
                             int vec4, void* stream) {
  if (num_tiles > 0 && f > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (bf16 && vec4) {
      if (x_bf16 == nullptr) return static_cast<int>(cudaErrorInvalidValue);
      const long long n4 = x_elems / 4;
      const unsigned blocks = static_cast<unsigned>(std::min<long long>((n4 + 255) / 256, 132 * 16));
      if (n4 > 0)
        to_bf16_kernel<<<blocks, 256, 0, s>>>(reinterpret_cast<const float4*>(x),
                                              static_cast<uint2*>(x_bf16), n4);
      launch_tiles<true, true, __nv_bfloat16>(offsets, minors, weights,
                                              static_cast<const __nv_bfloat16*>(x_bf16), tile_row,
                                              tile_edge, y, carry, num_tiles, f, s);
    } else if (bf16) {
      launch_tiles<true, false, float>(offsets, minors, weights, x, tile_row, tile_edge, y, carry,
                                       num_tiles, f, s);
    } else {
      if (vec4) launch_tiles<false, true, float>(offsets, minors, weights, x, tile_row, tile_edge,
                                                 y, carry, num_tiles, f, s);
      else launch_tiles<false, false, float>(offsets, minors, weights, x, tile_row, tile_edge, y,
                                             carry, num_tiles, f, s);
    }
    if (num_tiles > 1) {
      const unsigned blocks = (num_tiles - 1 + kWarpsPerBlock - 1) / kWarpsPerBlock;
      if (vec4) spmm_fixup_kernel<true><<<blocks, kThreads, 0, s>>>(
          offsets, tile_row, tile_edge, carry, y, num_tiles, items_per_tile, f);
      else spmm_fixup_kernel<false><<<blocks, kThreads, 0, s>>>(
          offsets, tile_row, tile_edge, carry, y, num_tiles, items_per_tile, f);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
