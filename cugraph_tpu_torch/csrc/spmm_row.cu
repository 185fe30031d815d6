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
// for X (V, F) f32, any F. Two modes, as row_spmm has:
//   f32:  IEEE f32 products and accumulation;
//   bf16: w and X rounded to bf16 (round to nearest even) before the
//         multiply, products accumulated in f32. The product of two bf16
//         values is exact in f32, so this mode differs from its plain
//         version only in summation order.
// Two layouts of a warp's lanes, chosen by F (prims/cuda/spmm_row.py:
// spmm_layout): the wide one for F > 64 (GraphSAGE's 128 features), where a
// gathered row fills the warp, and the narrow one up to 64 (Brandes' blocks
// of a few sources), where one edge's row would leave most lanes idle.
//
// Wide layout. Bound on an H100 SXM: memory. The kernel must read offsets
// (V+1)*4 B, minors E*4 B, weights E*4 B if any, each source row of X that
// has an out-edge once (F*4 B), and write Y V*F*4 B: ~1.75 GB at RMAT scale
// 21 with F = 128, or ~0.52 ms at 3.35 TB/s. What it does move is E row
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
//
// Narrow layout (F <= 64; spmm_narrow_kernel). The wide layout at F = 8
// loads with 2 of 32 lanes and walks one edge a step. Here L lanes take one
// edge, L the smallest power of two with vec * L >= F (vec = 4, 2 or 1
// floats a load, as F's alignment allows; at most 32, and F beyond 32 * vec
// takes more column passes; float4 loads need at most 16 lanes), so a warp gathers G = 32 / L edges a step: 16
// at F = 8, 8 at F = 16, 4 at F = 32. A gathered row of F = 8 f32 is one
// 32-byte sector. Bound on an H100 SXM at RMAT scale 21 (unweighted; X
// counted whole, an upper bound): offsets 8.4 MB, minors 134.2 MB, X and Y
// 67.1 MB each at F = 8 (277 MB, 0.083 ms at 3.35 TB/s), 134.2 MB each at
// F = 16 (411 MB, 0.123 ms), 268.4 MB each at F = 32 (679 MB, 0.203 ms).
// What holds it back (PERF.md §6): the E row gathers, one to four sectors
// each, out of the L2 at its sector rate, as for the wide layout and
// spmv_sum; beside them the latency of each batch's loads, which only more
// resident warps hide, and the majors' 134 MB.
// - Steps: the tile's edges go to the groups in turn, edge e0 + i * G + g
//   to group g; a warp issues the gathers of kNarrowAhead = 4 steps before
//   it adds any, and loads the next steps' minors meanwhile. Four steps
//   keep a thread at 64 registers, 32 resident warps a SM; eight steps
//   took 96 registers, 16 warps, and ran slower.
// - The row of each edge is the CSC's majors[e], one load a step with the
//   weight, off the gather's dependency chain. Searching the row ends
//   instead (ballots over the 32 row ends a warp holds, or a binary search
//   over the tile's offsets in shared memory) costs G searches or log2
//   dependent reads a step; the majors cost 4 B an edge of reads beyond
//   the bound, streamed and coalesced.
// - A step whose edges all lie in the row of the previous step's last edge
//   (the open row; every step inside a hub row) only adds into each group's
//   private sum. Any other step runs the segmented inclusive scan across
//   the groups (shfl_up by L, d lanes' groups back, where the rows agree,
//   stopping at the first round that no segment needs), adds the open
//   row's sum to the first segment, and has the last group of every
//   segment that ends inside the step write its row; the last edge's
//   segment becomes the open row, held by that group alone, so that the
//   next such step gathers the open sum with one shuffle, not log2(G).
// - Rows with no edges are written as 0 before the edges, one row a lane,
//   the loads of four rows in flight. The row the tile enters partway and
//   the row it leaves partway go to the same two carry slots as the wide
//   layout's, and the same fix-up kernel sums them: every Y row is written
//   once, no atomics, the same bits from run to run.
// - Unweighted products (Brandes' path counts) take their own instances,
//   with no weight loads and no multiply.
// - bf16 mode rounds w and X in the loop, as the wide scalar path does: no
//   path of the port runs bf16 below F = 128 (GraphSAGE's features are 128
//   wide, Brandes runs f32), and at F = 8 a bf16 row still costs a sector.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kChunk = 128;  // columns per warp pass: 32 lanes x 4
constexpr int kAhead = 8;  // row gathers a warp issues before it adds the first
constexpr int kNarrowAhead = 4;  // steps a warp of the narrow layout gathers ahead
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

// ------------------------------------------------------------ narrow layout

// kVec floats of one row (kVec = 4, 2 or 1), one load of 4 * kVec bytes.
template <int kVec>
struct Cols {
  float v[kVec];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int k = 0; k < kVec; ++k) v[k] = 0.0f;
  }
  __device__ __forceinline__ void load(const float* __restrict__ p) {
    if constexpr (kVec == 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p));
      v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else if constexpr (kVec == 2) {
      const float2 q = __ldg(reinterpret_cast<const float2*>(p));
      v[0] = q.x; v[1] = q.y;
    } else {
      v[0] = __ldg(p);
    }
  }
  __device__ __forceinline__ void store(float* __restrict__ p) const {
    if constexpr (kVec == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else if constexpr (kVec == 2) {
      *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
    } else {
      *p = v[0];
    }
  }
};

// One warp per tile, as spmm_tiles_kernel, with kLanes lanes to an edge:
// group g = lane / kLanes takes edges e0 + g, e0 + g + G, ..., and its lane
// q = lane % kLanes columns c0 + q * kVec .. + kVec - 1 of each column pass.
// See the source note for the steps, the open row and the segmented scan.
template <int kLanes, int kVec, bool kBf16, bool kWeighted>
__global__ void __launch_bounds__(kThreads)
spmm_narrow_kernel(const int* __restrict__ offsets, const int* __restrict__ majors,
                   const int* __restrict__ minors, const float* __restrict__ weights,
                   const float* __restrict__ x, const int* __restrict__ tile_row,
                   const int* __restrict__ tile_edge, float* __restrict__ y,
                   float* __restrict__ carry, int num_tiles, int f) {
  constexpr int kGroups = 32 / kLanes;
  constexpr int kCols = kLanes * kVec;      // columns of one pass
  constexpr int kBatch = kNarrowAhead * kGroups;  // edges of kNarrowAhead steps
  // tile is uniform across the warp, so whole warps exit together and the
  // full-mask shuffles below see all 32 lanes
  const int tile = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (tile >= num_tiles) return;
  const int g = lane / kLanes;
  const int q = lane % kLanes;
  const int r0 = __ldg(tile_row + tile), r1 = __ldg(tile_row + tile + 1);
  const int e0 = __ldg(tile_edge + tile), e1 = __ldg(tile_edge + tile + 1);
  const bool head = __ldg(offsets + r0) < e0;  // row r0 began in an earlier tile
  float* head_slot = carry + (static_cast<size_t>(tile) * 2) * f;
  float* tail_slot = head_slot + f;
  // where row r's sum goes: r is r0 (entered partway), a row that ends in
  // the tile, or r1 (left partway)
  auto dest = [&](int r) {
    return (r == r0 && head) ? head_slot : (r < r1 ? y + static_cast<size_t>(r) * f : tail_slot);
  };

  // the minors of the next kNarrowAhead steps, loaded while a batch
  // gathers; the first batch's before the pass over the empty rows
  int s_next[kNarrowAhead];
  auto load_minors = [&](int eb) {
#pragma unroll
    for (int u = 0; u < kNarrowAhead; ++u) {
      const int e = eb + u * kGroups + g;
      s_next[u] = e < e1 ? __ldg(minors + e) : 0;
    }
  };
  load_minors(e0);

  // the rows of r0 .. r1 - 1 with no edges are 0 (the head row has
  // edges), one row a lane, the loads of 4 rows in flight: a tile in a
  // run of short rows holds hundreds of rows
#pragma unroll 4
  for (int r = r0 + lane; r < r1; r += 32) {
    if (__ldg(offsets + r) == __ldg(offsets + r + 1)) {
      for (int c = 0; c < f; c += kVec) {
        Cols<kVec> z;
        z.zero();
        z.store(y + static_cast<size_t>(r) * f + c);
      }
    }
  }

  for (int c0 = 0; c0 < f; c0 += kCols) {
    const int c = c0 + q * kVec;
    const bool col = c < f;  // f % kVec == 0, so all kVec columns are in range
    float acc[kVec];         // this group's part of the open row's sum
#pragma unroll
    for (int k = 0; k < kVec; ++k) acc[k] = 0.0f;
    int open = r0;          // the row of the last edge added (uniform)
    bool open_has = head;   // open must be written: it has edges here, or is the head row
    int holder = 0;         // the one group whose acc may be non-zero; -1: any group's
    if (c0 > 0) load_minors(e0);  // a later column pass walks the edges again

    // the open row's sum, the same bits in every group
    auto open_sum = [&](float t[kVec]) {
      if (holder < 0) {
#pragma unroll
        for (int k = 0; k < kVec; ++k) t[k] = acc[k];
#pragma unroll
        for (int m = kLanes; m < 32; m <<= 1) {
#pragma unroll
          for (int k = 0; k < kVec; ++k) t[k] += __shfl_xor_sync(kFullMask, t[k], m);
        }
      } else {
#pragma unroll
        for (int k = 0; k < kVec; ++k) t[k] = __shfl_sync(kFullMask, acc[k], holder * kLanes + q);
      }
    };

    for (int eb = e0; eb < e1; eb += kBatch) {
      // kNarrowAhead gathers with nothing between them; past e1 a gather
      // reads row 0 of X, harmless, and its value is not added
      Cols<kVec> v[kNarrowAhead];
#pragma unroll
      for (int u = 0; u < kNarrowAhead; ++u) {
        if (col) v[u].load(x + static_cast<size_t>(s_next[u]) * f + c);
        else v[u].zero();
      }
      int row[kNarrowAhead];
      float w[kNarrowAhead];
#pragma unroll
      for (int u = 0; u < kNarrowAhead; ++u) {
        const int e = eb + u * kGroups + g;
        row[u] = e < e1 ? __ldg(majors + e) : INT_MAX;
        w[u] = (kWeighted && e < e1) ? __ldg(weights + e) : 1.0f;
      }
      load_minors(eb + kBatch);
#pragma unroll
      for (int u = 0; u < kNarrowAhead; ++u) {
        const int es = eb + u * kGroups;  // the step's first edge, uniform
        if (es < e1) {
          const int rg = row[u];
          const float wu = operand<kBf16>(w[u]);
          float p[kVec];
#pragma unroll
          for (int k = 0; k < kVec; ++k)
            p[k] = rg == INT_MAX ? 0.0f
                   : kWeighted ? wu * operand<kBf16>(v[u].v[k]) : operand<kBf16>(v[u].v[k]);
          if (__all_sync(kFullMask, rg == open)) {  // the open row goes on
#pragma unroll
            for (int k = 0; k < kVec; ++k) acc[k] += p[k];
            open_has = true;
            holder = -1;
          } else {
            float t[kVec];
            open_sum(t);
            // the segmented inclusive scan over the groups: a segment is a
            // run of groups whose edges share a row (rows rise with g)
#pragma unroll
            for (int d = 1; d < kGroups; d <<= 1) {
              const int rd = __shfl_up_sync(kFullMask, rg, d * kLanes);
              const bool same = g >= d && rd == rg && rg != INT_MAX;
              // no segment is longer than d: the later rounds add nothing
              if (!__any_sync(kFullMask, same)) break;
#pragma unroll
              for (int k = 0; k < kVec; ++k) {
                const float pd = __shfl_up_sync(kFullMask, p[k], d * kLanes);
                if (same) p[k] += pd;
              }
            }
            if (rg == open) {  // the first segment goes on with the open row
#pragma unroll
              for (int k = 0; k < kVec; ++k) p[k] += t[k];
            }
            const int first = __shfl_sync(kFullMask, rg, 0);
            if (first != open && open_has && g == 0 && col) {  // open ended before the step
              Cols<kVec> o;
#pragma unroll
              for (int k = 0; k < kVec; ++k) o.v[k] = t[k];
              o.store(dest(open) + c);
            }
            const int n = min(kGroups, e1 - es);  // groups with an edge, uniform
            const int next = __shfl_down_sync(kFullMask, rg, kLanes);
            if (g < n - 1 && next != rg && col) {  // a segment that ends inside the step
              Cols<kVec> o;
#pragma unroll
              for (int k = 0; k < kVec; ++k) o.v[k] = p[k];
              o.store(dest(rg) + c);
            }
            // the step's last segment is the new open row, held by group n - 1
            open = __shfl_sync(kFullMask, rg, (n - 1) * kLanes);
#pragma unroll
            for (int k = 0; k < kVec; ++k) acc[k] = g == n - 1 ? p[k] : 0.0f;
            holder = n - 1;
            open_has = true;
          }
        }
      }
    }
    float t[kVec];
    open_sum(t);
    if (open_has && g == 0 && col) {
      Cols<kVec> o;
#pragma unroll
      for (int k = 0; k < kVec; ++k) o.v[k] = t[k];
      o.store(dest(open) + c);
    }
  }
}

struct NarrowArgs {
  const int* offsets;
  const int* majors;
  const int* minors;
  const float* weights;
  const float* x;
  const int* tile_row;
  const int* tile_edge;
  float* y;
  float* carry;
  int num_tiles;
  int f;
};

template <int kLanes, int kVec, bool kBf16>
void launch_narrow(const NarrowArgs& a, cudaStream_t stream) {
  const unsigned blocks = (a.num_tiles + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (a.weights != nullptr)
    spmm_narrow_kernel<kLanes, kVec, kBf16, true><<<blocks, kThreads, 0, stream>>>(
        a.offsets, a.majors, a.minors, a.weights, a.x, a.tile_row, a.tile_edge, a.y, a.carry,
        a.num_tiles, a.f);
  else
    spmm_narrow_kernel<kLanes, kVec, kBf16, false><<<blocks, kThreads, 0, stream>>>(
        a.offsets, a.majors, a.minors, nullptr, a.x, a.tile_row, a.tile_edge, a.y, a.carry,
        a.num_tiles, a.f);
}

// false for a (lanes, vec) pair that has no kernel
template <int kVec, bool kBf16>
bool dispatch_narrow(int lanes, const NarrowArgs& a, cudaStream_t stream) {
  switch (lanes) {
    case 1: launch_narrow<1, kVec, kBf16>(a, stream); return true;
    case 2: launch_narrow<2, kVec, kBf16>(a, stream); return true;
    case 4: launch_narrow<4, kVec, kBf16>(a, stream); return true;
    case 8: launch_narrow<8, kVec, kBf16>(a, stream); return true;
    case 16: launch_narrow<16, kVec, kBf16>(a, stream); return true;
    case 32:
      // 16 lanes of float4 loads span NARROW_MAX_F = 64 columns, so no F
      // takes 32 of them: that instance is not built
      if constexpr (kVec == 4) {
        return false;
      } else {
        launch_narrow<32, kVec, kBf16>(a, stream);
        return true;
      }
    default: return false;
  }
}

template <bool kBf16>
bool dispatch_narrow(int lanes, int vec, const NarrowArgs& a, cudaStream_t stream) {
  switch (vec) {
    case 4: return dispatch_narrow<4, kBf16>(lanes, a, stream);
    case 2: return dispatch_narrow<2, kBf16>(lanes, a, stream);
    case 1: return dispatch_narrow<1, kBf16>(lanes, a, stream);
    default: return false;
  }
}

void launch_fixup(const int* offsets, const int* tile_row, const int* tile_edge,
                  const float* carry, float* y, int num_tiles, long long items_per_tile, int f,
                  bool vec4, cudaStream_t s) {
  if (num_tiles < 2) return;
  const unsigned blocks = (num_tiles - 1 + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (vec4) spmm_fixup_kernel<true><<<blocks, kThreads, 0, s>>>(
      offsets, tile_row, tile_edge, carry, y, num_tiles, items_per_tile, f);
  else spmm_fixup_kernel<false><<<blocks, kThreads, 0, s>>>(
      offsets, tile_row, tile_edge, carry, y, num_tiles, items_per_tile, f);
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
    launch_fixup(offsets, tile_row, tile_edge, carry, y, num_tiles, items_per_tile, f, vec4, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// The narrow layout: lanes (1, 2, 4, ..., 32) lanes to an edge, vec (4, 2
// or 1) floats a load; f % vec == 0 and x, y and carry aligned to 4 * vec
// bytes (the wrapper checks). majors is the CSC's row of each edge. The
// plan, carry and stream are as for cgt_spmm_rows; bf16 rounds in the loop.
// Returns cudaErrorInvalidValue for a (lanes, vec) pair with no kernel
// (32 lanes of float4: no F up to 64 takes it),
// else cudaGetLastError() after the launches.
extern "C" int cgt_spmm_rows_narrow(const int* offsets, const int* majors, const int* minors,
                                    const float* weights, const float* x, const int* tile_row,
                                    const int* tile_edge, float* carry, float* y, int num_tiles,
                                    long long items_per_tile, int f, int lanes, int vec,
                                    int bf16, void* stream) {
  if (num_tiles > 0 && f > 0) {
    if (f % vec != 0) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const NarrowArgs a{offsets, majors, minors, weights, x, tile_row, tile_edge, y, carry,
                       num_tiles, f};
    const bool ok = bf16 ? dispatch_narrow<true>(lanes, vec, a, s)
                         : dispatch_narrow<false>(lanes, vec, a, s);
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    launch_fixup(offsets, tile_row, tile_edge, carry, y, num_tiles, items_per_tile, f,
                 f % 4 == 0, s);
  }
  return static_cast<int>(cudaGetLastError());
}
