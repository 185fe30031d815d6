// Inclusive prefix sum of a flat f32 array, for sm_90a: cumsum_flat.
//
// Replaces this TPU kernel (cugraph_tpu/prims/pallas/):
//   scan.py:_scan_kernel (41), launched by cumsum_flat (59, pallas_call 71).
// The TPU kernel walks (1536, 128) tiles in grid order on one core: a
// lane prefix and a row prefix by log-step rolls (Mosaic has no cumsum
// primitive) plus a running total carried in SMEM from one grid step to
// the next. Blocks of a GPU run in no order, so the carry from tile to tile
// goes through device memory instead: a single pass with decoupled
// look-back (Merrill & Garland, "Single-pass Parallel Prefix Scan with
// Decoupled Look-back", NVIDIA NVR-2016-002).
//
// Bound on an H100 SXM: memory. The function must read n * 4 B and write
// n * 4 B: 268 MB at n = 2^25, ~80 us at 3.35 TB/s. This kernel reads x
// once and writes y once; the status words add 16 B a tile (131 KB at
// n = 2^25, cleared by a memset). The look-back has a limit of its own:
// the front of published prefixes advances at most one window of 32
// predecessors per round trip to the L2, so a window's status must come
// back in one round trip: no fence and no second read. The rest is
// occupancy: a thread holds its 32 elements in registers through the
// look-back, so blocks of 128 threads (64 registers, 8 blocks and 128 KB
// of loads in flight an SM) keep the memory busier than blocks of 256 or
// 512; x is read and y written with streaming hints (evict first), since
// neither is read again.
//
// Design. One block of 128 threads a tile of 4096 elements. Each block
// takes its tile id from an atomic ticket, not from blockIdx, so every
// predecessor of a tile has started when its look-back waits on it.
//   1. Load: thread t owns the 16-byte chunks j * 128 + t (j = 0 .. 7) of
//      its tile, one float4 each (coalesced); an unaligned x or y, and
//      the ragged last tile, take guarded scalar loads of the same
//      elements, so the arithmetic is the same on every path.
//   2. Tile scan in f32, in a fixed tree: each chunk's 4 elements in
//      order; for each j, a shuffle scan of the 32 chunk totals of a warp;
//      then warp 0 scans the 32 warp totals (j-major: j = 0's 4 warps,
//      then j = 1's, ...). The last of those is the tile's aggregate.
//   3. Look-back (warp 0): publish the aggregate (A), then read the status
//      of the 32 tiles before this one at a time, lane l the tile l + 1
//      back, waiting until each has published something. The nearest
//      tile with an inclusive prefix (P) ends the walk: its prefix and
//      the aggregates after it are added in f64 by a shuffle tree, window
//      by window. Publish this tile's inclusive prefix (P). A tile's
//      status is two 64-bit words, each valid on its own and stored whole
//      (no fence, one round trip a window): the aggregate's with a flag
//      beside the f32 bits, the prefix's as the complement of the f64
//      bits (0, the cleared state, is then no prefix). Whatever a reader
//      sees of the two words, it pairs no flag with another value.
//   4. Write: y = (float)(prefix64 + local), with local the element's f32
//      prefix within the tile: one rounding from the carry.
// Carries in f64: tile aggregates are f32, so their f64 sums are exact
// while the aggregates lie within about 2^16 of each other in magnitude
// (24 + 16 + 13 bits for 2^13 tiles). The result then does not depend on
// how far each look-back reached, and a second launch gives the same bits.
// Error at element i: the tile tree's f32 roundings (3 in the chunk, 5 and
// 5 in the two shuffle scans, 2 adding the offsets) plus the final one:
// at most ~16 x 2^-24 of the prefix of |x| up to i.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunks = 8;  // float4 chunks a thread
constexpr int kTile = kThreads * kChunks * 4;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr unsigned long long kAggregateFlag = 1ull << 32;

static_assert(kWarps * kChunks == 32, "warp 0 scans one warp total a lane");

__device__ __forceinline__ float warp_inclusive_scan(float v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(kFullMask, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

// Status words, cleared before the launch: the ticket counter (16 B), then
// two 64-bit words a tile: word[2t] = kAggregateFlag | the f32 bits of its
// aggregate, word[2t + 1] = ~(the f64 bits of its inclusive prefix).
struct Status {
  int* ticket;
  volatile unsigned long long* word;
};

__device__ __forceinline__ unsigned long long prefix_word(double v) {
  const unsigned long long bits = static_cast<unsigned long long>(__double_as_longlong(v));
  // all-ones bits are a NaN whose word would read as "not yet": store
  // another quiet NaN instead
  return bits == ~0ull ? ~0x7ff8000000000000ull : ~bits;
}

// Warp 0: publish the tile's aggregate, look back, publish its prefix;
// returns the sum of the tiles before this one (on every lane).
__device__ double look_back(const Status& st, int tile, float total, int lane) {
  if (tile == 0) {
    if (lane == 0) st.word[1] = prefix_word(static_cast<double>(total));
    return 0.0;
  }
  if (lane == 0) st.word[2 * tile] = kAggregateFlag | __float_as_uint(total);
  double exclusive = 0.0;
  for (int end = tile;; end -= 32) {
    const int p = end - 1 - lane;  // lane 0 is the nearest predecessor
    unsigned long long agg = 0ull, pre = ~0ull;  // before tile 0: a prefix of 0
    if (p >= 0) {
      do {
        agg = st.word[2 * p];
        pre = st.word[2 * p + 1];
      } while ((agg | pre) == 0ull);
    }
    const unsigned prefixes = __ballot_sync(kFullMask, pre != 0ull);
    const int near = prefixes ? __ffs(prefixes) - 1 : 32;
    double v = 0.0;
    if (lane <= near)
      v = pre != 0ull ? __longlong_as_double(static_cast<long long>(~pre))
                      : static_cast<double>(__uint_as_float(static_cast<unsigned>(agg)));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFullMask, v, o);
    exclusive += v;  // lane 0's sum is the window's
    if (prefixes) break;
  }
  exclusive = __shfl_sync(kFullMask, exclusive, 0);
  if (lane == 0) st.word[2 * tile + 1] = prefix_word(exclusive + static_cast<double>(total));
  return exclusive;
}

template <bool kAligned>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const float* __restrict__ x, float* __restrict__ y, long long n, Status st) {
  __shared__ int s_tile;
  __shared__ float s_warp[32];  // warp totals, then their exclusive offsets
  __shared__ double s_prefix;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_tile = atomicAdd(st.ticket, 1);
  __syncthreads();
  const int tile = s_tile;
  const long long base = static_cast<long long>(tile) * kTile;
  const bool vec = kAligned && base + kTile <= n;

  float v[kChunks][4];
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const long long at = base + 4 * (static_cast<long long>(j) * kThreads + tid);
    if (vec) {
      const float4 q = __ldcs(reinterpret_cast<const float4*>(x + at));
      v[j][0] = q.x;
      v[j][1] = q.y;
      v[j][2] = q.z;
      v[j][3] = q.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) v[j][k] = at + k < n ? __ldg(x + at + k) : 0.0f;
    }
  }

  // each chunk's prefix, then the warp scan of each j's chunk totals
  float exc[kChunks];
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
#pragma unroll
    for (int k = 1; k < 4; ++k) v[j][k] += v[j][k - 1];
    const float inc = warp_inclusive_scan(v[j][3], lane);
    const float up = __shfl_up_sync(kFullMask, inc, 1);
    exc[j] = lane == 0 ? 0.0f : up;
    if (lane == 31) s_warp[j * kWarps + warp] = inc;
  }
  __syncthreads();

  if (warp == 0) {
    const float inc = warp_inclusive_scan(s_warp[lane], lane);
    const float total = __shfl_sync(kFullMask, inc, 31);
    const float up = __shfl_up_sync(kFullMask, inc, 1);
    const double prefix = look_back(st, tile, total, lane);
    __syncwarp();
    s_warp[lane] = lane == 0 ? 0.0f : up;  // the offset of warp total `lane` in the tile
    if (lane == 0) s_prefix = prefix;
  }
  __syncthreads();

  const double prefix = s_prefix;
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const float off = s_warp[j * kWarps + warp] + exc[j];
    float o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      o[k] = static_cast<float>(prefix + static_cast<double>(off + v[j][k]));
    const long long at = base + 4 * (static_cast<long long>(j) * kThreads + tid);
    if (vec) {
      __stcs(reinterpret_cast<float4*>(y + at), make_float4(o[0], o[1], o[2], o[3]));
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (at + k < n) y[at + k] = o[k];
    }
  }
}

}  // namespace

// C interface, loaded with ctypes. status holds 16 * (tiles + 1) bytes,
// tiles = ceil(n / 4096), 8-byte aligned: the ticket (16 B), then two
// 64-bit words a tile. It is cleared here (one memset), then one kernel
// runs; both go on the caller's stream and do not synchronise. The return
// value is the first CUDA error.
extern "C" int cgt_cumsum_flat(const float* x, float* y, void* status, long long n,
                               void* stream) {
  if (n > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const long long tiles = (n + kTile - 1) / kTile;
    if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    char* words = static_cast<char*>(status);
    Status st;
    st.ticket = reinterpret_cast<int*>(words);
    st.word = reinterpret_cast<unsigned long long*>(words + 16);
    const cudaError_t rc = cudaMemsetAsync(words, 0, 16 * (tiles + 1), s);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    const unsigned grid = static_cast<unsigned>(tiles);
    const bool aligned =
        ((reinterpret_cast<std::uintptr_t>(x) | reinterpret_cast<std::uintptr_t>(y)) & 15) == 0;
    if (aligned) scan_kernel<true><<<grid, kThreads, 0, s>>>(x, y, n, st);
    else scan_kernel<false><<<grid, kThreads, 0, s>>>(x, y, n, st);
  }
  return static_cast<int>(cudaGetLastError());
}
