// The probe kernels of benchmarks/, for sm_90a: stream_scale, gather_rows,
// gather_window_sum, multiwin_reduce and seg_scan_rows.
//
// Each probe of the JAX package's benchmarks/ measured one thing that the
// TPU's SpMV and SpMM kernels are built from. On the H100 the same five
// functions give the card's own ceilings: the streaming copy rate of its
// HBM, the rate at which warps gather rows out of the L2 and out of HBM,
// what shared-memory atomics cost against global ones, and a per-lane
// segmented scan. Every bound below is stated as compulsory bytes (each
// input read once, each output written once) over the data sheet's
// 3.35 TB/s; the probes path of chip_smoke.py measures each kernel beside
// it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;

__host__ __device__ inline long long div_up(long long a, long long b) { return (a + b - 1) / b; }

// ---------------------------------------------------------------------------
// stream_scale: o = a * x.
//
// Replaces benchmarks/microbench_tpu.py:k1_copy (def 56, pallas_call 67;
// a = 2.0, tiles of 1,024 rows) and benchmarks/microbench3_tpu.py's
// build_benches.copy_kern (69, through block_call 29 / pallas_call 34;
// a = 1.000001, tiles of 512 rows). The TPU pipelines (T, 128) blocks
// through VMEM; here there is nothing to stage.
// Bound: memory, 2 x 4 B an element (x read once, o written once): at the
// probe's 131,072 x 128 f32, 134 MB, 40 us at 3.35 TB/s; at 2^21 rows
// (1 GiB each way, far past the 50 MB L2) 2.15 GB, 641 us. Design: a
// block a chunk of kStreamThreads x kStreamUnroll float4s (16 KB), each
// thread's four 16-byte loads issued before its stores, streaming
// (evict-first) loads and stores so that the copy does not sweep the L2
// for nothing, and no grid-stride loop: on the H100 a block a chunk
// streams faster than a grid-stride pass over a grid that fills the SMs
// once. A scalar path, a thread an element, takes x that is not 16-byte
// aligned or not whole float4s. __fmul_rn keeps one rounded product an element, the
// bits of the plain version's x * a.
constexpr int kStreamThreads = 256;
constexpr int kStreamUnroll = 4;

__global__ void __launch_bounds__(kStreamThreads)
stream_scale_vec(const float4* __restrict__ x, float4* __restrict__ o, long long n4, float a) {
  const long long base =
      static_cast<long long>(blockIdx.x) * kStreamThreads * kStreamUnroll + threadIdx.x;
  float4 r[kStreamUnroll];
#pragma unroll
  for (int k = 0; k < kStreamUnroll; ++k) {
    if (base + k * kStreamThreads < n4) r[k] = __ldcs(x + base + k * kStreamThreads);
  }
#pragma unroll
  for (int k = 0; k < kStreamUnroll; ++k) {
    if (base + k * kStreamThreads < n4) {
      __stcs(o + base + k * kStreamThreads,
             make_float4(__fmul_rn(r[k].x, a), __fmul_rn(r[k].y, a), __fmul_rn(r[k].z, a),
                         __fmul_rn(r[k].w, a)));
    }
  }
}

__global__ void __launch_bounds__(kStreamThreads)
stream_scale_scalar(const float* __restrict__ x, float* __restrict__ o, long long n, float a) {
  const long long i = static_cast<long long>(blockIdx.x) * kStreamThreads + threadIdx.x;
  if (i < n) o[i] = __fmul_rn(x[i], a);
}

// ---------------------------------------------------------------------------
// gather_rows: out[e] = table[ids[e]], rows of row_bytes.
//
// Replaces benchmarks/microbench4_rowgather.py:gather_only_call (42 / 53),
// benchmarks/microbench5_rowgather.py:gather_only_call (26 / 36) and
// benchmarks/microbench6_bf16row.py:gather_call (26 / 36): on the TPU, 128
// single-row dynamic slices a grid step out of a VMEM-resident table.
// Bound: memory. The ids (4 B a row), each distinct table row once and
// each output row once: at the probe's 262,144 ids into a 32,768-row f32
// table (16 MB, resident in the L2), 1 + 16 + 134 MB, 45 us; from a 2^21-row
// table (1 GiB, s21's vertex count) about 134 + 134 MB from HBM. Bytes
// moved are fixed, so what the design fights is latency: one warp a row,
// 32 lanes x 16 B for an f32 row of 128 (x 8 B for bf16), and each warp
// keeps kRowsInFlight rows' loads in flight before it stores any of them.
// A warp takes one group of rows (no grid-stride loop), and the output
// goes out with streaming stores, so that it does not evict the table
// from the L2.
// The wrapper checks every id against the table with one host read before
// the launch: an id out of range here would fault the context.
constexpr int kGatherThreads = 256;
constexpr int kRowsInFlight = 8;

template <typename V>
__global__ void __launch_bounds__(kGatherThreads)
gather_rows_kernel(const V* __restrict__ table, const int* __restrict__ ids, V* __restrict__ out,
                   long long n_rows, int vec_per_row) {
  const int lane = threadIdx.x & 31;
  const long long base =
      ((static_cast<long long>(blockIdx.x) * kGatherThreads + threadIdx.x) >> 5) * kRowsInFlight;
  if (base >= n_rows) return;
  const int mine = (lane < kRowsInFlight && base + lane < n_rows) ? __ldg(ids + base + lane) : 0;
  int id[kRowsInFlight];
#pragma unroll
  for (int k = 0; k < kRowsInFlight; ++k) id[k] = __shfl_sync(kFullMask, mine, k);
  for (int c = lane; c < vec_per_row; c += 32) {
    V r[kRowsInFlight];
#pragma unroll
    for (int k = 0; k < kRowsInFlight; ++k) {
      if (base + k < n_rows) r[k] = __ldg(table + static_cast<long long>(id[k]) * vec_per_row + c);
    }
#pragma unroll
    for (int k = 0; k < kRowsInFlight; ++k) {
      if (base + k < n_rows) __stcs(out + (base + k) * vec_per_row + c, r[k]);
    }
  }
}

template <typename V>
cudaError_t launch_gather(const void* table, const int* ids, void* out, long long n_rows,
                          int row_bytes, cudaStream_t s) {
  const int vec_per_row = row_bytes / static_cast<int>(sizeof(V));
  const long long groups = div_up(n_rows, kRowsInFlight);
  const unsigned blocks = static_cast<unsigned>(div_up(groups, kGatherThreads / 32));
  gather_rows_kernel<V><<<blocks, kGatherThreads, 0, s>>>(
      static_cast<const V*>(table), ids, static_cast<V*>(out), n_rows, vec_per_row);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// gather_window_sum: out[w * W + r] = sum over the window's edges e with
// dstl[e] = r of bf16(table[srcs[e]]), in f32; every row of every window is
// written, zeros where no edge lands.
//
// Replaces benchmarks/microbench4_rowgather.py:gather_matmul_call (68 /
// 120): a tile of 128 gathered rows, cast to bf16, times a one-hot (512,
// 128) bf16 matrix on the MXU with f32 accumulation, four tiles a window
// summed in a VMEM scratch. A GPU needs no one-hot product: it adds each
// gathered row into its destination row directly.
// Bound: memory. Ids 8 B an edge, the distinct table rows, the output
// (W x 128 x 4 B a window): at the probe's 262,144 edges, 512 windows,
// a 16 MB table, 2 + 16 + 134 MB, 45 us. A window's W x 128 f32 sum is
// 256 KB, more than a block's 227 KB of shared memory, so a block sums one
// window over kWinLanes = 32 lanes (64 KB of dynamic shared memory, three
// blocks an SM): zero the slab, each warp adds its edges' 32-lane slices
// (a 128 B load an edge, kEdgesInFlight edges' loads in flight) with
// shared-memory atomics (lane l to bank l, no bank conflicts), then write
// the slab out with streaming stores, zero rows included, 128 B a row.
// The atomics' order varies, so sums are not the same bits each run (the
// probes path holds them within a tolerance).
constexpr int kWindowRows = 512;   // W
constexpr int kWinLanes = 32;      // lanes a block sums
constexpr int kWinThreads = 512;   // 16 warps
constexpr int kEdgesInFlight = 8;  // edges a warp loads before adding
constexpr int kWinSmem = kWindowRows * kWinLanes * 4;

__global__ void __launch_bounds__(kWinThreads)
gather_window_sum_kernel(const float* __restrict__ table, const int* __restrict__ srcs,
                         const int* __restrict__ dstl, float* __restrict__ out, int width,
                         int edges_per_window) {
  extern __shared__ float acc[];  // kWindowRows x kWinLanes
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  constexpr int kWarps = kWinThreads / 32;
  for (int i = threadIdx.x; i < kWindowRows * kWinLanes; i += kWinThreads) acc[i] = 0.0f;
  __syncthreads();
  const long long e0 = static_cast<long long>(blockIdx.x) * edges_per_window;
  const int col = blockIdx.y * kWinLanes + lane;
  for (int e = warp * kEdgesInFlight; e < edges_per_window; e += kWarps * kEdgesInFlight) {
    int r[kEdgesInFlight];
    float v[kEdgesInFlight];
#pragma unroll
    for (int k = 0; k < kEdgesInFlight; ++k) {
      if (e + k < edges_per_window) {
        const int s = __ldg(srcs + e0 + e + k);
        r[k] = __ldg(dstl + e0 + e + k);
        v[k] = __ldg(table + static_cast<long long>(s) * width + col);
      }
    }
#pragma unroll
    for (int k = 0; k < kEdgesInFlight; ++k) {
      if (e + k < edges_per_window) {
        atomicAdd(&acc[r[k] * kWinLanes + lane], __bfloat162float(__float2bfloat16_rn(v[k])));
      }
    }
  }
  __syncthreads();
  float* o =
      out + static_cast<long long>(blockIdx.x) * kWindowRows * width + blockIdx.y * kWinLanes;
  for (int i = threadIdx.x; i < kWindowRows * kWinLanes; i += kWinThreads) {
    __stcs(o + static_cast<long long>(i / kWinLanes) * width + (i % kWinLanes), acc[i]);
  }
}

// ---------------------------------------------------------------------------
// multiwin_reduce: out.flat[wstart[w] + gdl[e]] += vals[e] over the
// window's kWindowEdges edges; out is zero when the call starts (the
// wrapper fills it) and windows may overlap.
//
// Replaces benchmarks/microbench_tpu.py:k6_multiwin_reduce (294 / 335) and
// benchmarks/microbench3_tpu.py's build_benches.mwr_kern (187; mwr_call
// 219 / pallas_call 220): on the TPU a (CAP_V, 128) one-hot compare-select
// a row of edges, summed over the lanes, 16 windows a grid step, the
// output block resident across the sequential grid. Blocks here run in no
// order, so a window's sums leave the block through global atomics.
// Bound: memory. vals and gdl 8 B an edge, wstart 4 B a window, the
// output written once: at the probe's 131,072 x 128 edges and 8,194 x 128
// outputs, 134 + 4 MB, 41 us. Design: a block a window, 256
// threads, a 256-slot sum in shared memory (shared-memory atomics, four
// edges a thread, loads first), then one global atomic a slot (a RED, no
// return). Its time against index_add_ over the precomputed keys (global
// atomics alone) is the port's first direct reading of shared-memory
// atomics against global ones.
constexpr int kCapV = 256;          // slots a window (CAP_V)
constexpr int kWindowEdges = 1024;  // edges a window: LW = 8 rows of 128
constexpr int kMwrThreads = kCapV;
constexpr int kMwrPerThread = kWindowEdges / kMwrThreads;

__global__ void __launch_bounds__(kMwrThreads)
multiwin_reduce_kernel(const int* __restrict__ wstart, const float* __restrict__ vals,
                       const int* __restrict__ gdl, float* __restrict__ out) {
  __shared__ float acc[kCapV];
  acc[threadIdx.x] = 0.0f;
  __syncthreads();
  const long long e0 = static_cast<long long>(blockIdx.x) * kWindowEdges + threadIdx.x;
  float v[kMwrPerThread];
  int g[kMwrPerThread];
#pragma unroll
  for (int k = 0; k < kMwrPerThread; ++k) {
    v[k] = __ldg(vals + e0 + k * kMwrThreads);
    g[k] = __ldg(gdl + e0 + k * kMwrThreads);
  }
#pragma unroll
  for (int k = 0; k < kMwrPerThread; ++k) atomicAdd(&acc[g[k]], v[k]);
  __syncthreads();
  atomicAdd(out + __ldg(wstart + blockIdx.x) + threadIdx.x, acc[threadIdx.x]);
}

// ---------------------------------------------------------------------------
// seg_scan_rows: per lane, within each tile of kSegTile rows, the inclusive
// sum down the rows, restarting at a row whose flag is not 0 and at the
// tile's first row.
//
// Replaces benchmarks/microbench_tpu.py:k8_seg_scan_reduce (354 / 379) and
// benchmarks/microbench3_tpu.py's build_benches.seg_kern (237, through
// block_call 29 / pallas_call 34): on the TPU a log-step (Hillis-Steele)
// segmented scan of a (512, 128) block by sublane rolls.
// Bound: memory, v and flags read once and out written once, 12 B an
// element: at the probe's 131,072 x 128, 201 MB, 60 us. Design: one thread
// a (tile, lane), walking its tile's rows in order, so neighbouring
// threads read neighbouring lanes (128 B a warp a row) and each sum is
// added in the same order as the plain version's (the same bits);
// kSegUnroll rows' loads in flight before the dependent adds. The probe's
// shape has only 32,768 such threads (~250 an SM), so latency, not the
// bytes, is what this simple design pays; a warp-level segmented scan
// over more threads is a later step.
constexpr int kSegTile = 512;
constexpr int kSegThreads = 128;
constexpr int kSegUnroll = 16;

__global__ void __launch_bounds__(kSegThreads)
seg_scan_rows_kernel(const float* __restrict__ v, const float* __restrict__ flags,
                     float* __restrict__ out, long long rows, int width) {
  const long long t = static_cast<long long>(blockIdx.x) * kSegThreads + threadIdx.x;
  const long long n_tiles = div_up(rows, kSegTile);
  if (t >= n_tiles * width) return;
  const long long r0 = (t / width) * kSegTile;
  const long long base = r0 * width + t % width;
  const int n = static_cast<int>(rows - r0 < kSegTile ? rows - r0 : kSegTile);
  float acc = 0.0f;
  int r = 0;
  for (; r + kSegUnroll <= n; r += kSegUnroll) {
    float x[kSegUnroll], f[kSegUnroll];
#pragma unroll
    for (int k = 0; k < kSegUnroll; ++k) {
      x[k] = __ldg(v + base + static_cast<long long>(r + k) * width);
      f[k] = __ldg(flags + base + static_cast<long long>(r + k) * width);
    }
#pragma unroll
    for (int k = 0; k < kSegUnroll; ++k) {
      acc = (f[k] != 0.0f || r + k == 0) ? x[k] : __fadd_rn(acc, x[k]);
      out[base + static_cast<long long>(r + k) * width] = acc;
    }
  }
  for (; r < n; ++r) {
    const float x = __ldg(v + base + static_cast<long long>(r) * width);
    const float f = __ldg(flags + base + static_cast<long long>(r) * width);
    acc = (f != 0.0f || r == 0) ? x : __fadd_rn(acc, x);
    out[base + static_cast<long long>(r) * width] = acc;
  }
}

}  // namespace

// C interface, loaded with ctypes. Every call enqueues its work on the
// caller's stream, does not synchronise, and returns the launch's CUDA
// error (0 on success). Arrays are contiguous; the wrapper
// (prims/cuda/probes.py) checks shapes, types and every index first.

// o[i] = a * x[i] for n floats; vec: x and o 16-byte aligned and n % 4 == 0.
extern "C" int cgt_stream_scale(const float* x, float* o, long long n, float a, int vec,
                                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  if (vec) {
    const long long n4 = n / 4;
    const unsigned blocks = static_cast<unsigned>(div_up(n4, kStreamThreads * kStreamUnroll));
    stream_scale_vec<<<blocks, kStreamThreads, 0, s>>>(reinterpret_cast<const float4*>(x),
                                                       reinterpret_cast<float4*>(o), n4, a);
  } else {
    const unsigned blocks = static_cast<unsigned>(div_up(n, kStreamThreads));
    stream_scale_scalar<<<blocks, kStreamThreads, 0, s>>>(x, o, n, a);
  }
  return static_cast<int>(cudaGetLastError());
}

// out row e = table row ids[e], n_rows rows of row_bytes bytes, copied in
// units of vec_bytes (16, 8, 4 or 2; it divides row_bytes and both
// pointers' alignment); ids in [0, table rows).
extern "C" int cgt_gather_rows(const void* table, const int* ids, void* out, long long n_rows,
                               int row_bytes, int vec_bytes, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_rows <= 0 || row_bytes <= 0) return 0;
  cudaError_t err;
  switch (vec_bytes) {
    case 16: err = launch_gather<uint4>(table, ids, out, n_rows, row_bytes, s); break;
    case 8: err = launch_gather<uint2>(table, ids, out, n_rows, row_bytes, s); break;
    case 4: err = launch_gather<unsigned int>(table, ids, out, n_rows, row_bytes, s); break;
    case 2: err = launch_gather<unsigned short>(table, ids, out, n_rows, row_bytes, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// out: n_windows x kWindowRows rows of width f32 (width % kWinLanes == 0);
// srcs, dstl: n_windows x edges_per_window ids, srcs in [0, table rows),
// dstl in [0, kWindowRows).
extern "C" int cgt_gather_window_sum(const float* table, const int* srcs, const int* dstl,
                                     float* out, int n_windows, int width, int edges_per_window,
                                     void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_windows <= 0 || width <= 0) return 0;
  static bool attr_set[64] = {false};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 0 && dev < 64 && !attr_set[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        gather_window_sum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWinSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set[dev] = true;
  }
  const dim3 grid(n_windows, width / kWinLanes);
  gather_window_sum_kernel<<<grid, kWinThreads, kWinSmem, s>>>(table, srcs, dstl, out, width,
                                                                edges_per_window);
  return static_cast<int>(cudaGetLastError());
}

// out: zeroed f32 array; vals, gdl: n_windows x kWindowEdges, gdl in
// [0, kCapV); wstart[w] + kCapV <= out's length.
extern "C" int cgt_multiwin_reduce(const int* wstart, const float* vals, const int* gdl,
                                   float* out, int n_windows, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_windows <= 0) return 0;
  multiwin_reduce_kernel<<<n_windows, kMwrThreads, 0, s>>>(wstart, vals, gdl, out);
  return static_cast<int>(cudaGetLastError());
}

// v, flags, out: rows x width f32.
extern "C" int cgt_seg_scan_rows(const float* v, const float* flags, float* out, long long rows,
                                 int width, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || width <= 0) return 0;
  const long long threads = div_up(rows, kSegTile) * width;
  seg_scan_rows_kernel<<<static_cast<unsigned>(div_up(threads, kSegThreads)), kSegThreads, 0, s>>>(
      v, flags, out, rows, width);
  return static_cast<int>(cudaGetLastError());
}
