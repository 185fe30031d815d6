// Chunk-granular row copy, for sm_90a: assemble_chunks.
//
// Replaces this TPU kernel (cugraph_tpu/prims/pallas/):
//   spmv2.py:_assemble_call (def 1605, pallas_call 1627), the sorted
//   engine's K-C1 assembly: grid step i copies the (CH, 128) block of
//   binned rows [cs[i]*CH, (cs[i]+1)*CH) to output rows
//   [cd[i]*CH, (cd[i]+1)*CH), with cs and cd as scalar-prefetch operands
//   that drive the BlockSpec index maps. Output rows that no step writes
//   are left undefined there; here they are zero.
// The TPU walks the steps in order and DMAs each block through VMEM. A GPU
// needs no staging: blocks copy straight from device memory to device
// memory with 16 B loads and stores. To write every output chunk once
// (the copied ones and the zero ones), the copy runs over OUTPUT chunks:
//   1. init_inverse:  inv[c] = -1 for every output chunk, and the error
//                     flag after them 0;
//   2. invert_steps:  inv[cd[i]] = i for each step whose two chunk ids
//                     lie inside their arrays (cd is unique in a layout;
//                     with a repeated cd any one of its steps wins, where
//                     on the TPU the last one does); any other step raises
//                     the error flag;
//   3. copy_chunks:   block c copies input chunk cs[inv[c]], or writes
//                     zeros where inv[c] < 0.
// cs may repeat a chunk (a run's boundary chunk copied into two parts).
// A step whose chunk ids fall outside the arrays touches no memory it does
// not own: it is skipped, and the caller reads the flag and raises.
//
// Bound on an H100 SXM: memory. The function must read each copied chunk
// (CH * 512 B per step) and write every output row once: at RMAT scale 21
// (262,144 x 128 f32 binned rows, CH = 16) about 268 MB, ~80 us at
// 3.35 TB/s. The index arrays (4 B per step and per output chunk) add
// under 0.1%.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) init_inverse(int* __restrict__ inv, int count) {
  for (int i = blockIdx.x * kThreads + threadIdx.x; i <= count; i += gridDim.x * kThreads)
    inv[i] = i < count ? -1 : 0;  // inv[count] is the error flag
}

__global__ void __launch_bounds__(kThreads)
invert_steps(const int* __restrict__ chunk_src, const int* __restrict__ chunk_dst,
             int* __restrict__ inv, int n_steps, int in_chunks, int out_chunks) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_steps) return;
  const int src = __ldg(chunk_src + i);
  const int d = __ldg(chunk_dst + i);
  if (src >= 0 && src < in_chunks && d >= 0 && d < out_chunks) {
    inv[d] = i;
  } else {
    inv[out_chunks] = 1;
  }
}

__global__ void __launch_bounds__(kThreads)
copy_chunks(const float4* __restrict__ binned, const int* __restrict__ chunk_src,
            const int* __restrict__ inv, float4* __restrict__ out, int vec_per_chunk) {
  const int c = blockIdx.x;
  const int step = __ldg(inv + c);
  const int src = step >= 0 ? __ldg(chunk_src + step) : -1;  // in range (invert_steps)
  float4* dst = out + static_cast<long long>(c) * vec_per_chunk;
  if (src < 0) {
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int v = threadIdx.x; v < vec_per_chunk; v += kThreads) dst[v] = zero;
    return;
  }
  const float4* from = binned + static_cast<long long>(src) * vec_per_chunk;
#pragma unroll 4
  for (int v = threadIdx.x; v < vec_per_chunk; v += kThreads) dst[v] = __ldg(from + v);
}

}  // namespace

// C interface, loaded with ctypes. binned and out are 16 B aligned f32
// arrays of in_chunks and out_chunks chunks of vec_per_chunk float4s;
// inv is scratch of out_chunks + 1 ints, and inv[out_chunks] is left 1 if
// a chunk id fell outside its array, else 0. The launches go on the
// caller's stream and do not synchronise; the return value is
// cudaGetLastError() after them.
extern "C" int cgt_assemble_chunks(const float* binned, const int* chunk_src,
                                   const int* chunk_dst, int* inv, float* out, int n_steps,
                                   int in_chunks, int out_chunks, int vec_per_chunk,
                                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  init_inverse<<<(out_chunks + kThreads) / kThreads, kThreads, 0, s>>>(inv, out_chunks);
  if (n_steps > 0) {
    invert_steps<<<(n_steps + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        chunk_src, chunk_dst, inv, n_steps, in_chunks, out_chunks);
  }
  if (out_chunks > 0) {
    copy_chunks<<<out_chunks, kThreads, 0, s>>>(
        reinterpret_cast<const float4*>(binned), chunk_src, inv,
        reinterpret_cast<float4*>(out), vec_per_chunk);
  }
  return static_cast<int>(cudaGetLastError());
}
