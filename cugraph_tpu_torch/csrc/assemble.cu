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
// needs no staging: chunks copy straight from device memory to device
// memory with 16 B loads and stores. To write every output chunk once
// (the copied ones and the zero ones), the copy runs over OUTPUT chunks.
// One call, on the caller's stream:
//   1. cudaMemsetAsync(0xFF) over the inverse: inv[c] = -1 for every
//      output chunk; the host sets the error flag, a pinned host word, to
//      -1 ("no bad id");
//   2. invert_steps:  inv[cd[i]] = cs[i] for each step whose two chunk ids
//                     lie inside their arrays (cd is unique in a layout;
//                     with a repeated cd any one of its steps wins, where
//                     on the TPU the last one does); any other step sets
//                     the flag to 1 (pinned memory is mapped under unified
//                     addressing, so the kernel writes it directly).
//                     Storing the source chunk itself, not the step,
//                     leaves the copy one index load, not two in a chain;
//   3. copy_chunks:   a block an output chunk: it copies input chunk
//                     inv[c], or writes zeros where inv[c] < 0;
//   4. the call waits on an event recorded after invert_steps, so the
//      copy, already queued, starts with no gap while the host reads the
//      flag: a bad id returns -1 (the caller raises in the call, the
//      function's contract on both devices, and drops the output), and
//      otherwise the call returns with the copy still running.
// cs may repeat a chunk (a run's boundary chunk copied into two parts).
//
// Bound on an H100 SXM: memory. The function must read each copied chunk
// (CH * 512 B per step) and write every output row once: at RMAT scale 21
// (262,144 x 128 f32 binned rows, CH = 16) about 290 MB, ~87 us at
// 3.35 TB/s. The index arrays (4 or 8 B per step and per output chunk) add
// under 0.1%. A block an output chunk, each thread's two float4 loads
// issued before its stores, streams a chunk at close to the card's copy
// rate: 99.1 us, 0.87 of the bound (the split of `chip_smoke.py`'s
// scan/assemble path, H100 80GB HBM3, 700 W). What the design cuts is the work around the
// copy. The call must learn of a bad id before it returns, so it waits
// for the card; it waits for the index pass alone (a few microseconds),
// not for the copy, which runs while the host reads the flag and returns.
// Besides: one memset in place of a fill kernel, one index load in each
// block in place of two in a chain, one allocation (the output, the
// inverse after it), and the flag written by the kernel straight into
// pinned host memory, with no copy and no tensor index.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecPerThread = 2;  // float4 loads a thread issues before storing

template <typename Id>
__global__ void __launch_bounds__(kThreads)
invert_steps(const Id* __restrict__ chunk_src, const Id* __restrict__ chunk_dst,
             int* __restrict__ inv, int* flag, int n_steps, int in_chunks, int out_chunks) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_steps) return;
  const long long src = __ldg(chunk_src + i);
  const long long d = __ldg(chunk_dst + i);
  if (src >= 0 && src < in_chunks && d >= 0 && d < out_chunks) {
    inv[d] = static_cast<int>(src);
  } else {
    *flag = 1;
  }
}

__global__ void __launch_bounds__(kThreads)
copy_chunks(const float4* __restrict__ binned, const int* __restrict__ inv,
            float4* __restrict__ out, int vec_per_chunk) {
  const int c = blockIdx.x;
  const int src = __ldg(inv + c);  // in range (invert_steps) or -1
  float4* dst = out + static_cast<long long>(c) * vec_per_chunk;
  if (src < 0) {
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int v = threadIdx.x; v < vec_per_chunk; v += kThreads) dst[v] = zero;
    return;
  }
  const float4* from = binned + static_cast<long long>(src) * vec_per_chunk;
  for (int base = 0; base < vec_per_chunk; base += kThreads * kVecPerThread) {
    float4 r[kVecPerThread];
#pragma unroll
    for (int k = 0; k < kVecPerThread; ++k) {
      const int v = base + k * kThreads + threadIdx.x;
      if (v < vec_per_chunk) r[k] = __ldg(from + v);
    }
#pragma unroll
    for (int k = 0; k < kVecPerThread; ++k) {
      const int v = base + k * kThreads + threadIdx.x;
      if (v < vec_per_chunk) dst[v] = r[k];
    }
  }
}

}  // namespace

// C interface, loaded with ctypes. cgt_assemble_event creates the event
// the call waits on, for the current device; the caller keeps one a
// device and passes it to every call there.
extern "C" int cgt_assemble_event(void** event) {
  cudaEvent_t e = nullptr;
  const cudaError_t err = cudaEventCreateWithFlags(&e, cudaEventDisableTiming);
  *event = e;
  return static_cast<int>(err);
}

// binned and out are 16 B aligned f32 arrays of in_chunks and out_chunks
// chunks of vec_per_chunk float4s; the chunk ids are int64 where ids64 is
// set, else int32. inv is scratch of out_chunks ints, read by the copy
// after the call returns; host_flag is one pinned host int and indexed an
// event of cgt_assemble_event, both used only inside the call. The work
// goes on the caller's stream; the call waits for the index pass alone
// and returns 0 with the copy enqueued, -1 when a chunk id lay outside its
// array (the output is then to be dropped), else the CUDA error.
extern "C" int cgt_assemble_chunks(const float* binned, const void* chunk_src,
                                   const void* chunk_dst, int* inv, float* out, int* host_flag,
                                   void* indexed, int n_steps, int in_chunks, int out_chunks,
                                   int vec_per_chunk, int ids64, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaEvent_t done = static_cast<cudaEvent_t>(indexed);
  volatile int* flag = host_flag;
  *flag = -1;
  cudaError_t err = cudaSuccess;
  if (out_chunks > 0) cudaMemsetAsync(inv, 0xFF, static_cast<size_t>(out_chunks) * sizeof(int), s);
  if (n_steps > 0) {
    const int blocks = (n_steps + kThreads - 1) / kThreads;
    if (ids64) {
      invert_steps<long long><<<blocks, kThreads, 0, s>>>(
          static_cast<const long long*>(chunk_src), static_cast<const long long*>(chunk_dst),
          inv, host_flag, n_steps, in_chunks, out_chunks);
    } else {
      invert_steps<int><<<blocks, kThreads, 0, s>>>(
          static_cast<const int*>(chunk_src), static_cast<const int*>(chunk_dst), inv, host_flag,
          n_steps, in_chunks, out_chunks);
    }
    err = cudaEventRecord(done, s);
  }
  if (err == cudaSuccess && out_chunks > 0) {
    copy_chunks<<<out_chunks, kThreads, 0, s>>>(
        reinterpret_cast<const float4*>(binned), inv, reinterpret_cast<float4*>(out),
        vec_per_chunk);
  }
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err == cudaSuccess && n_steps > 0) err = cudaEventSynchronize(done);
  if (err != cudaSuccess) return static_cast<int>(err);
  return *flag == -1 ? 0 : -1;
}
