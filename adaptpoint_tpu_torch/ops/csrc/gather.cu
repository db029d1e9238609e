// Row gather and its scatter-add backward for Hopper (sm_90a).
//
// Replaces the TPU kernels adaptpoint_tpu/ops/pallas/gather.py
// gather_rows_pallas (_fwd_kernel) and its VJP _bwd (_bwd_kernel). Same
// functions as the plain versions in ops/gather.py:
//   forward   out[b, m, :]          = pts[b, idx[b, m], :]      (exact copy)
//   backward  g_pts[b, idx[b, m], :] += g[b, m, :]              (f32 sums,
//             duplicates all added, then cast to the primal type)
// for float32 and bfloat16 rows. The TPU kernels gather with one-hot
// matmuls and a 3-way bf16 split because the TPU has no fast row gather;
// here a row is addressed directly.
//
// Design: one thread per output element, flat over (b, m, c), so that
// neighbouring threads read and write neighbouring channels of a row and
// then neighbouring rows: loads and stores are coalesced over C. The
// forward is a pure copy and is written once per element size (4 or 2
// bytes). The backward adds with atomicAdd into an f32 buffer the launch
// function zeroes on the stream first: g_pts itself for f32, a scratch
// buffer of the caller for bf16, which a second small kernel rounds to bf16.
//
// What bounds them: bytes (every input read once, every output written
// once), and at the train step's shape, (32, 2048, 4) -> 1024 rows, about
// 1 MB, the launch latency. The order of the atomic adds is not fixed, so
// where indices repeat the f32 sum can differ in its last bits from run to
// run; with distinct indices (the resampling gather) it is exact.
//
// Indices must lie in [0, N): the kernels do not check (the one-hot TPU
// kernel yields a zero row there; the model never passes one).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const T* __restrict__ pts, const int* __restrict__ idx,
                   long long total, int N, int M, int C,
                   T* __restrict__ out) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= total) return;
  const long long bm = e / C;
  const int c = (int)(e - bm * C);
  const long long b = bm / M;
  const int j = idx[bm];
  out[e] = pts[((size_t)b * N + j) * C + c];
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scatter_add_rows_kernel(const T* __restrict__ g, const int* __restrict__ idx,
                        long long total, int N, int M, int C,
                        float* __restrict__ acc) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= total) return;
  const long long bm = e / C;
  const int c = (int)(e - bm * C);
  const long long b = bm / M;
  const int j = idx[bm];
  atomicAdd(acc + ((size_t)b * N + j) * C + c, to_f32(g[e]));
}

__global__ void __launch_bounds__(kThreads)
round_to_bf16_kernel(const float* __restrict__ acc, long long total,
                     __nv_bfloat16* __restrict__ out) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e < total) out[e] = __float2bfloat16_rn(acc[e]);
}

inline int blocks_for(long long total) {
  return (int)((total + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// pts (B,N,C), idx (B,M) i32 -> out (B,M,C); elem_bytes 4 (f32) or 2 (bf16),
// all contiguous. Returns cudaError_t.
int gather_rows_launch(const void* pts, const int* idx, int B, int N, int M,
                       int C, int elem_bytes, void* out,
                       cudaStream_t stream) {
  if (B <= 0 || N <= 0 || M <= 0 || C <= 0) return cudaErrorInvalidValue;
  const long long total = (long long)B * M * C;
  if (elem_bytes == 4) {
    gather_rows_kernel<uint32_t><<<blocks_for(total), kThreads, 0, stream>>>(
        (const uint32_t*)pts, idx, total, N, M, C, (uint32_t*)out);
  } else if (elem_bytes == 2) {
    gather_rows_kernel<uint16_t><<<blocks_for(total), kThreads, 0, stream>>>(
        (const uint16_t*)pts, idx, total, N, M, C, (uint16_t*)out);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// g (B,M,C) f32 or bf16, idx (B,M) i32 -> g_pts (B,N,C) of the same type.
// acc is the f32 accumulator (B,N,C): g_pts itself for f32 (acc == g_pts),
// a scratch buffer for bf16. It is zeroed here, on the stream.
int gather_rows_bwd_launch(const void* g, const int* idx, int B, int N, int M,
                           int C, int elem_bytes, float* acc, void* g_pts,
                           cudaStream_t stream) {
  if (B <= 0 || N <= 0 || M <= 0 || C <= 0) return cudaErrorInvalidValue;
  const long long total = (long long)B * M * C;
  const long long total_out = (long long)B * N * C;
  cudaError_t e = cudaMemsetAsync(acc, 0, (size_t)total_out * sizeof(float),
                                  stream);
  if (e != cudaSuccess) return e;
  if (elem_bytes == 4) {
    if ((void*)acc != g_pts) return cudaErrorInvalidValue;
    scatter_add_rows_kernel<float>
        <<<blocks_for(total), kThreads, 0, stream>>>(
            (const float*)g, idx, total, N, M, C, acc);
  } else if (elem_bytes == 2) {
    scatter_add_rows_kernel<__nv_bfloat16>
        <<<blocks_for(total), kThreads, 0, stream>>>(
            (const __nv_bfloat16*)g, idx, total, N, M, C, acc);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    round_to_bf16_kernel<<<blocks_for(total_out), kThreads, 0, stream>>>(
        acc, total_out, (__nv_bfloat16*)g_pts);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

const char* apt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
