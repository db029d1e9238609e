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
// Forward design: rows are the unit. A row of C * elem_bytes bytes moves in
// the widest accesses its size and the pointers allow (16, 8, 4 or 2
// bytes: C = 4 f32 is one 16-byte load a row, C = 3 f32 three 4-byte
// ones), by one thread or, for wide rows, a group of lanes (a power of two,
// at most 32, so that a lane moves about 4 accesses: C = 1024 f32 is a warp
// with 8 float4s a lane). The group loads the row's index once and divides
// by M once (32 bits); a grid of at most 8 blocks an SM walks the rows with
// a grid stride. The launch function picks the access width and the group.
//
// Backward design: one thread per element, flat over (b, m, c), so that
// neighbouring threads read and write neighbouring channels of a row and
// then neighbouring rows. It adds with atomicAdd into an f32 buffer the
// launch function zeroes on the stream first: g_pts itself for f32, a
// scratch buffer of the caller for bf16, which a second small kernel rounds
// to bf16.
//
// What bounds them: bytes (every input read once, every output written
// once); at the train step's shape, (32, 2048, 4) -> 1024 rows, about 1 MB,
// the launch. The order of the atomic adds is not fixed, so where indices
// repeat the f32 sum can differ in its last bits from run to run; with
// distinct indices (the resampling gather) it is exact.
//
// Indices must lie in [0, N): the kernels do not check (the one-hot TPU
// kernel yields a zero row there; the model never passes one).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kSms = 132;          // H100 SXM
constexpr int kBlocksPerSm = 8;    // 2048 threads an SM

// rows B * M of vpr accesses of type V each; 2^lshift lanes a row
template <typename V>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const V* __restrict__ pts, const int* __restrict__ idx,
                   int rows, int N, int M, int vpr, int lshift,
                   V* __restrict__ out) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int sub = threadIdx.x & ((1 << lshift) - 1);
  const int stride = (gridDim.x * kThreads) >> lshift;
  for (int r = t >> lshift; r < rows; r += stride) {
    const unsigned b = (unsigned)r / (unsigned)M;
    const V* src = pts + ((size_t)b * N + __ldg(idx + r)) * vpr;
    V* dst = out + (size_t)r * vpr;
    for (int v = sub; v < vpr; v += 1 << lshift) dst[v] = __ldg(src + v);
  }
}

template <typename V>
cudaError_t launch_gather(const void* pts, const int* idx, int rows, int N,
                          int M, int row_bytes, cudaStream_t stream,
                          void* out) {
  const int vpr = row_bytes / (int)sizeof(V);
  int lshift = 0;  // about 4 accesses a lane, at most a warp a row
  while (lshift < 5 && (4 << lshift) < vpr) ++lshift;
  const long long threads = (long long)rows << lshift;
  const long long want = (threads + kThreads - 1) / kThreads;
  const int blocks = (int)(want < kSms * kBlocksPerSm ? want
                                                      : kSms * kBlocksPerSm);
  gather_rows_kernel<V><<<blocks, kThreads, 0, stream>>>(
      static_cast<const V*>(pts), idx, rows, N, M, vpr, lshift,
      static_cast<V*>(out));
  return cudaGetLastError();
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
// all contiguous; B * M and B * N * C below 2^31. Returns cudaError_t.
int gather_rows_launch(const void* pts, const int* idx, int B, int N, int M,
                       int C, int elem_bytes, void* out,
                       cudaStream_t stream) {
  if (B <= 0 || N <= 0 || M <= 0 || C <= 0 ||
      (elem_bytes != 4 && elem_bytes != 2) ||
      (long long)B * M > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const int rows = B * M;
  const int row_bytes = C * elem_bytes;
  const uintptr_t align = reinterpret_cast<uintptr_t>(pts) |
                          reinterpret_cast<uintptr_t>(out) |
                          (uintptr_t)row_bytes;
  if (align % 16 == 0)
    return launch_gather<uint4>(pts, idx, rows, N, M, row_bytes, stream, out);
  if (align % 8 == 0)
    return launch_gather<uint2>(pts, idx, rows, N, M, row_bytes, stream, out);
  if (align % 4 == 0)
    return launch_gather<uint32_t>(pts, idx, rows, N, M, row_bytes, stream,
                                   out);
  return launch_gather<uint16_t>(pts, idx, rows, N, M, row_bytes, stream,
                                 out);
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
