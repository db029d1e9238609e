// Exact k nearest neighbours for Hopper (sm_90a): indices only.
//
// Replaces the TPU kernel adaptpoint_tpu/ops/pallas/knn.py knn_pallas
// (_knn_kernel). Same function as the plain version ops/knn.py
// knn_idx_plain: for each query the k_eff = min(k, N) support points of
// smallest squared distance, nearest first, ties to the lowest index; when
// k > N the remaining slots repeat the nearest. Only the indices are
// produced: the caller recomputes the distances differentiably from the
// gathered rows (ops.knn_point), as the JAX package does around its kernel.
//
// Distance: the expanded form (|q|^2 + |x|^2) - 2 q.x, every product and sum
// rounded on its own and added in channel order (__fmul_rn / __fadd_rn, and
// the file builds with -fmad=false), which is the arithmetic the plain
// version writes out op by op. Distances are therefore equal bit for bit and
// near-ties resolve alike: the indices are compared exactly on the card. The
// TPU kernel's 6-term bf16 split of the cross product is the TPU's way to
// an f32 matmul and is not carried over.
//
// Design: one warp per query, a block of 8 warps walks a tile of 64 queries
// of one cloud. The block stages the cloud's support points in shared memory
// as C planes plus a plane of |x|^2 (conflict-free for any C). Selection
// needs no stored distance row: pass p takes the lexicographic minimum of
// (d2, index) over the points that come after pass p-1's winner in that
// order, so each of the k passes recomputes the distances (C multiplies a
// point) and reduces (d2, index) over the warp with shuffles. Nothing but
// the k indices leaves the block.
//
// What bounds it: operations. It reads (N + M) * C floats and writes M * k
// indices, a few hundred KB at the FP-decode shapes, but does
// k_eff * M * N * (2C + 3) f32 operations plus k_eff * 10 shuffles a query.
// Shared memory holds N * (C + 1) floats: N <= 14,000 at C = 3; a larger
// cloud is refused by the launch function.
#include <cuda_runtime.h>
#include <climits>
#include <cmath>

namespace {

constexpr int kWarps = 8;
constexpr int kQueriesPerBlock = 64;
constexpr size_t kMaxSmem = 227 * 1024;

__global__ void __launch_bounds__(kWarps * 32)
knn_kernel(const float* __restrict__ xyz, const float* __restrict__ query,
           int N, int M, int C, int K, int* __restrict__ idx) {
  extern __shared__ float planes[];  // C planes of N, then |x|^2 [N]
  float* x2 = planes + (size_t)C * N;
  const int b = blockIdx.y;
  const float* X = xyz + (size_t)b * N * C;
  for (int i = threadIdx.x; i < N; i += kWarps * 32) {
    float acc = 0.0f;
    for (int c = 0; c < C; ++c) {
      const float v = X[(size_t)i * C + c];
      planes[(size_t)c * N + i] = v;
      const float sq = __fmul_rn(v, v);
      acc = c == 0 ? sq : __fadd_rn(acc, sq);
    }
    x2[i] = acc;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int k_eff = K < N ? K : N;
  const int m_end = min(M, (blockIdx.x + 1) * kQueriesPerBlock);
  for (int m = blockIdx.x * kQueriesPerBlock + warp; m < m_end; m += kWarps) {
    const float* Q = query + ((size_t)b * M + m) * C;
    float q2 = 0.0f;
    for (int c = 0; c < C; ++c) {
      const float sq = __fmul_rn(Q[c], Q[c]);
      q2 = c == 0 ? sq : __fadd_rn(q2, sq);
    }
    int* out = idx + ((size_t)b * M + m) * K;
    float last_d = -INFINITY;
    int last_i = -1;
    int first = 0;
    for (int p = 0; p < k_eff; ++p) {
      float bd = INFINITY;
      int bi = INT_MAX;
      for (int j = lane; j < N; j += 32) {  // increasing j within a lane
        float cross = 0.0f;
        for (int c = 0; c < C; ++c) {
          const float pr = __fmul_rn(Q[c], planes[(size_t)c * N + j]);
          cross = c == 0 ? pr : __fadd_rn(cross, pr);
        }
        const float d = __fsub_rn(__fadd_rn(q2, x2[j]),
                                  __fmul_rn(2.0f, cross));
        const bool after = d > last_d || (d == last_d && j > last_i);
        if (after && d < bd) {  // strict: the lowest index of a tie stays
          bd = d;
          bi = j;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float od = __shfl_xor_sync(0xffffffffu, bd, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (od < bd || (od == bd && oi < bi)) {
          bd = od;
          bi = oi;
        }
      }
      if (bi == INT_MAX) bi = first;  // no candidate left (NaN distances)
      if (p == 0) first = bi;
      if (lane == 0) out[p] = bi;
      last_d = bd;
      last_i = bi;
    }
    for (int p = k_eff + lane; p < K; p += 32) out[p] = first;
  }
}

}  // namespace

extern "C" {

// Largest N the kernel takes at C channels (shared-memory planes).
int knn_max_points(int C) {
  return (int)(kMaxSmem / ((size_t)(C + 1) * sizeof(float)));
}

// xyz (B,N,C) f32 support, query (B,M,C) f32, contiguous -> idx (B,M,K) i32.
// Returns cudaError_t.
int knn_launch(const float* xyz, const float* query, int B, int N, int M,
               int C, int K, int* idx, cudaStream_t stream) {
  if (B <= 0 || N <= 0 || M <= 0 || C <= 0 || K <= 0 || B > 65535)
    return cudaErrorInvalidValue;
  const size_t smem = (size_t)N * (C + 1) * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      knn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((M + kQueriesPerBlock - 1) / kQueriesPerBlock, B);
  knn_kernel<<<grid, kWarps * 32, smem, stream>>>(xyz, query, N, M, C, K,
                                                  idx);
  return cudaGetLastError();
}

const char* apt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
