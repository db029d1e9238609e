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
// an f32 matmul and is not carried over. A distance that is NaN or +inf is
// never selected; a query left without candidates repeats its nearest (index
// 0 if it has none).
//
// What bounds it: operations. It reads (N + M) * C floats and writes M * k
// indices, a few hundred KB at the FP-decode shapes, but computes M * N
// distances (2C + 3 operations each) and keeps the k smallest.
//
// Design: one pass over the support a query. A sorted list of the L nearest
// (distance, index) pairs so far lives in registers; a point enters it only
// if it is strictly nearer than the list's last, behind any equal distance,
// so among equal distances the lower index (scanned first) stays first. The
// block stages its cloud's support in shared memory: (x, y, z, |x|^2) as one
// float4 a point at C = 3, else C planes and a plane of |x|^2. Two variants,
// which the wrapper picks by (k, N, C) (ops/knn.py knn_variant):
//   - a thread a query (C = 3, k <= 8; the FP decode's k = 3): 128 queries a
//     block, the query and |q|^2 in registers, every support read a broadcast
//     of one float4 to the warp; the list of L = k (3) or 8 is the output;
//   - a warp a query (k > 8, or C != 3): lane l scans points l, l + 32, ...
//     into its own list of L = min(k, ceil(N / 32)) rounded up to a power of
//     two; then k_eff rounds of a warp argmin over the lists' heads
//     (redux.sync min of the distance's order-preserving bits, then of the
//     index among the lanes that hold it) pop the winners in order. At C = 3
//     the query sits in registers; otherwise each channel of the query is a
//     warp-wide broadcast load.
// Nothing but the k indices leaves the block. Shared memory holds
// N * (C + 1) floats: N <= knn_max_points(C) (14,528 at C = 3).
//
// Past knn_max_points(C) (DGCNN's feature-space graphs: N = 1024 at C = 64
// and 128, where the staged support would need 266 and 529 KB) the tiled
// instance, knn_tiled_kernel, takes the same warp-a-query scan and streams
// the support through shared memory instead: tiles of T points as C + 1
// planes of T + 1 floats (the pad keeps both the coalesced staging stores
// and the scan's reads free of bank conflicts), |x|^2 computed in channel
// order once the tile is in. Lane l scans tile points l, l + 32, ..., so
// across tiles each lane still meets its points in increasing index order
// and its sorted list, kept in registers from tile to tile, breaks ties as
// the staged instance does: the indices equal the plain version's bit for
// bit. The warp's query (C floats) and |q|^2 stay in shared memory and
// registers for the whole scan. T (knn_tile_points) is the largest of 256,
// 128, 64, 32 whose tile and 8 queries leave room for two blocks an SM, 32
// up to the block's limit past that; C <= knn_tiled_max_channels() (1,416).
// A block reads its cloud's support once per 8 queries, from L2 at these
// sizes. The bound is operations, M * N * (2C + 2) a cloud (C products and
// C - 1 sums of q.x, |q|^2 + |x|^2, the doubling, the difference), without
// FMAs; its pace is set by shared memory, two loads a multiply-add.
#include <cuda_runtime.h>
#include <climits>
#include <cmath>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreadQueries = 128;  // a block of the thread-a-query variant
constexpr int kWarpsPerBlock = 8;    // the warp-a-query variant
constexpr size_t kMaxSmem = 227 * 1024;
// the most a tiled block may use for two blocks to share an SM:
// (228 KB - 2 x 1 KB the hardware keeps per block) / 2
constexpr size_t kTwoBlocksSmem = 115712;

// Shared memory of a tiled block: C + 1 planes of T + 1 floats, then the
// block's queries (C floats each).
size_t tiled_smem(int T, int C) {
  return ((size_t)(C + 1) * (T + 1) + (size_t)kWarpsPerBlock * C) *
         sizeof(float);
}

// Sorted insertion of (d, j) into (ld, li)[0..L): only where d is strictly
// smaller than the last entry; behind entries of equal distance.
template <int L>
__device__ __forceinline__ void insert(float (&ld)[L], int (&li)[L], float d,
                                       int j) {
  if (!(d < ld[L - 1])) return;  // also drops NaN
#pragma unroll
  for (int t = L - 1; t > 0; --t) {
    if (d < ld[t - 1]) {
      ld[t] = ld[t - 1];
      li[t] = li[t - 1];
    } else if (d < ld[t]) {
      ld[t] = d;
      li[t] = j;
    }
  }
  if (d < ld[0]) {
    ld[0] = d;
    li[0] = j;
  }
}

// The distance's bits in an order that follows the float order (no NaN).
__device__ __forceinline__ unsigned ordered(float d) {
  const unsigned u = __float_as_uint(__fadd_rn(d, 0.0f));  // -0 -> +0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The cloud's support into shared memory: float4 (x, y, z, |x|^2) at C = 3,
// else C planes of N and |x|^2 after them.
template <bool kC3>
__device__ __forceinline__ void stage_support(const float* X, int N, int C,
                                              float* sm) {
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    float acc = 0.0f;
    if (kC3) {
      const float x = X[(size_t)i * 3], y = X[(size_t)i * 3 + 1],
                  z = X[(size_t)i * 3 + 2];
      acc = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                      __fmul_rn(z, z));
      reinterpret_cast<float4*>(sm)[i] = make_float4(x, y, z, acc);
    } else {
      for (int c = 0; c < C; ++c) {
        const float v = X[(size_t)i * C + c];
        sm[(size_t)c * N + i] = v;
        const float sq = __fmul_rn(v, v);
        acc = c == 0 ? sq : __fadd_rn(acc, sq);
      }
      sm[(size_t)C * N + i] = acc;
    }
  }
}

// d2 of the query (qx, qy, qz, q2) to a staged C = 3 point.
__device__ __forceinline__ float dist3(float qx, float qy, float qz, float q2,
                                       float4 x) {
  const float cross = __fadd_rn(__fadd_rn(__fmul_rn(qx, x.x), __fmul_rn(qy, x.y)),
                                __fmul_rn(qz, x.z));
  return __fsub_rn(__fadd_rn(q2, x.w), __fmul_rn(2.0f, cross));
}

template <int L>
__global__ void __launch_bounds__(kThreadQueries)
knn_thread_kernel(const float* __restrict__ xyz, const float* __restrict__ query,
                  int N, int M, int K, int* __restrict__ idx) {
  extern __shared__ float4 pts[];
  const int b = blockIdx.y;
  stage_support<true>(xyz + (size_t)b * N * 3, N, 3,
                      reinterpret_cast<float*>(pts));
  __syncthreads();
  const int m = blockIdx.x * kThreadQueries + threadIdx.x;
  if (m >= M) return;
  const float* Q = query + ((size_t)b * M + m) * 3;
  const float qx = Q[0], qy = Q[1], qz = Q[2];
  const float q2 = __fadd_rn(__fadd_rn(__fmul_rn(qx, qx), __fmul_rn(qy, qy)),
                             __fmul_rn(qz, qz));
  float ld[L];
  int li[L];
#pragma unroll
  for (int t = 0; t < L; ++t) {
    ld[t] = INFINITY;
    li[t] = INT_MAX;
  }
  for (int j = 0; j < N; ++j) insert<L>(ld, li, dist3(qx, qy, qz, q2, pts[j]), j);
  int* out = idx + ((size_t)b * M + m) * K;
  const int first = li[0] == INT_MAX ? 0 : li[0];
#pragma unroll
  for (int t = 0; t < L; ++t)
    if (t < K) out[t] = li[t] == INT_MAX ? first : li[t];
  for (int t = L; t < K; ++t) out[t] = first;
}

template <int L, bool kC3>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
knn_warp_kernel(const float* __restrict__ xyz, const float* __restrict__ query,
                int N, int M, int C, int K, int* __restrict__ idx) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const int b = blockIdx.y;
  stage_support<kC3>(xyz + (size_t)b * N * C, N, C, sm);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (m >= M) return;  // whole warps
  const float* Q = query + ((size_t)b * M + m) * C;
  float q2 = 0.0f, qx = 0.0f, qy = 0.0f, qz = 0.0f;
  if (kC3) {
    qx = Q[0];
    qy = Q[1];
    qz = Q[2];
    q2 = __fadd_rn(__fadd_rn(__fmul_rn(qx, qx), __fmul_rn(qy, qy)),
                   __fmul_rn(qz, qz));
  } else {
    for (int c = 0; c < C; ++c) {
      const float sq = __fmul_rn(Q[c], Q[c]);
      q2 = c == 0 ? sq : __fadd_rn(q2, sq);
    }
  }
  float ld[L];
  int li[L];
#pragma unroll
  for (int t = 0; t < L; ++t) {
    ld[t] = INFINITY;
    li[t] = INT_MAX;
  }
  for (int j = lane; j < N; j += 32) {  // increasing j within a lane
    float d;
    if (kC3) {
      d = dist3(qx, qy, qz, q2, sm4[j]);
    } else {
      float cross = 0.0f;
      for (int c = 0; c < C; ++c) {
        const float pr = __fmul_rn(Q[c], sm[(size_t)c * N + j]);
        cross = c == 0 ? pr : __fadd_rn(cross, pr);
      }
      d = __fsub_rn(__fadd_rn(q2, sm[(size_t)C * N + j]),
                    __fmul_rn(2.0f, cross));
    }
    insert<L>(ld, li, d, j);
  }
  // k_eff rounds of a warp argmin over the lists' heads; lane p keeps the
  // p-th winner
  const int k_eff = K < N ? K : N;
  int mine = INT_MAX, first = INT_MAX;
  for (int p = 0; p < k_eff; ++p) {
    const unsigned key = li[0] == INT_MAX ? kFull : ordered(ld[0]);
    const unsigned kmin = __reduce_min_sync(kFull, key);
    const unsigned jmin = __reduce_min_sync(
        kFull, key == kmin ? (unsigned)li[0] : kFull);
    if (kmin == kFull) break;  // no candidate left (NaN or inf distances)
    if (p == 0) first = (int)jmin;
    if (lane == p) mine = (int)jmin;
    if ((unsigned)li[0] == jmin) {  // the winner pops its head
#pragma unroll
      for (int t = 0; t < L - 1; ++t) {
        ld[t] = ld[t + 1];
        li[t] = li[t + 1];
      }
      ld[L - 1] = INFINITY;
      li[L - 1] = INT_MAX;
    }
  }
  if (first == INT_MAX) first = 0;
  if (lane < K) idx[((size_t)b * M + m) * K + lane] =
      mine == INT_MAX ? first : mine;
}

// A warp a query over a support streamed in tiles of T points (see the
// note at the top). Every thread of the block takes part in the staging, so
// a warp past M keeps going without scanning.
template <int L>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
knn_tiled_kernel(const float* __restrict__ xyz, const float* __restrict__ query,
                 int N, int M, int C, int K, int T, int* __restrict__ idx) {
  extern __shared__ float4 sm4[];
  float* tile = reinterpret_cast<float*>(sm4);  // C + 1 planes of T + 1
  const int P = T + 1;
  float* q = tile + (size_t)(C + 1) * P + (threadIdx.x >> 5) * C;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const bool live = m < M;
  if (live) {
    const float* Q = query + ((size_t)b * M + m) * C;
    for (int c = lane; c < C; c += 32) q[c] = Q[c];
  }
  __syncwarp();
  float q2 = 0.0f;
  if (live) {
    for (int c = 0; c < C; ++c) {
      const float sq = __fmul_rn(q[c], q[c]);
      q2 = c == 0 ? sq : __fadd_rn(q2, sq);
    }
  }
  float ld[L];
  int li[L];
#pragma unroll
  for (int t = 0; t < L; ++t) {
    ld[t] = INFINITY;
    li[t] = INT_MAX;
  }
  const float* X = xyz + (size_t)b * N * C;
  for (int base = 0; base < N; base += T) {
    const int n = N - base < T ? N - base : T;
    __syncthreads();  // the previous tile is scanned
    // coalesced: consecutive threads take consecutive floats of the tile's
    // rows; plane c of point i at c * P + i
    const float* src = X + (size_t)base * C;
    for (int e = threadIdx.x; e < n * C; e += blockDim.x) {
      const int i = e / C, c = e - i * C;
      tile[(size_t)c * P + i] = src[e];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      float acc = 0.0f;
      for (int c = 0; c < C; ++c) {
        const float v = tile[(size_t)c * P + i];
        const float sq = __fmul_rn(v, v);
        acc = c == 0 ? sq : __fadd_rn(acc, sq);
      }
      tile[(size_t)C * P + i] = acc;
    }
    __syncthreads();
    if (!live) continue;
    for (int i = lane; i < n; i += 32) {  // increasing index within a lane
      float cross = 0.0f;
      for (int c = 0; c < C; ++c) {
        const float pr = __fmul_rn(q[c], tile[(size_t)c * P + i]);
        cross = c == 0 ? pr : __fadd_rn(cross, pr);
      }
      const float d = __fsub_rn(__fadd_rn(q2, tile[(size_t)C * P + i]),
                                __fmul_rn(2.0f, cross));
      insert<L>(ld, li, d, base + i);
    }
  }
  if (!live) return;
  // k_eff rounds of a warp argmin over the lists' heads, as knn_warp_kernel
  const int k_eff = K < N ? K : N;
  int mine = INT_MAX, first = INT_MAX;
  for (int p = 0; p < k_eff; ++p) {
    const unsigned key = li[0] == INT_MAX ? kFull : ordered(ld[0]);
    const unsigned kmin = __reduce_min_sync(kFull, key);
    const unsigned jmin = __reduce_min_sync(
        kFull, key == kmin ? (unsigned)li[0] : kFull);
    if (kmin == kFull) break;
    if (p == 0) first = (int)jmin;
    if (lane == p) mine = (int)jmin;
    if ((unsigned)li[0] == jmin) {
#pragma unroll
      for (int t = 0; t < L - 1; ++t) {
        ld[t] = ld[t + 1];
        li[t] = li[t + 1];
      }
      ld[L - 1] = INFINITY;
      li[L - 1] = INT_MAX;
    }
  }
  if (first == INT_MAX) first = 0;
  if (lane < K) idx[((size_t)b * M + m) * K + lane] =
      mine == INT_MAX ? first : mine;
}

template <int L>
cudaError_t launch_thread(const float* xyz, const float* query, int B, int N,
                          int M, int K, int* idx, cudaStream_t stream) {
  const size_t smem = (size_t)N * 16;
  cudaError_t e = cudaFuncSetAttribute(
      knn_thread_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((M + kThreadQueries - 1) / kThreadQueries, B);
  knn_thread_kernel<L><<<grid, kThreadQueries, smem, stream>>>(xyz, query, N,
                                                               M, K, idx);
  return cudaGetLastError();
}

template <int L, bool kC3>
cudaError_t launch_warp(const float* xyz, const float* query, int B, int N,
                        int M, int C, int K, int* idx, cudaStream_t stream) {
  const size_t smem = (size_t)N * (C + 1) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      knn_warp_kernel<L, kC3>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((M + kWarpsPerBlock - 1) / kWarpsPerBlock, B);
  knn_warp_kernel<L, kC3><<<grid, kWarpsPerBlock * 32, smem, stream>>>(
      xyz, query, N, M, C, K, idx);
  return cudaGetLastError();
}

template <bool kC3>
cudaError_t launch_warp_l(const float* xyz, const float* query, int B, int N,
                          int M, int C, int K, int L, int* idx,
                          cudaStream_t stream) {
  switch (L) {
    case 1: return launch_warp<1, kC3>(xyz, query, B, N, M, C, K, idx, stream);
    case 2: return launch_warp<2, kC3>(xyz, query, B, N, M, C, K, idx, stream);
    case 4: return launch_warp<4, kC3>(xyz, query, B, N, M, C, K, idx, stream);
    case 8: return launch_warp<8, kC3>(xyz, query, B, N, M, C, K, idx, stream);
    case 16:
      return launch_warp<16, kC3>(xyz, query, B, N, M, C, K, idx, stream);
    case 32:
      return launch_warp<32, kC3>(xyz, query, B, N, M, C, K, idx, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int L>
cudaError_t launch_tiled(const float* xyz, const float* query, int B, int N,
                         int M, int C, int K, int T, int* idx,
                         cudaStream_t stream) {
  const size_t smem = tiled_smem(T, C);
  cudaError_t e = cudaFuncSetAttribute(
      knn_tiled_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((M + kWarpsPerBlock - 1) / kWarpsPerBlock, B);
  knn_tiled_kernel<L><<<grid, kWarpsPerBlock * 32, smem, stream>>>(
      xyz, query, N, M, C, K, T, idx);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest N the kernel takes at C channels (shared-memory planes).
int knn_max_points(int C) {
  return (int)(kMaxSmem / ((size_t)(C + 1) * sizeof(float)));
}

// Points a tile of the tiled instance at C channels: the largest of 256,
// 128, 64, 32 whose block leaves room for two blocks an SM, else 32 where
// one block fits; 0 past knn_tiled_max_channels().
int knn_tile_points(int C) {
  if (C <= 0) return 0;
  for (int T = 256; T >= 32; T >>= 1)
    if (tiled_smem(T, C) <= kTwoBlocksSmem) return T;
  return tiled_smem(32, C) <= kMaxSmem ? 32 : 0;
}

// Widest C the tiled instance takes.
int knn_tiled_max_channels() {
  int C = 1;
  while (tiled_smem(32, C + 1) <= kMaxSmem) ++C;
  return C;
}

// The tiled instance: xyz (B,N,C), query (B,M,C) f32, contiguous -> idx
// (B,M,K) i32, T = knn_tile_points(C), L = 1, 2, 4, 8, 16 or 32 >=
// min(K, ceil(N / 32)). Any N >= 1. Returns cudaError_t.
int knn_tiled_launch(const float* xyz, const float* query, int B, int N,
                     int M, int C, int K, int T, int L, int* idx,
                     cudaStream_t stream) {
  if (B <= 0 || N <= 0 || M <= 0 || C <= 0 || K <= 0 || K > 32 ||
      B > 65535 || T != knn_tile_points(C) || T == 0 ||
      L < (K < (N + 31) / 32 ? K : (N + 31) / 32))
    return cudaErrorInvalidValue;
  switch (L) {
    case 1: return launch_tiled<1>(xyz, query, B, N, M, C, K, T, idx, stream);
    case 2: return launch_tiled<2>(xyz, query, B, N, M, C, K, T, idx, stream);
    case 4: return launch_tiled<4>(xyz, query, B, N, M, C, K, T, idx, stream);
    case 8: return launch_tiled<8>(xyz, query, B, N, M, C, K, T, idx, stream);
    case 16:
      return launch_tiled<16>(xyz, query, B, N, M, C, K, T, idx, stream);
    case 32:
      return launch_tiled<32>(xyz, query, B, N, M, C, K, T, idx, stream);
    default: return cudaErrorInvalidValue;
  }
}

// xyz (B,N,C) f32 support, query (B,M,C) f32, contiguous -> idx (B,M,K) i32.
// variant 0: a thread a query (C = 3, L = 1, 2, 3, 4 or 8 >= K); variant 1:
// a warp a query (L = 1, 2, 4, 8, 16 or 32, L >= min(K, ceil(N / 32))).
// Returns cudaError_t.
int knn_launch(const float* xyz, const float* query, int B, int N, int M,
               int C, int K, int variant, int L, int* idx,
               cudaStream_t stream) {
  if (B <= 0 || N <= 0 || M <= 0 || C <= 0 || K <= 0 || K > 32 ||
      B > 65535 || N > knn_max_points(C))
    return cudaErrorInvalidValue;
  if (variant == 0) {
    if (C != 3 || L < K) return cudaErrorInvalidValue;
    switch (L) {
      case 1: return launch_thread<1>(xyz, query, B, N, M, K, idx, stream);
      case 2: return launch_thread<2>(xyz, query, B, N, M, K, idx, stream);
      case 3: return launch_thread<3>(xyz, query, B, N, M, K, idx, stream);
      case 4: return launch_thread<4>(xyz, query, B, N, M, K, idx, stream);
      case 8: return launch_thread<8>(xyz, query, B, N, M, K, idx, stream);
      default: return cudaErrorInvalidValue;
    }
  }
  if (variant != 1 || L < (K < (N + 31) / 32 ? K : (N + 31) / 32))
    return cudaErrorInvalidValue;
  return C == 3 ? launch_warp_l<true>(xyz, query, B, N, M, C, K, L, idx, stream)
                : launch_warp_l<false>(xyz, query, B, N, M, C, K, L, idx,
                                       stream);
}

const char* apt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
