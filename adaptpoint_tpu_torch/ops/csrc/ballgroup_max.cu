// Max-pooled ball group for Hopper (sm_90a): ball query + per-channel max
// and min over the K neighbours, forward and backward, for f32 and bf16
// features.
//
// Replaces the TPU kernels adaptpoint_tpu/ops/pallas/ballgroup.py
// _bg_max_call (_fwd_max_kernel) and _bg_max_bwd (_bwd_max_kernel), the two
// halves of ball_group_maxpool_pallas at splits = grad_splits = 1. Same
// function as the plain versions in ops/ballgroup_max.py:
//   new_xyz = xyz[qidx] (exact); fi = bf16(feats[qidx])
//   idx     = the ball-group kernel's selection (ball_query.cuh): first K
//             points with d2 < f32(r)^2 in index order, empty slots repeat
//             the first, an empty ball gives index 0
//   fmax, fmin = max and min over the K slots of bf16(feats[idx]);
//   amax, amin = the first slot that holds them (strict > / < in slot order)
// Backward, per (center, channel):
//   slot amax gets bf16(g_fmax + [amin == amax] g_fmin), slot amin (when it
//   differs) bf16(g_fmin): the sum is taken before its one rounding, as the
//   TPU kernel's one-hot matmul of the rounded per-slot cotangent does;
//   g_fi and g_new go to the center's row unrounded; xyz gets only g_new.
// The bf16 instances read the bf16 policy's features and cotangents and
// write fi, fmax, fmin and g_feats in bf16: the values the f32 kernels give
// with the features cast up and the results cast down (every bf16 is exact
// in f32; g_feats is summed in f32 and rounded once), so the op needs no
// cast around it.
//
// What bounds it: bytes. The forward reads feats once and writes three
// (B, M, C) values and two (B, M, C) u8 slot tensors; the backward reads the
// three cotangents and the slots and writes (B, N, C) once. At the GAN
// step's four groupers (B = 32, K = 24) that is 0.37 GB each way in f32,
// 0.21 GB in bf16. The re-reads of neighbour rows hit L2.
//
// Forward design: a block of 8 warps owns a tile of TM centers of one cloud
// and stages the cloud's points in shared memory where they fit
// (ball_query.cuh stage_points; global reads otherwise). 1. One warp a
// center runs ball_scan (the fused SA forward's: 128 points an iteration)
// into the tile's slot table. 2. The block's threads take (center, 16
// bytes of channels) pieces: 4 f32 or 8 bf16 channels a thread, neighbouring
// threads on neighbouring channels; each walks the found slots four at a
// time, the four 16-byte row loads issued before their compares, which run
// in slot order (pad slots repeat slot 0's value and never win a strict
// comparison, so the walk stops at the last found slot). fi, fmax, fmin are
// 16-byte stores, the slots 4 or 8 bytes. Channels that are not a multiple
// of the vector (or a misaligned pointer) take the one-channel instance.
// The walk and the vectors live in bgmax_walk.cuh, shared with window.cu.
//
// Backward design: a block owns one cloud, a slice of S channels (a power of
// two) and R rows of it (all N where they fit) and accumulates that slice of
// g_feats in shared memory (R x S f32, rows padded to S + 1 floats against
// bank conflicts). A block has 16 warps (twice the forward's: more loads in
// flight an SM). A thread owns one channel of the slice; a group of S
// threads takes one center at a time, so the threads of a warp add to
// distinct addresses of at most 32 / S centers (centers whose balls overlap
// share winners: many threads of one channel on one row would retry their
// atomics in turn). Each thread loads the cotangents and slots of four
// centers, then their neighbour rows, then adds the rounded slot cotangents
// and g_fi with shared-memory atomics; after a barrier the block writes
// each g_feats element of the slice once (bf16 rounded once in the bf16
// instance). No memset, no global atomics. One more slice of blocks writes
// g_xyz whole: zeros plus g_new at the center rows, summed in shared
// memory. Every slice re-reads idx and qidx (B M K 4 bytes x C / S, from
// L2); ops/ballgroup_max.py bwd_tiling takes the widest slice whose N rows
// still fit two blocks an SM. The order of the shared atomics is not fixed
// (the usual f32 reordering).
//
// Arithmetic: d2 rounds step by step (-fmad=false) so the selection equals
// the plain version's; values are compared after the same bf16 rounding, so
// forward outputs and slots are exact.
#include "ball_query.cuh"
#include "bgmax_walk.cuh"

#include <cuda_bf16.h>

namespace {

using apt_bgm::bf16;
using apt_bgm::bf16r;
using apt_bgm::max_min_walk;
using apt_bgm::store;
using apt_bgm::store_slots;
using apt_bgm::Vec;
using apt_bq::ball_scan;
using apt_bq::stage_points;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr size_t kSmemLimit = 232448;  // bytes a block may use on sm_90

__host__ __device__ inline size_t a128(size_t x) {
  return (x + 127) / 128 * 128;
}

// ------------------------------------------------------------- forward

struct FwdLayout {
  size_t nb, cen, xs, total;
};

// Shared memory of a forward block: the tile's slot table (TM x K indices),
// each center's index and walk, and the cloud's N points when staged.
__host__ __device__ inline FwdLayout fwd_layout(int TM, int K, int N,
                                                int use_xs) {
  FwdLayout L;
  size_t o = 0;
  L.nb = o;
  o += a128((size_t)TM * K * 4);
  L.cen = o;
  o += a128((size_t)TM * 8);
  L.xs = o;
  if (use_xs) o += a128((size_t)N * 16);
  L.total = o;
  return L;
}

template <typename T>
struct FwdParams {
  const float* xyz;
  const int* qidx;
  const T* feats;
  int N, M, C, K, TM, use_xs;
  float r2;
  float* new_xyz;
  T* fi;
  T* fmax;
  T* fmin;
  unsigned char* amax;
  unsigned char* amin;
  int* idx_out;
};

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
ball_group_max_kernel(FwdParams<T> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const FwdLayout L = fwd_layout(p.TM, p.K, p.N, p.use_xs);
  int* nb = reinterpret_cast<int*>(smem + L.nb);
  int* cen = reinterpret_cast<int*>(smem + L.cen);  // (q, walk) a center
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int K = p.K, C = p.C;
  const int m0 = blockIdx.x * p.TM;
  const int tmv = min(p.TM, p.M - m0);
  const float* Xg = p.xyz + (size_t)b * p.N * 3;
  const T* F = p.feats + (size_t)b * p.N * C;

  float4* xs = nullptr;
  if (p.use_xs) {
    xs = reinterpret_cast<float4*>(smem + L.xs);
    stage_points(xs, Xg, p.N, tid, kThreads);
    __syncthreads();
  }
  auto staged = [&](int j) {
    const float4 v = xs[j];
    return make_float3(v.x, v.y, v.z);
  };
  auto global = [&](int j) {
    return make_float3(Xg[3 * j], Xg[3 * j + 1], Xg[3 * j + 2]);
  };

  // 1. ball query, one warp a center
  for (int c = warp; c < tmv; c += kWarps) {
    const size_t bm = (size_t)b * p.M + m0 + c;
    const int qi = p.qidx[bm];
    const float3 qc = xs ? staged(qi) : global(qi);
    int* nbc = nb + c * K;
    const int cnt = xs ? ball_scan(staged, qc, p.r2, p.N, K, nbc, lane)
                       : ball_scan(global, qc, p.r2, p.N, K, nbc, lane);
    __syncwarp();
    const int found = cnt < K ? cnt : K;
    const int first = found > 0 ? nbc[0] : 0;
    for (int k = found + lane; k < K; k += 32) nbc[k] = first;
    __syncwarp();
    for (int k = lane; k < K; k += 32) p.idx_out[bm * K + k] = nbc[k];
    if (lane < 3)
      p.new_xyz[bm * 3 + lane] = lane == 0 ? qc.x : lane == 1 ? qc.y : qc.z;
    if (lane == 0) {
      cen[2 * c] = qi;
      cen[2 * c + 1] = found > 0 ? found : 1;  // pad slots never win
    }
  }
  __syncthreads();

  // 2. the max and min over the found slots, (center, V channels) a piece
  const int P = C / V;
  for (int e = tid; e < tmv * P; e += kThreads) {
    const int c = e / P;
    const int col = (e - c * P) * V;
    const int* nbc = nb + c * K;
    const int qi = cen[2 * c];
    const int walk = cen[2 * c + 1];
    float vmax[V], vmin[V];
    int kmax[V], kmin[V];
    max_min_walk<T, V>(
        F, C, col, nbc, walk,
        [](const Vec<T, V>& v, int i) { return v.val(i); }, vmax, vmin,
        kmax, kmin);
    Vec<T, V> q;
    q.load(F + (size_t)qi * C + col);
    float vq[V];
#pragma unroll
    for (int i = 0; i < V; ++i) vq[i] = q.val(i);
    const size_t o = ((size_t)b * p.M + m0 + c) * C + col;
    store<V>(p.fi + o, vq);
    store<V>(p.fmax + o, vmax);
    store<V>(p.fmin + o, vmin);
    store_slots<V>(p.amax + o, kmax);
    store_slots<V>(p.amin + o, kmin);
  }
}

// ------------------------------------------------------------ backward

// Shared memory of a backward block: R rows of an S-channel slice, a row
// padded to S + 1 floats against bank conflicts (the xyz slice's R x 3 fits
// in it since S >= 4).
__host__ __device__ inline size_t bwd_smem(int S, int R) {
  return a128((size_t)R * (S + 1) * 4);
}

template <typename T>
struct BwdParams {
  const int* idx;
  const int* qidx;
  const float* g_new;
  const T* g_fi;
  const T* g_fmax;
  const T* g_fmin;
  const unsigned char* amax;
  const unsigned char* amin;
  int N, M, C, K, S, R, feat_slices;
  float* g_xyz;
  T* g_feats;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

constexpr int kUnrollB = 4;  // centers a thread loads before its adds
constexpr int kThreadsB = 512;  // threads of a backward block

// A block owns cloud blockIdx.x, rows blockIdx.z * R .. of it and channel
// slice blockIdx.y (S channels; the slice after the last is g_xyz). Its
// threads form groups of S, one thread a channel; a group takes one center
// at a time, so the threads of a warp add to distinct addresses of at most
// 32 / S centers.
template <typename T>
__global__ void __launch_bounds__(kThreadsB)
ball_group_max_bwd_kernel(BwdParams<T> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);
  const int b = blockIdx.x;
  const int slice = blockIdx.y;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.z * p.R;
  const int rows = min(p.R, p.N - n0);
  const int* Q = p.qidx + (size_t)b * p.M;

  if (slice == p.feat_slices) {  // g_xyz: zeros, plus g_new at the centers
    for (int e = tid; e < rows * 3; e += kThreadsB) acc[e] = 0.0f;
    __syncthreads();
    if (p.g_new)
      for (int e = tid; e < p.M * 3; e += kThreadsB) {
        const int m = e / 3;
        const int r = Q[m] - n0;
        if (r >= 0 && r < rows)
          atomicAdd(acc + 3 * r + e - 3 * m,
                    p.g_new[(size_t)b * p.M * 3 + e]);
      }
    __syncthreads();
    float* G = p.g_xyz + ((size_t)b * p.N + n0) * 3;
    for (int e = tid; e < rows * 3; e += kThreadsB) G[e] = acc[e];
    return;
  }

  const int S = p.S;  // a power of two
  const int sh = __ffs(S) - 1;
  const int ld = S + 1;  // the row stride of acc
  const int c = tid & (S - 1);
  const int groups = kThreadsB >> sh;
  const int col = slice * S + c;  // the thread's channel
  const bool live = col < p.C;
  for (int e = tid; e < rows * ld; e += kThreadsB) acc[e] = 0.0f;
  __syncthreads();

  auto add = [&](int row, float v) {
    const int r = row - n0;
    if (v != 0.0f && r >= 0 && r < rows) atomicAdd(acc + r * ld + c, v);
  };
  const size_t bm0 = (size_t)b * p.M;
  for (int m0 = tid >> sh; m0 < p.M; m0 += kUnrollB * groups) {
    // the loads of kUnrollB centers, then their neighbour rows, then the adds
    float ga[kUnrollB], gn[kUnrollB], gf[kUnrollB];
    int ka[kUnrollB], ki[kUnrollB], q[kUnrollB];
#pragma unroll
    for (int u = 0; u < kUnrollB; ++u) {
      const int m = m0 + u * groups;
      ka[u] = -1;
      if (!live || m >= p.M) continue;
      const size_t o = (bm0 + m) * p.C + col;
      ga[u] = p.g_fmax ? to_f(p.g_fmax[o]) : 0.0f;
      gn[u] = p.g_fmin ? to_f(p.g_fmin[o]) : 0.0f;
      gf[u] = p.g_fi ? to_f(p.g_fi[o]) : 0.0f;
      ka[u] = p.amax[o];
      ki[u] = p.amin[o];
      q[u] = Q[m];
    }
    int ra[kUnrollB] = {}, ri[kUnrollB] = {};
#pragma unroll
    for (int u = 0; u < kUnrollB; ++u) {
      // no row to look up where both slot cotangents are zero
      if (ka[u] < 0 || (ga[u] == 0.0f && gn[u] == 0.0f)) continue;
      const int* nbr = p.idx + (bm0 + m0 + u * groups) * p.K;
      ra[u] = nbr[ka[u]];
      ri[u] = nbr[ki[u]];
    }
#pragma unroll
    for (int u = 0; u < kUnrollB; ++u) {
      if (ka[u] < 0) continue;
      if (ka[u] == ki[u]) {
        add(ra[u], bf16r(__fadd_rn(ga[u], gn[u])));
      } else {
        add(ra[u], bf16r(ga[u]));
        add(ri[u], bf16r(gn[u]));
      }
      add(q[u], gf[u]);
    }
  }
  __syncthreads();

  // each element of the slice once, a row's channels on neighbouring threads
  T* G = p.g_feats + ((size_t)b * p.N + n0) * p.C + slice * S;
  if (live)
    for (int r = tid >> sh; r < rows; r += groups)
      put(G + (size_t)r * p.C + c, acc[r * ld + c]);
}

template <typename T, int V>
int launch_fwd(const FwdParams<T>& p, int B, cudaStream_t stream) {
  const size_t smem = fwd_layout(p.TM, p.K, p.N, p.use_xs).total;
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      ball_group_max_kernel<T, V>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((p.M + p.TM - 1) / p.TM, B);
  ball_group_max_kernel<T, V><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
int launch_bwd(const BwdParams<T>& p, int B, int xyz_slice,
               cudaStream_t stream) {
  const size_t smem = bwd_smem(p.S, p.R);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      ball_group_max_bwd_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid(B, p.feat_slices + xyz_slice, (p.N + p.R - 1) / p.R);
  ball_group_max_bwd_kernel<T><<<grid, kThreadsB, smem, stream>>>(p);
  return cudaGetLastError();
}

bool misaligned(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) != 0;
}

template <typename T>
int fwd(const float* xyz, const int* qidx, const void* feats, int B, int N,
        int M, int C, int K, float r2, int TM, int use_xs, int vec,
        float* new_xyz, void* fi, void* fmax, void* fmin,
        unsigned char* amax, unsigned char* amin, int* idx,
        cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec != 1 && (vec != kVec || C % kVec || misaligned(feats)))
    return cudaErrorInvalidValue;
  FwdParams<T> p{xyz, qidx, static_cast<const T*>(feats), N, M, C, K, TM,
                 use_xs, r2, new_xyz, static_cast<T*>(fi),
                 static_cast<T*>(fmax), static_cast<T*>(fmin), amax, amin,
                 idx};
  return vec == 1 ? launch_fwd<T, 1>(p, B, stream)
                  : launch_fwd<T, kVec>(p, B, stream);
}

template <typename T>
int bwd(const int* idx, const int* qidx, const float* g_new,
        const void* g_fi, const void* g_fmax, const void* g_fmin,
        const unsigned char* amax, const unsigned char* amin, int B, int N,
        int M, int C, int K, int S, int R, float* g_xyz, void* g_feats,
        cudaStream_t stream) {
  if (S < 4 || S > kThreadsB || (S & (S - 1))) return cudaErrorInvalidValue;
  BwdParams<T> p{idx, qidx, g_new, static_cast<const T*>(g_fi),
                 static_cast<const T*>(g_fmax),
                 static_cast<const T*>(g_fmin), amax, amin, N, M, C, K, S,
                 R, g_feats ? (C + S - 1) / S : 0, g_xyz,
                 static_cast<T*>(g_feats)};
  const int xyz_slice = g_xyz ? 1 : 0;
  if (p.feat_slices + xyz_slice == 0) return cudaSuccess;
  return launch_bwd<T>(p, B, xyz_slice, stream);
}

bool bad_shape(int B, int N, int M, int C, int K, int dtype) {
  return B <= 0 || N <= 0 || M <= 0 || C <= 0 || K <= 0 || K > 255 ||
         (dtype != 0 && dtype != 1);
}

}  // namespace

extern "C" {

// Shared memory of one forward block (bytes): TM centers of K slots, and
// the cloud's N points when staged (use_xs).
long long ball_group_max_smem_bytes(int TM, int K, int N, int use_xs) {
  return (long long)fwd_layout(TM, K, N, use_xs).total;
}

// Shared memory of one backward block (bytes): R rows of S channels.
long long ball_group_max_bwd_smem_bytes(int S, int R) {
  return (long long)bwd_smem(S, R);
}

// xyz (B,N,3) f32, qidx (B,M) i32, feats (B,N,C) f32 (dtype 0) or bf16
// (dtype 1), all contiguous -> new_xyz (B,M,3) f32, fi, fmax, fmin (B,M,C)
// of the features' type, amax, amin (B,M,C) u8, idx (B,M,K) i32. r2 =
// f32(r)*f32(r); K <= 255; TM centers a block, use_xs and vec (1, or 16
// bytes of channels: 4 f32, 8 bf16) as ops/ballgroup_max.py fwd_tiling picks
// them. Returns cudaError_t.
int ball_group_max_launch(const float* xyz, const int* qidx,
                          const void* feats, int dtype, int B, int N, int M,
                          int C, int K, float r2, int TM, int use_xs,
                          int vec, float* new_xyz, void* fi, void* fmax,
                          void* fmin, unsigned char* amax,
                          unsigned char* amin, int* idx,
                          cudaStream_t stream) {
  if (bad_shape(B, N, M, C, K, dtype) || TM <= 0 || TM > 1024)
    return cudaErrorInvalidValue;
  return dtype == 0
             ? fwd<float>(xyz, qidx, feats, B, N, M, C, K, r2, TM, use_xs,
                          vec, new_xyz, fi, fmax, fmin, amax, amin, idx,
                          stream)
             : fwd<bf16>(xyz, qidx, feats, B, N, M, C, K, r2, TM, use_xs,
                         vec, new_xyz, fi, fmax, fmin, amax, amin, idx,
                         stream);
}

// idx (B,M,K) i32 and qidx (B,M) i32 of the forward; cotangents g_new
// (B,M,3) f32 and g_fi, g_fmax, g_fmin (B,M,C) of the features' type
// (dtype 0 f32, 1 bf16), contiguous or null (zero); amax, amin (B,M,C) u8
// -> g_xyz (B,N,3) f32 and g_feats (B,N,C) of the features' type, either
// null to skip it, each written whole (no memset needed). S channels (a
// power of two, 4 .. 256) and R rows a block as ops/ballgroup_max.py
// bwd_tiling picks them. Returns cudaError_t.
int ball_group_max_bwd_launch(const int* idx, const int* qidx,
                              const float* g_new, const void* g_fi,
                              const void* g_fmax, const void* g_fmin,
                              const unsigned char* amax,
                              const unsigned char* amin, int dtype, int B,
                              int N, int M, int C, int K, int S, int R,
                              float* g_xyz, void* g_feats,
                              cudaStream_t stream) {
  if (bad_shape(B, N, M, C, K, dtype) || R <= 0)
    return cudaErrorInvalidValue;
  return dtype == 0
             ? bwd<float>(idx, qidx, g_new, g_fi, g_fmax, g_fmin, amax, amin,
                          B, N, M, C, K, S, R, g_xyz, g_feats, stream)
             : bwd<bf16>(idx, qidx, g_new, g_fi, g_fmax, g_fmin, amax, amin,
                         B, N, M, C, K, S, R, g_xyz, g_feats, stream);
}

const char* apt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
