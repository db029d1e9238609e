// Max-pooled ball group for Hopper (sm_90a): ball query + per-channel max
// and min over the K neighbours, forward and backward.
//
// Replaces the TPU kernels adaptpoint_tpu/ops/pallas/ballgroup.py
// _bg_max_call (_fwd_max_kernel) and _bg_max_bwd (_bwd_max_kernel), the two
// halves of ball_group_maxpool_pallas at splits = grad_splits = 1. Same
// function as the plain versions in ops/ballgroup_max.py:
//   new_xyz = xyz[qidx] (exact); fi = bf16(feats[qidx]) held in f32
//   idx     = the ball-group kernel's selection: first K support points with
//             d2 < f32(r)^2 in index order, empty slots repeat the first,
//             an empty ball gives index 0
//   fmax, fmin = max and min over the K slots of bf16(feats[idx]);
//   amax, amin = the first slot that holds them (strict > / < in slot order)
// Backward, per (center, channel):
//   slot amax gets bf16(g_fmax + [amin == amax] g_fmin), slot amin (when it
//   differs) bf16(g_fmin): the sum is taken before its one rounding, as the
//   TPU kernel's one-hot matmul of the rounded per-slot cotangent does;
//   g_fi and g_new go to the center's row unrounded; xyz gets only g_new.
//
// Design: one warp per query center. The ball query is the ball-group
// kernel's (__ballot_sync in-ball masks, __popc ranks, stop at the K-th);
// the K indices sit in shared memory and also go to idx_out, which the
// backward reads instead of scanning again. The warp's lanes then own the
// channels c = lane, lane + 32, ...: for one channel a lane walks the
// found slots in order, reading bf16(f[j, c]) (coalesced over c), and keeps
// the running max / min and their slots in registers. Pad slots repeat slot
// 0's value and can never win a strict comparison, so the walk stops at the
// last found slot (one slot for an empty ball). Nothing K-deep is written.
// The backward gives a warp a center again: each lane rounds its channels'
// one or two cotangents and scatters them with atomicAdd onto the winning
// neighbour rows, then adds g_fi and g_new onto the center's row.
//
// What bounds it: bytes. The forward reads feats (32 x N x C f32, 33.6 MB
// at each grouper of the augmentor at B=32) and writes three (B, M, C) f32
// and two (B, M, C) u8 tensors; the slot reads repeat rows out of L2. The
// backward reads the four (B, M, C) cotangents and slots and writes
// (B, N, C) once; atomics on rows many centers share cost beyond that.
//
// Arithmetic: d2 rounds step by step (__fmul_rn/__fadd_rn, -fmad=false) so
// the selection equals the plain version's; values are compared after the
// same bf16 rounding, so forward outputs and slots are exact. The backward's
// atomic adds land in no fixed order (the usual f32 reordering error).
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kWarps = 8;

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__global__ void __launch_bounds__(kWarps * 32)
ball_group_max_kernel(const float* __restrict__ xyz,
                      const int* __restrict__ qidx,
                      const float* __restrict__ feats, int B, int N, int M,
                      int C, int K, float r2, float* __restrict__ new_xyz,
                      float* __restrict__ fi, float* __restrict__ fmax,
                      float* __restrict__ fmin, unsigned char* __restrict__ amax,
                      unsigned char* __restrict__ amin,
                      int* __restrict__ idx_out) {
  extern __shared__ int snbr[];  // kWarps x K neighbour indices
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long g = (long long)blockIdx.x * kWarps + warp;
  if (g >= (long long)B * M) return;  // whole warp; the block never syncs
  const int b = (int)(g / M);
  const int m = (int)(g % M);
  int* nbr = snbr + warp * K;
  const float* X = xyz + (size_t)b * N * 3;
  const float* F = feats + (size_t)b * N * C;
  const int q = qidx[(size_t)b * M + m];
  const float qx = X[3 * q], qy = X[3 * q + 1], qz = X[3 * q + 2];

  int cnt = 0;
  for (int base = 0; base < N && cnt < K; base += 32) {
    const int j = base + lane;
    bool in = false;
    if (j < N) {
      const float dx = __fsub_rn(qx, X[3 * j]);
      const float dy = __fsub_rn(qy, X[3 * j + 1]);
      const float dz = __fsub_rn(qz, X[3 * j + 2]);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      in = d2 < r2;
    }
    const unsigned mask = __ballot_sync(0xffffffffu, in);
    const int rank = cnt + __popc(mask & ((1u << lane) - 1u));
    if (in && rank < K) nbr[rank] = j;
    cnt += __popc(mask);
  }
  __syncwarp();
  const int found = cnt < K ? cnt : K;
  const int first = found > 0 ? nbr[0] : 0;
  for (int k = found + lane; k < K; k += 32) nbr[k] = first;
  __syncwarp();

  const size_t bm = (size_t)b * M + m;
  for (int k = lane; k < K; k += 32) idx_out[bm * K + k] = nbr[k];
  if (lane < 3) new_xyz[bm * 3 + lane] = X[3 * q + lane];
  const int walk = found > 0 ? found : 1;  // pad slots never win
  for (int c = lane; c < C; c += 32) {
    fi[bm * C + c] = bf16r(F[(size_t)q * C + c]);
    float vmax = __int_as_float((int)0xff800000u);  // -inf
    float vmin = __int_as_float((int)0x7f800000u);  // +inf
    int kmax = 0, kmin = 0;
    for (int k = 0; k < walk; ++k) {
      const float v = bf16r(F[(size_t)nbr[k] * C + c]);
      if (v > vmax) { vmax = v; kmax = k; }
      if (v < vmin) { vmin = v; kmin = k; }
    }
    fmax[bm * C + c] = vmax;
    fmin[bm * C + c] = vmin;
    amax[bm * C + c] = (unsigned char)kmax;
    amin[bm * C + c] = (unsigned char)kmin;
  }
}

__global__ void __launch_bounds__(kWarps * 32)
ball_group_max_bwd_kernel(const int* __restrict__ idx,
                          const int* __restrict__ qidx,
                          const float* __restrict__ g_new,
                          const float* __restrict__ g_fi,
                          const float* __restrict__ g_fmax,
                          const float* __restrict__ g_fmin,
                          const unsigned char* __restrict__ amax,
                          const unsigned char* __restrict__ amin, int B, int N,
                          int M, int C, int K, float* __restrict__ g_xyz,
                          float* __restrict__ g_feats) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long g = (long long)blockIdx.x * kWarps + warp;
  if (g >= (long long)B * M) return;
  const int b = (int)(g / M);
  const size_t bm = (size_t)g;
  const int q = qidx[bm];
  const int* nbr = idx + bm * K;
  if (g_feats) {
    float* GF = g_feats + (size_t)b * N * C;
    for (int c = lane; c < C; c += 32) {
      const size_t e = bm * C + c;
      const float ga = g_fmax ? g_fmax[e] : 0.0f;
      const float gi = g_fmin ? g_fmin[e] : 0.0f;
      const int ka = amax[e], ki = amin[e];
      if (ka == ki) {
        const float v = bf16r(__fadd_rn(ga, gi));
        if (v != 0.0f) atomicAdd(GF + (size_t)nbr[ka] * C + c, v);
      } else {
        const float va = bf16r(ga), vi = bf16r(gi);
        if (va != 0.0f) atomicAdd(GF + (size_t)nbr[ka] * C + c, va);
        if (vi != 0.0f) atomicAdd(GF + (size_t)nbr[ki] * C + c, vi);
      }
      if (g_fi) atomicAdd(GF + (size_t)q * C + c, g_fi[e]);
    }
  }
  if (g_xyz && g_new && lane < 3)
    atomicAdd(g_xyz + ((size_t)b * N + q) * 3 + lane, g_new[bm * 3 + lane]);
}

}  // namespace

extern "C" {

// xyz (B,N,3) f32, qidx (B,M) i32, feats (B,N,C) f32, all contiguous ->
// new_xyz (B,M,3), fi, fmax, fmin (B,M,C) f32, amax, amin (B,M,C) u8,
// idx (B,M,K) i32. r2 = f32(r)*f32(r); K <= 255. Returns cudaError_t.
int ball_group_max_launch(const float* xyz, const int* qidx,
                          const float* feats, int B, int N, int M, int C,
                          int K, float r2, float* new_xyz, float* fi,
                          float* fmax, float* fmin, unsigned char* amax,
                          unsigned char* amin, int* idx, cudaStream_t stream) {
  if (B <= 0 || N <= 0 || M <= 0 || C <= 0 || K <= 0 || K > 255)
    return cudaErrorInvalidValue;
  const size_t smem = (size_t)kWarps * K * sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(
      ball_group_max_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const long long warps = (long long)B * M;
  const int blocks = (int)((warps + kWarps - 1) / kWarps);
  ball_group_max_kernel<<<blocks, kWarps * 32, smem, stream>>>(
      xyz, qidx, feats, B, N, M, C, K, r2, new_xyz, fi, fmax, fmin, amax,
      amin, idx);
  return cudaGetLastError();
}

// idx (B,M,K) i32 and qidx (B,M) i32 of the forward; cotangents g_new
// (B,M,3), g_fi, g_fmax, g_fmin (B,M,C) f32 contiguous or null (zero);
// amax, amin (B,M,C) u8 -> g_xyz (B,N,3), g_feats (B,N,C) f32, either
// null to skip it; both are zeroed here on the stream. Returns cudaError_t.
int ball_group_max_bwd_launch(const int* idx, const int* qidx,
                              const float* g_new, const float* g_fi,
                              const float* g_fmax, const float* g_fmin,
                              const unsigned char* amax,
                              const unsigned char* amin, int B, int N, int M,
                              int C, int K, float* g_xyz, float* g_feats,
                              cudaStream_t stream) {
  if (B <= 0 || N <= 0 || M <= 0 || C <= 0 || K <= 0 || K > 255)
    return cudaErrorInvalidValue;
  cudaError_t e;
  if (g_xyz) {
    e = cudaMemsetAsync(g_xyz, 0, (size_t)B * N * 3 * sizeof(float), stream);
    if (e != cudaSuccess) return e;
  }
  if (g_feats) {
    e = cudaMemsetAsync(g_feats, 0, (size_t)B * N * C * sizeof(float), stream);
    if (e != cudaSuccess) return e;
  }
  const long long warps = (long long)B * M;
  const int blocks = (int)((warps + kWarps - 1) / kWarps);
  ball_group_max_bwd_kernel<<<blocks, kWarps * 32, 0, stream>>>(
      idx, qidx, g_new, g_fi, g_fmax, g_fmin, amax, amin, B, N, M, C, K,
      g_xyz, g_feats);
  return cudaGetLastError();
}

const char* apt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
