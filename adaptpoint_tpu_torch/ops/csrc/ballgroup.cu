// Ball-group forward for Hopper (sm_90a): center gather + ball query +
// [dp || fj] grouping.
//
// Replaces the TPU kernel adaptpoint_tpu/ops/pallas/ballgroup.py
// (_ball_group_call / _fwd_kernel, the forward of ball_group_pallas). Same
// function as the plain version ops/ballgroup.py ball_group_plain:
//   new_xyz = xyz[qidx]; fi = feats[qidx]
//   idx     = the first K support points with d2 < f32(r)^2, in index order;
//             empty slots repeat the first one, an empty ball gives index 0
//   dpfj    = [dp || fj] in the (B, K, M, 3+C) layout of the JAX package,
//             dp = (x_j - q) * f32(1/r) when normalize_dp (the TPU kernel's
//             multiply), fj = feats[j]; every value gathered exactly in f32.
//
// Design: one warp per query center. The warp scans the support points in
// index order, 32 at a time: __ballot_sync gives the in-ball mask, __popc of
// the lanes below gives each point's rank, and the scan stops once K are
// found. The K indices sit in shared memory; the warp then writes each
// neighbour's [dp || fj] row with its lanes over the channels, so reads and
// writes are coalesced over C.
//
// What bounds it: bytes. The (B, K, M, 3+C) output is the largest array it
// touches (73 MB at stage 1 of PointNeXt-S at B=32 against 4.2 MB of
// feature input); the distance work stops at the K-th neighbour. The design
// writes every output byte once and reads features from L2.
//
// Arithmetic: d2 = (dx*dx + dy*dy) + dz*dz rounded step by step
// (__fmul_rn/__fadd_rn, -fmad=false), so the strict boundary test and the
// indices equal the plain version's bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;

__global__ void __launch_bounds__(kWarps * 32)
ball_group_kernel(const float* __restrict__ xyz, const int* __restrict__ qidx,
                  const float* __restrict__ feats, int B, int N, int M, int C,
                  int K, float r2, float dp_scale, int relative,
                  float* __restrict__ new_xyz, float* __restrict__ fi,
                  float* __restrict__ dpfj, int* __restrict__ idx_out) {
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
  for (int c = lane; c < C; c += 32) fi[bm * C + c] = F[(size_t)q * C + c];

  const int W = C + 3;
  for (int k = 0; k < K; ++k) {
    const int j = nbr[k];
    float* row = dpfj + (((size_t)b * K + k) * M + m) * W;
    for (int c = lane; c < W; c += 32) {
      float v;
      if (c < 3) {
        v = X[3 * j + c];
        if (relative) {
          const float qc = c == 0 ? qx : (c == 1 ? qy : qz);
          v = __fmul_rn(__fsub_rn(v, qc), dp_scale);
        }
      } else {
        v = F[(size_t)j * C + (c - 3)];
      }
      row[c] = v;
    }
  }
}

}  // namespace

extern "C" {

// xyz (B,N,3) f32, qidx (B,M) i32, feats (B,N,C) f32, all contiguous ->
// new_xyz (B,M,3), fi (B,M,C), dpfj (B,K,M,3+C) f32, idx (B,M,K) i32.
// r2 = f32(r)*f32(r); dp_scale = f32(1/r) or 1. Returns cudaError_t.
int ball_group_launch(const float* xyz, const int* qidx, const float* feats,
                      int B, int N, int M, int C, int K, float r2,
                      float dp_scale, int relative, float* new_xyz, float* fi,
                      float* dpfj, int* idx, cudaStream_t stream) {
  if (B <= 0 || N <= 0 || M <= 0 || C < 0 || K <= 0)
    return cudaErrorInvalidValue;
  const size_t smem = (size_t)kWarps * K * sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(
      ball_group_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const long long warps = (long long)B * M;
  const int blocks = (int)((warps + kWarps - 1) / kWarps);
  ball_group_kernel<<<blocks, kWarps * 32, smem, stream>>>(
      xyz, qidx, feats, B, N, M, C, K, r2, dp_scale, relative, new_xyz, fi,
      dpfj, idx);
  return cudaGetLastError();
}

const char* apt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
