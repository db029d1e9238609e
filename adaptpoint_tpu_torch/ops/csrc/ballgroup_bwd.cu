// Ball-group backward for Hopper (sm_90a): the scatter-add of the grouped
// cotangents back onto the support points.
//
// Replaces the TPU kernel adaptpoint_tpu/ops/pallas/ballgroup.py
// _ball_group_bwd (_bwd_kernel), the VJP of ball_group_pallas. Same function
// as the plain version ops/ballgroup.py ball_group_bwd_plain. With
// s = f32(1/r) when relative and normalize_dp, else 1 (the forward's
// multiply):
//   for each (b, m, k), j = idx[b, m, k]:
//     g_feats[b, j, :] += g_dpfj[b, k, m, 3:]
//     g_xyz[b, j, :]   += g_dpfj[b, k, m, :3] * s
//   for each (b, m), q = qidx[b, m]:
//     g_feats[b, q, :] += g_fi[b, m, :]
//     g_xyz[b, q, :]   += g_new[b, m, :] - [relative] sum_k g_dpfj[b,k,m,:3]*s
// Pad-repeated slots (a partial ball repeats its first index, an empty ball
// index 0) each carry their own cotangent and all are added. Everything is
// exact f32: the TPU kernel's one-hot matmuls over 2 or 3 bf16 splits are
// the TPU's way to scatter and are not carried over; this matches its exact
// (3-split) route.
//
// Design: one warp per query center, as in the forward. The warp keeps the
// center's K neighbour indices in shared memory and gives each lane the
// channels c = lane, lane + 32, ...: for one channel it walks k = 0..K-1,
// reading g_dpfj[b, k, m, c] (a warp reads a whole (3+C)-wide row,
// coalesced), and adds runs of equal neighbour index in a register before
// one atomicAdd per run, so the pad-repeated tail of a partial ball costs
// one atomic and not K - found. Lanes 0..2 also keep the running sum of the
// dp cotangents for the center's term.
//
// What bounds it: bytes -- g_dpfj (B, K, M, 3+C) is read once and is the
// largest array by far (73 MB at stage 1 of PointNeXt-S at B=32). What it
// costs beyond that is atomic contention: many (m, k) hit the same support
// row (stage 4: 2048 slots onto 128 rows of 259 channels).
//
// Determinism: the atomic adds land in no fixed order, so a sum of n addends
// can differ from run to run and from the plain version by the usual f32
// reordering error (about n * eps * sum|addend| at worst). That is accepted
// and the comparison states it; a deterministic variant (one block per tile
// of support rows that scans idx) would read idx N/tile times over and is
// left until a measurement asks for it.
//
// A null g_new, g_fi or g_dpfj stands for a zero cotangent (autograd passes
// none for an unused output); a null g_xyz or g_feats skips that gradient.
// Both outputs are zeroed here, on the stream, before the launch.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;

__global__ void __launch_bounds__(kWarps * 32)
ball_group_bwd_kernel(const int* __restrict__ idx,
                      const int* __restrict__ qidx,
                      const float* __restrict__ g_new,
                      const float* __restrict__ g_fi,
                      const float* __restrict__ g_dpfj, int B, int N, int M,
                      int C, int K, float dp_scale, int relative,
                      float* __restrict__ g_xyz, float* __restrict__ g_feats) {
  extern __shared__ int snbr[];  // kWarps x K neighbour indices
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long g = (long long)blockIdx.x * kWarps + warp;
  if (g >= (long long)B * M) return;  // whole warp; the block never syncs
  const int b = (int)(g / M);
  const int m = (int)(g % M);
  const size_t bm = (size_t)b * M + m;
  int* nbr = snbr + warp * K;
  for (int k = lane; k < K; k += 32) nbr[k] = idx[bm * K + k];
  __syncwarp();
  const int q = qidx[bm];
  float* GX = g_xyz ? g_xyz + (size_t)b * N * 3 : nullptr;
  float* GF = g_feats ? g_feats + (size_t)b * N * C : nullptr;
  const int W = C + 3;

  float dp_sum = 0.0f;  // lanes 0..2: sum_k g_dp[k] * s
  if (g_dpfj) {
    const size_t k_stride = (size_t)M * W;
    const float* G0 = g_dpfj + ((size_t)b * K * M + m) * W;
    for (int c = lane; c < W; c += 32) {
      const bool is_dp = c < 3;
      float* dst = is_dp ? GX : GF;
      if (!dst) continue;
      const int width = is_dp ? 3 : C;
      const int col = is_dp ? c : c - 3;
      int run = nbr[0];
      float acc = 0.0f;
#pragma unroll 4
      for (int k = 0; k < K; ++k) {
        const int j = nbr[k];
        float v = G0[k * k_stride + c];
        if (is_dp) {
          v = __fmul_rn(v, dp_scale);
          dp_sum = __fadd_rn(dp_sum, v);
        }
        if (j != run) {
          atomicAdd(dst + (size_t)run * width + col, acc);
          run = j;
          acc = 0.0f;
        }
        acc = __fadd_rn(acc, v);
      }
      atomicAdd(dst + (size_t)run * width + col, acc);
    }
  }
  if (GX && lane < 3) {
    float v = g_new ? g_new[bm * 3 + lane] : 0.0f;
    if (relative) v = __fsub_rn(v, dp_sum);
    atomicAdd(GX + (size_t)q * 3 + lane, v);
  }
  if (GF && g_fi) {
    for (int c = lane; c < C; c += 32)
      atomicAdd(GF + (size_t)q * C + c, g_fi[bm * C + c]);
  }
}

}  // namespace

extern "C" {

// idx (B,M,K) i32, qidx (B,M) i32, g_new (B,M,3), g_fi (B,M,C),
// g_dpfj (B,K,M,3+C) f32 contiguous or null -> g_xyz (B,N,3), g_feats
// (B,N,C) f32 (either may be null). dp_scale = f32(1/r) or 1.
// Returns cudaError_t.
int ball_group_bwd_launch(const int* idx, const int* qidx, const float* g_new,
                          const float* g_fi, const float* g_dpfj, int B, int N,
                          int M, int C, int K, float dp_scale, int relative,
                          float* g_xyz, float* g_feats, cudaStream_t stream) {
  if (B <= 0 || N <= 0 || M <= 0 || C < 0 || K <= 0)
    return cudaErrorInvalidValue;
  cudaError_t e;
  if (g_xyz) {
    e = cudaMemsetAsync(g_xyz, 0, (size_t)B * N * 3 * sizeof(float), stream);
    if (e != cudaSuccess) return e;
  }
  if (g_feats && C > 0) {
    e = cudaMemsetAsync(g_feats, 0, (size_t)B * N * C * sizeof(float), stream);
    if (e != cudaSuccess) return e;
  }
  const size_t smem = (size_t)kWarps * K * sizeof(int);
  e = cudaFuncSetAttribute(ball_group_bwd_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  const long long warps = (long long)B * M;
  const int blocks = (int)((warps + kWarps - 1) / kWarps);
  ball_group_bwd_kernel<<<blocks, kWarps * 32, smem, stream>>>(
      idx, qidx, g_new, g_fi, g_dpfj, B, N, M, C, K, dp_scale, relative,
      g_xyz, g_feats);
  return cudaGetLastError();
}

const char* apt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
