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
// What bounds it: bytes -- g_dpfj (B, K, M, 3+C) is read once and is the
// largest array by far (73 MB at stage 1 of PointNeXt-S at B=32, 280 MB over
// the four stages); the gradients are (B, N, 3+C), 4.2 MB a stage. Beyond
// the bytes, the adds: B M K (3 + C) of them land on B N (3 + C) addresses.
//
// Design: one warp a center, as in the forward's ball query. The warp keeps
// the center's K neighbour indices in shared memory and walks its slots,
// four rows of g_dpfj in flight (each row read once, its lanes on
// neighbouring channels, 128 channels a pass; eight rows of 32 channels
// where C <= 32, which keeps more warps on an SM); runs of equal neighbour
// index (the pad-repeated tail of a partial ball) are summed in registers.
// Each run goes out as 16-byte vector reductions (REDG.F32x4, float4
// atomicAdd): the lanes' channels pass through a small shared-memory buffer
// so that a lane holds four neighbouring channels, and a row of C channels
// takes C / 4 reductions instead of C scalar atomics (scalar ones where
// C % 4 != 0, and where C <= 32: such a row is one coalesced warp reduction
// of at most four 32-byte sectors either way, and the L2 reduces by the
// sector). Lanes 0..2 add the dp columns to g_xyz with scalar atomics and
// keep the running sum of g_dp * s for the center's term; the center's g_fi
// goes out the same way. The outputs are zeroed on the stream first (two
// memsets): a reduction needs zeros to add to, and no block can zero them
// for the others within one launch. Designs that sum in shared memory and
// write each element once (no memset) were timed slower on the H100: a
// shared-memory f32 atomic is a compare-and-swap loop, and a gather by
// support row waits on its rows' loads one list at a time (PERF.md).
//
// Determinism: the adds land in no fixed order, so a sum of n addends can
// differ from run to run and from the plain version by the usual f32
// reordering error (at most n 2^-23 sum|addend|).
//
// A null g_new, g_fi or g_dpfj stands for a zero cotangent (autograd passes
// none for an unused output); a null g_xyz or g_feats skips that gradient.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 4;  // 32-channel pieces a lane holds at most

__host__ __device__ inline size_t a16(size_t x) { return (x + 15) / 16 * 16; }

// Shared memory of a block: each warp's K neighbour indices, then each
// warp's buffer of 128 channels.
__host__ __device__ inline size_t bwd_smem(int K) {
  return a16((size_t)kWarps * K * 4) + (size_t)kWarps * 128 * 4;
}

struct BwdParams {
  const int* idx;
  const int* qidx;
  const float* g_new;
  const float* g_fi;
  const float* g_dpfj;
  int B, N, M, C, K, relative;
  float dp_scale;
  float* g_xyz;
  float* g_feats;
};

// Add acc (a lane's channels ch0 + lane + 32 t) to row GF[j, :]: through the
// warp's buffer tr as 16-byte reductions where C > 32 and C % 4 == 0, else
// one atomic a channel (a row of C <= 32 channels is one coalesced warp
// reduction either way).
template <int CP>
__device__ __forceinline__ void add_row(float* GF, int j, int C, int ch0,
                                        const float (&acc)[CP], float* tr,
                                        int lane) {
  float* row = GF + (size_t)j * C + ch0;
  const int left = C - ch0;  // channels of this pass
  if (CP > 1 && (C & 3) == 0) {
#pragma unroll
    for (int t = 0; t < CP; ++t) tr[32 * t + lane] = acc[t];
    __syncwarp();
    if (lane < 8 * CP && 4 * lane < left)
      atomicAdd(reinterpret_cast<float4*>(row) + lane,
                reinterpret_cast<const float4*>(tr)[lane]);
    __syncwarp();
  } else {
#pragma unroll
    for (int t = 0; t < CP; ++t)
      if (32 * t + lane < left) atomicAdd(row + 32 * t + lane, acc[t]);
  }
}

// CP 32-channel pieces a lane a pass (1 where C <= 32, else 4), S rows of
// g_dpfj in flight a warp.
template <int CP, int S>
__global__ void __launch_bounds__(kThreads)
ball_group_bwd_kernel(BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long g = (long long)blockIdx.x * kWarps + warp;
  if (g >= (long long)p.B * p.M) return;  // whole warp; the block never syncs
  const int M = p.M, K = p.K, C = p.C, W = C + 3;
  const int b = (int)(g / M);
  const int m = (int)(g % M);
  int* nbr = reinterpret_cast<int*>(smem) + warp * K;
  float* tr = reinterpret_cast<float*>(smem + a16((size_t)kWarps * K * 4)) +
              warp * 128;
  for (int k = lane; k < K; k += 32) nbr[k] = p.idx[g * K + k];
  __syncwarp();
  const int q = p.qidx[g];
  float* GX = p.g_xyz ? p.g_xyz + (size_t)b * p.N * 3 : nullptr;
  float* GF = p.g_feats && C > 0 ? p.g_feats + (size_t)b * p.N * C : nullptr;
  const float* G0 =
      p.g_dpfj ? p.g_dpfj + ((size_t)b * K * M + m) * W : nullptr;
  const size_t k_stride = (size_t)M * W;

  float dsum = 0.0f;  // lanes 0..2: sum_k g_dp * s
  // passes of 32 CP channels; the first also takes the dp columns
  for (int ch0 = 0; ch0 == 0 || ch0 < C; ch0 += 32 * CP) {
    const bool dp = ch0 == 0 && GX && lane < 3;
    if (!GF && !(ch0 == 0 && GX)) break;
    if (G0) {
      float acc[CP] = {}, accd = 0.0f;
      int run = nbr[0];
      for (int k0 = 0; k0 < K; k0 += S) {
        float v[S][CP], vd[S];
#pragma unroll
        for (int u = 0; u < S; ++u) {
          const float* row = G0 + (size_t)min(k0 + u, K - 1) * k_stride;
#pragma unroll
          for (int t = 0; t < CP; ++t) {
            const int ch = ch0 + 32 * t + lane;
            v[u][t] = GF && ch < C ? row[3 + ch] : 0.0f;
          }
          vd[u] = dp ? __fmul_rn(row[lane], p.dp_scale) : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < S; ++u) {
          if (k0 + u >= K) break;
          const int j = nbr[k0 + u];  // the same in every lane
          if (j != run) {
            if (dp) atomicAdd(GX + (size_t)run * 3 + lane, accd);
            if (GF) add_row(GF, run, C, ch0, acc, tr, lane);
            run = j;
            accd = 0.0f;
#pragma unroll
            for (int t = 0; t < CP; ++t) acc[t] = 0.0f;
          }
          accd = __fadd_rn(accd, vd[u]);
          dsum = __fadd_rn(dsum, vd[u]);
#pragma unroll
          for (int t = 0; t < CP; ++t) acc[t] = __fadd_rn(acc[t], v[u][t]);
        }
      }
      if (dp) atomicAdd(GX + (size_t)run * 3 + lane, accd);
      if (GF) add_row(GF, run, C, ch0, acc, tr, lane);
    }
    // the center's own cotangents
    if (GF && p.g_fi) {
      float f[CP];
#pragma unroll
      for (int t = 0; t < CP; ++t) {
        const int ch = ch0 + 32 * t + lane;
        f[t] = ch < C ? p.g_fi[g * C + ch] : 0.0f;
      }
      add_row(GF, q, C, ch0, f, tr, lane);
    }
    if (dp) {
      float v = p.g_new ? p.g_new[g * 3 + lane] : 0.0f;
      if (p.relative) v = __fsub_rn(v, dsum);
      atomicAdd(GX + (size_t)q * 3 + lane, v);
    }
  }
}

}  // namespace

extern "C" {

// Shared memory of one block (bytes) at K slots a center.
long long ball_group_bwd_smem_bytes(int K) { return (long long)bwd_smem(K); }

// idx (B,M,K) i32, qidx (B,M) i32, g_new (B,M,3), g_fi (B,M,C),
// g_dpfj (B,K,M,3+C) f32 contiguous or null (zero) -> g_xyz (B,N,3), g_feats
// (B,N,C) f32 (16-byte aligned), either null to skip it. dp_scale = f32(1/r)
// or 1. Returns cudaError_t.
int ball_group_bwd_launch(const int* idx, const int* qidx, const float* g_new,
                          const float* g_fi, const float* g_dpfj, int B, int N,
                          int M, int C, int K, float dp_scale, int relative,
                          float* g_xyz, float* g_feats, cudaStream_t stream) {
  if (B <= 0 || N <= 0 || M <= 0 || C < 0 || K <= 0 ||
      (reinterpret_cast<size_t>(g_feats) & 15))
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
  if (!g_xyz && !(g_feats && C > 0)) return cudaSuccess;
  const size_t smem = bwd_smem(K);
  const auto kernel = C <= 32 ? ball_group_bwd_kernel<1, 8>
                              : ball_group_bwd_kernel<kCols, 4>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  const BwdParams p{idx, qidx, g_new, g_fi, g_dpfj, B, N, M, C, K, relative,
                    dp_scale, g_xyz, g_feats};
  const long long warps = (long long)B * M;
  kernel<<<(int)((warps + kWarps - 1) / kWarps), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

const char* apt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
