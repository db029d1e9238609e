// The ball query shared by the fused SA forward (saeval.cu) and the
// max-pooled ball group (ballgroup_max.cu) for Hopper (sm_90a): a cloud's
// points staged in shared memory, a point to 16 bytes, and the scan of one
// center by one warp.
//
// Selection (the ball-group kernel's, TPU kernel
// adaptpoint_tpu/ops/pallas/ballgroup.py): the first K points j in index
// order with d2 < r2, d2 rounded step by step (__fsub_rn, __fmul_rn,
// __fadd_rn; the sources build with -fmad=false), so it equals the plain
// version ops/geometry.py ball_query bit for bit.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace apt_bq {

__device__ __forceinline__ int bq_min(int a, int b) { return a < b ? a : b; }

// The cloud's N points (Xg, (N, 3) f32) into xs, a point to 16 bytes (the
// fourth component is never read), by nthreads threads from thread tid:
// 16-byte loads of the flat array where N and the pointer allow them. The
// caller synchronises before reading xs.
__device__ __forceinline__ void stage_points(float4* xs, const float* Xg,
                                             int N, int tid, int nthreads) {
  if ((N & 3) == 0 && (reinterpret_cast<uintptr_t>(Xg) & 15) == 0) {
    float* xf = reinterpret_cast<float*>(xs);
    const float4* x4 = reinterpret_cast<const float4*>(Xg);
    for (int e = tid; e < N * 3 / 4; e += nthreads) {
      const float4 v = x4[e];
      const float c4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int f = 4 * e + u;
        const int j = f / 3;
        xf[4 * j + f - 3 * j] = c4[u];
      }
    }
  } else {
    for (int e = tid; e < N; e += nthreads)
      xs[e] = make_float4(Xg[3 * e], Xg[3 * e + 1], Xg[3 * e + 2], 0.0f);
  }
}

// The ball query of one center qc by one warp: the first K points j (in
// index order) with d2 < r2, into nb[0 ..]; returns how many were in the
// ball (at least that many were scanned). Four chunks of 32 points an
// iteration: their loads, distances and ballots first, then the ranks in
// index order (a chunk with no point in the ball skips that).
template <typename Point>
__device__ __forceinline__ int ball_scan(const Point& point, float3 qc,
                                         float r2, int N, int K, int* nb,
                                         int lane) {
  const unsigned below = (1u << lane) - 1u;
  int cnt = 0;
  for (int base = 0; base < N && cnt < K; base += 128) {
    float3 x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      x[u] = point(bq_min(base + 32 * u + lane, N - 1));
    unsigned mask[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float dx = __fsub_rn(qc.x, x[u].x);
      const float dy = __fsub_rn(qc.y, x[u].y);
      const float dz = __fsub_rn(qc.z, x[u].z);
      const float d2 = __fadd_rn(
          __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      mask[u] = __ballot_sync(0xffffffffu,
                              base + 32 * u + lane < N && d2 < r2);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (!mask[u]) continue;
      const int rank = cnt + __popc(mask[u] & below);
      if ((mask[u] >> lane & 1u) && rank < K) nb[rank] = base + 32 * u + lane;
      cnt += __popc(mask[u]);
    }
  }
  return cnt;
}

}  // namespace apt_bq
