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
// What bounds it: bytes. The (B, K, M, 3+C) output is the largest array it
// touches (73 MB at stage 1 of PointNeXt-S at B=32 against 4.2 MB of
// feature input, 280 MB over the four stages); the distance work stops at
// the K-th neighbour.
//
// Design: a block of 8 warps owns a tile of TM consecutive centers of one
// cloud. 1. It stages the cloud's points in shared memory where they fit
// (ball_query.cuh stage_points; global reads otherwise), and one warp a
// center runs ball_scan (128 points an iteration) into the tile's slot
// table; the same warp writes the center's idx row, new_xyz and fi. 2. Slot
// by slot, a warp a slot: the rows of the tile's centers in slot k,
// dpfj[b, k, m0 : m0+TM, :], lie next to each other in memory, TM (3+C)
// floats in one span. The warp assembles the span in its own shared-memory
// buffer (16-byte loads of the feature rows where C is a multiple of 4 and
// the pointer allows it, one channel a lane otherwise; dp from the staged
// points), then streams it out with 16-byte stores: the buffer starts at the
// span's offset modulo 16 bytes, so every aligned piece of the span is one
// aligned store and only its two ragged ends are scalar. A span longer than
// the buffer (very wide C) goes through it in windows. Warps never wait for
// each other after the ball query, so one warp's loads overlap another's
// stores.
//
// Arithmetic: d2 = (dx*dx + dy*dy) + dz*dz rounded step by step
// (__fmul_rn/__fadd_rn, -fmad=false), so the strict boundary test and the
// indices equal the plain version's bit for bit; dp is one rounded subtract
// and one rounded multiply; everything else is copied.
#include "ball_query.cuh"

namespace {

using apt_bq::ball_scan;
using apt_bq::stage_points;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kLoads = 4;  // feature loads in flight a lane
constexpr size_t kSmemLimit = 232448;  // bytes a block may use on sm_90

__host__ __device__ inline size_t a128(size_t x) {
  return (x + 127) / 128 * 128;
}

struct FwdLayout {
  size_t nb, cq, xs, buf, total;
};

// Shared memory of a block: the tile's slot table (TM x K indices), each
// center's coordinates, the cloud's N points when staged, and each warp's
// span buffer of CAP floats.
__host__ __device__ inline FwdLayout fwd_layout(int TM, int K, int N,
                                                int use_xs, int CAP) {
  FwdLayout L;
  size_t o = 0;
  L.nb = o;
  o += a128((size_t)TM * K * 4);
  L.cq = o;
  o += a128((size_t)TM * 16);
  L.xs = o;
  if (use_xs) o += a128((size_t)N * 16);
  L.buf = o;
  o += kWarps * a128((size_t)CAP * 4);
  L.total = o;
  return L;
}

struct FwdParams {
  const float* xyz;
  const int* qidx;
  const float* feats;
  int N, M, C, K, TM, use_xs, CAP, relative;
  float r2, dp_scale;
  float* new_xyz;
  float* fi;
  float* dpfj;
  int* idx_out;
};

__device__ __forceinline__ float comp(const float4& v, int d) {
  return d == 0 ? v.x : (d == 1 ? v.y : v.z);
}

// Slot k of the tile's centers 0 .. tmv-1: their rows of dpfj, one span of
// tmv * W floats from element s0, through the warp's buffer buf (CAP floats,
// a multiple of 4) in windows of the span taken modulo 16 bytes.
template <int V>
__device__ __forceinline__ void write_slot(const FwdParams& p, int k,
                                           size_t s0, int tmv, const int* nb,
                                           const float4* cq, const float4* xs,
                                           const float* Xg, const float* F,
                                           float* buf, int lane) {
  const int K = p.K, C = p.C, W = C + 3;
  const int pad = (int)(s0 & 3);
  const int end = pad + tmv * W;  // the span in buffer coordinates
  float* dst = p.dpfj + (s0 - pad);  // 16-byte aligned
  const int P = C / V;  // feature pieces a row
  for (int w0 = 0; w0 < end; w0 += p.CAP) {
    const int x_a = max(pad, w0), x_b = min(end, w0 + p.CAP);
    const int e_a = x_a - pad, e_b = x_b - pad;  // span elements in window
    float* win = buf - w0 + pad;  // win[e] is span element e's place
    const int c_a = e_a / W, c_b = (e_b - 1) / W;  // rows in the window
    // dp: three values a row
    for (int t = 3 * c_a + lane; t < 3 * (c_b + 1); t += 32) {
      const int c = t / 3, d = t - 3 * c;
      const int e = c * W + d;
      if (e < e_a || e >= e_b) continue;
      const int j = nb[c * K + k];
      float v = xs ? comp(xs[j], d) : Xg[3 * j + d];
      if (p.relative)
        v = __fmul_rn(__fsub_rn(v, comp(cq[c], d)), p.dp_scale);
      win[e] = v;
    }
    // fj: V channels a piece, the window's pieces [pi_a, pi_b)
    if (P > 0) {
      const int col_a = e_a - c_a * W, col_b = e_b - 1 - c_b * W;
      const int pi_a = c_a * P + (col_a < 3 ? 0 : (col_a - 3) / V);
      const int pi_b = c_b * P + (col_b < 3 ? 0 : (col_b - 3) / V + 1);
      for (int pi0 = pi_a + lane; pi0 < pi_b; pi0 += 32 * kLoads) {
        float v[kLoads][V];
        int at[kLoads];
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          const int pi = pi0 + 32 * u;
          at[u] = -1;
          if (pi >= pi_b) continue;
          const int c = pi / P, q = pi - c * P;
          const float* src = F + (size_t)nb[c * K + k] * C + q * V;
          if constexpr (V == 4) {
            const float4 f = *reinterpret_cast<const float4*>(src);
            v[u][0] = f.x;
            v[u][1] = f.y;
            v[u][2] = f.z;
            v[u][3] = f.w;
          } else {
            v[u][0] = *src;
          }
          at[u] = c * W + 3 + q * V;
        }
        // lanes 8 apart write their 16 bytes rotated by one word, so the
        // scalar shared stores of a warp fall on distinct banks
        const int rot = V == 4 ? (lane >> 3) : 0;
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          if (at[u] < 0) continue;
#pragma unroll
          for (int i = 0; i < V; ++i) {
            const int s = (i + rot) & (V - 1);
            float val;
            if constexpr (V == 4)
              val = s == 0 ? v[u][0] : s == 1 ? v[u][1]
                  : s == 2 ? v[u][2] : v[u][3];
            else
              val = v[u][0];
            const int e = at[u] + s;
            if (e >= e_a && e < e_b) win[e] = val;
          }
        }
      }
    }
    __syncwarp();
    // out: every aligned 4-float piece of the window as one 16-byte store
    for (int x0 = (x_a & ~3) + 4 * lane; x0 < x_b; x0 += 128) {
      const float* from = buf + (x0 - w0);
      if (x0 >= x_a && x0 + 4 <= x_b) {
        *reinterpret_cast<float4*>(dst + x0) =
            *reinterpret_cast<const float4*>(from);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (x0 + u >= x_a && x0 + u < x_b) dst[x0 + u] = from[u];
      }
    }
    __syncwarp();
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
ball_group_kernel(FwdParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const FwdLayout L = fwd_layout(p.TM, p.K, p.N, p.use_xs, p.CAP);
  int* nb = reinterpret_cast<int*>(smem + L.nb);
  float4* cq = reinterpret_cast<float4*>(smem + L.cq);
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int K = p.K, C = p.C;
  const int m0 = blockIdx.x * p.TM;
  const int tmv = min(p.TM, p.M - m0);
  const float* Xg = p.xyz + (size_t)b * p.N * 3;
  const float* F = p.feats + (size_t)b * p.N * C;

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

  // 1. ball query, one warp a center; its idx row, new_xyz and fi
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
    if (lane == 0) cq[c] = make_float4(qc.x, qc.y, qc.z, 0.0f);
    const float* fq = F + (size_t)qi * C;
    float* fo = p.fi + bm * C;
    if constexpr (V == 4) {
      for (int q = lane; q < C / 4; q += 32)
        reinterpret_cast<float4*>(fo)[q] =
            reinterpret_cast<const float4*>(fq)[q];
    } else {
      for (int ch = lane; ch < C; ch += 32) fo[ch] = fq[ch];
    }
  }
  __syncthreads();

  // 2. slot by slot, a warp a slot: the span dpfj[b, k, m0 : m0+tmv, :]
  float* buf = reinterpret_cast<float*>(smem + L.buf +
                                        warp * a128((size_t)p.CAP * 4));
  for (int k = warp; k < K; k += kWarps) {
    const size_t s0 = (((size_t)b * K + k) * p.M + m0) * (size_t)(C + 3);
    write_slot<V>(p, k, s0, tmv, nb, cq, xs, Xg, F, buf, lane);
  }
}

template <int V>
int launch(const FwdParams& p, int B, cudaStream_t stream) {
  const size_t smem = fwd_layout(p.TM, p.K, p.N, p.use_xs, p.CAP).total;
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      ball_group_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((p.M + p.TM - 1) / p.TM, B);
  ball_group_kernel<V><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory of one block (bytes): TM centers of K slots, the cloud's N
// points when staged (use_xs), and 8 span buffers of CAP floats.
long long ball_group_smem_bytes(int TM, int K, int N, int use_xs, int CAP) {
  return (long long)fwd_layout(TM, K, N, use_xs, CAP).total;
}

// xyz (B,N,3) f32, qidx (B,M) i32, feats (B,N,C) f32, all contiguous ->
// new_xyz (B,M,3), fi (B,M,C), dpfj (B,K,M,3+C) f32 (16-byte aligned), idx
// (B,M,K) i32. r2 = f32(r)*f32(r); dp_scale = f32(1/r) or 1. TM centers a
// block, use_xs, CAP floats a span buffer (a multiple of 4) and vec (4: the
// features read 16 bytes at a time, which needs C % 4 == 0 and an aligned
// pointer; or 1) as ops/ballgroup.py fwd_tiling picks them. Returns
// cudaError_t.
int ball_group_launch(const float* xyz, const int* qidx, const float* feats,
                      int B, int N, int M, int C, int K, float r2,
                      float dp_scale, int relative, int TM, int use_xs,
                      int CAP, int vec, float* new_xyz, float* fi,
                      float* dpfj, int* idx, cudaStream_t stream) {
  if (B <= 0 || N <= 0 || M <= 0 || C < 0 || K <= 0 || TM <= 0 ||
      TM > 1024 || CAP < 4 || (CAP & 3) ||
      (reinterpret_cast<uintptr_t>(dpfj) & 15))
    return cudaErrorInvalidValue;
  if (vec == 4 &&
      (C % 4 || (reinterpret_cast<uintptr_t>(feats) & 15) ||
       (reinterpret_cast<uintptr_t>(fi) & 15)))
    return cudaErrorInvalidValue;
  if (vec != 1 && vec != 4) return cudaErrorInvalidValue;
  const FwdParams p{xyz, qidx, feats, N, M, C, K, TM, use_xs, CAP, relative,
                    r2, dp_scale, new_xyz, fi, dpfj, idx};
  return vec == 4 ? launch<4>(p, B, stream) : launch<1>(p, B, stream);
}

const char* apt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
