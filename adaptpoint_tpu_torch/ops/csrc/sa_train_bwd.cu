// Backward of the differentiable fused SetAbstraction stage for Hopper
// (sm_90a): recompute the grouped rows and the first conv, route each
// output's cotangent to its winning slot, and scatter the input gradients.
//
// Replaces the TPU kernel adaptpoint_tpu/ops/pallas/saeval.py _sa_train_bwd
// (_sa_bwd_kernel), the VJP of sa_train_pallas. Same function as the plain
// version ops/saeval.py sa_train_bwd_plain. With the forward's neighbours
// idx, its winning slots arg (the first slot holding each output's maximum,
// saeval.cu writes both) and its rounding (gg = bf16 gathered rows, h_pre =
// gg . bf16(w1) + b1, hb = bf16(relu(h_pre))):
//   g_o   = g_out at the winning slot of each (center, channel), else 0
//   g_h   = (bf16(g_o) . bf16(w2)^T) where h_pre > 0, else 0
//   g_v   = bf16(g_h) . bf16(w1)^T * scale_row   (dp columns times dp_scale)
//   bf16(g_v) is scattered onto each slot's neighbour row: columns 0..2 to
//   g_xyz, 3.. to g_feats (an empty ball's slot 0 is point 0);
//   the center's row gets g_new - sum_k g_v[:3] (when relative) and g_fi,
//   unrounded.
// With param_grads also gw2 = hb^T bf16(g_o), gb2 = sum g_o, gw1 = gg^T
// bf16(g_h), gb1 = sum g_h (padded (Wp, midp), (midp), (midp, coutp),
// (coutp); summed over all centers with atomics). The frozen classifier of
// the GAN step asks for none of them.
//
// Design: the forward's block layout. One block of 8 warps per tile of TM
// centers of one cloud, Kp = round16(K) rows a center, TM * Kp <= 128. The
// block reads the saved neighbours, stages the gathered rows A (R x Wp
// bf16) and builds GO (R x coutp bf16: bf16(g_out) in the winning slot's
// row, zero elsewhere) in shared memory, recomputes H = bf16(relu(h_pre))
// (R x mid) with the forward's wmma tiles, then on the tensor cores
// g_h = GO . w2^T, masked by H > 0 and rounded in place over H, and
// g_v = GH . w1^T, whose tiles go from the warp's scratch straight to
// atomicAdd onto the neighbour rows. The weights are read transposed by
// col-major fragments from device memory (L2), as the forward reads them.
// The mask H > 0 equals h_pre > 0 except where 0 < h_pre < 2^-133 rounds to
// zero in bf16. Nothing grouped goes to device memory.
//
// What bounds it: operations, about twice the forward's tensor-core work
// (the recomputed conv, then g_h and g_v), three times with param_grads;
// plain wmma from shared memory reaches a fraction of the bf16 peak.
//
// Determinism: the scatter's atomic adds land in no fixed order (the usual
// f32 reordering error); everything before them is fixed.
#include "sa_common.cuh"

namespace {

using namespace apt_sa;

struct Params {
  const float* xyz;
  const int* qidx;
  const float* feats;
  const int* idx;            // (B, M, K) the forward's neighbours
  const unsigned char* arg;  // (B, M, cout) the forward's winning slots
  const bf16* w1;            // (Wp, midp) row-major, zero padded
  const float* b1;           // (midp)
  const bf16* w2;            // (midp, coutp) row-major, zero padded
  const float* g_out;        // (B, M, cout)
  const float* g_new;        // (B, M, 3) or null
  const float* g_fi;         // (B, M, C) or null
  int N, M, C, K, TM, Wp, midp, coutp, cout;
  float dp_scale;
  int relative;
  float* g_xyz;    // (B, N, 3) or null
  float* g_feats;  // (B, N, C) or null
  float* gw1;      // (Wp, midp), gb1 (midp), gw2 (midp, coutp), gb2
  float* gb1;      // (coutp): all null without param_grads
  float* gw2;
  float* gb2;
};

struct Layout {
  size_t a, h, go, scratch, nbr, qs, dps, total;
};

__host__ __device__ inline Layout layout(int TM, int K, int Wp, int midp,
                                         int coutp) {
  const size_t R = (size_t)TM * round16(K);
  Layout L;
  L.a = 0;
  L.h = L.a + align128(R * Wp * 2);
  L.go = L.h + align128(R * midp * 2);
  L.scratch = L.go + align128(R * coutp * 2);
  L.nbr = L.scratch + align128((size_t)kWarps * 256 * 4);
  L.qs = L.nbr + align128((size_t)TM * K * 4);
  L.dps = L.qs + align128((size_t)TM * 4 * 4);
  L.total = L.dps + align128((size_t)TM * 4 * 4);
  return L;
}

// g_h for NT row tiles of hidden column tile mt: GO . w2^T, masked by
// H > 0, rounded to bf16 in place over H; with gb1 the column sums of the
// masked g_h go to gb1.
template <int NT>
__device__ void grad_h_tiles(const Params& p, const bf16* GO, bf16* H,
                             float* sc, int rt0, int mt, int lane) {
  FragC acc[NT];
  mma_tiles<NT, FragA, FragBt>(acc, GO, p.coutp, (size_t)16 * p.coutp, 16,
                               rt0, p.w2 + (size_t)mt * 16 * p.coutp,
                               p.coutp, 16, p.coutp / 16);
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    wmma::store_matrix_sync(sc, acc[t], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      bf16* h = H + (size_t)((rt0 + t) * 16 + (e >> 4)) * p.midp + mt * 16 +
                (e & 15);
      const float v = __bfloat162float(*h) > 0.0f ? sc[e] : 0.0f;
      sc[e] = v;
      *h = __float2bfloat16_rn(v);
    }
    __syncwarp();
    if (p.gb1 && lane < 16) {
      float s = 0.0f;
      for (int rr = 0; rr < 16; ++rr) s = __fadd_rn(s, sc[rr * 16 + lane]);
      if (s != 0.0f) atomicAdd(p.gb1 + mt * 16 + lane, s);
    }
    __syncwarp();
  }
}

// g_v for NT row tiles of input column tile wt: GH . w1^T, then the
// scatter of its rounded entries onto the neighbour rows and the dp sums of
// the centers.
template <int NT>
__device__ void grad_v_tiles(const Params& p, const bf16* GH, const int* nbr,
                             float* dps, float* sc, int b, int m0, int rt0,
                             int wt, int lane) {
  FragC acc[NT];
  mma_tiles<NT, FragA, FragBt>(acc, GH, p.midp, (size_t)16 * p.midp, 16, rt0,
                               p.w1 + (size_t)wt * 16 * p.midp, p.midp, 16,
                               p.midp / 16);
  const int Kp = round16(p.K);
  const int W = p.C + 3;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    wmma::store_matrix_sync(sc, acc[t], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = (rt0 + t) * 16 + (e >> 4);
      const int col = wt * 16 + (e & 15);
      const int c = r / Kp;
      const int k = r - c * Kp;
      if (k >= p.K || col >= W || m0 + c >= p.M) continue;
      float v = sc[e];
      const int j = nbr[c * p.K + k];
      if (col < 3) {
        v = __fmul_rn(v, p.dp_scale);
        if (p.relative && v != 0.0f) atomicAdd(dps + c * 4 + col, v);
        const float vb = bf16r(v);
        if (p.g_xyz && vb != 0.0f)
          atomicAdd(p.g_xyz + ((size_t)b * p.N + j) * 3 + col, vb);
      } else {
        const float vb = bf16r(v);
        if (p.g_feats && vb != 0.0f)
          atomicAdd(p.g_feats + ((size_t)b * p.N + j) * p.C + (col - 3), vb);
      }
    }
    __syncwarp();
  }
}

// One 16 x 16 tile of a weight gradient, summed over the block's rows:
// out[mt, ct] += A^T(mt) . Bm(ct), then atomicAdd into the (rows, ld)
// gradient buffer.
__device__ void weight_grad_tile(const bf16* A, int lda, const bf16* Bm,
                                 int ldb, int R, float* out, int ld, float* sc,
                                 int mt, int ct, int lane) {
  FragC acc[1];
  mma_tiles<1, FragAt, FragB>(acc, A, lda, 16, (size_t)16 * lda, mt,
                              Bm + ct * 16, ldb, (size_t)16 * ldb, R / 16);
  wmma::store_matrix_sync(sc, acc[0], 16, wmma::mem_row_major);
  __syncwarp();
  for (int e = lane; e < 256; e += 32)
    if (sc[e] != 0.0f)
      atomicAdd(out + (size_t)(mt * 16 + (e >> 4)) * ld + ct * 16 + (e & 15),
                sc[e]);
  __syncwarp();
}

__global__ void __launch_bounds__(kThreads) sa_train_bwd_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(p.TM, p.K, p.Wp, p.midp, p.coutp);
  bf16* A = reinterpret_cast<bf16*>(smem + L.a);
  bf16* H = reinterpret_cast<bf16*>(smem + L.h);
  bf16* GO = reinterpret_cast<bf16*>(smem + L.go);
  float* scratch = reinterpret_cast<float*>(smem + L.scratch);
  int* nbr = reinterpret_cast<int*>(smem + L.nbr);
  float* qs = reinterpret_cast<float*>(smem + L.qs);
  float* dps = reinterpret_cast<float*>(smem + L.dps);

  const int b = blockIdx.y;
  const int m0 = blockIdx.x * p.TM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* X = p.xyz + (size_t)b * p.N * 3;
  const float* F = p.feats + (size_t)b * p.N * p.C;
  const int K = p.K;
  const int Kp = round16(K);
  const int R = p.TM * Kp;

  // 1. the saved neighbours and the centers; a center past M reads point 0
  //    and contributes nothing
  for (int c = warp; c < p.TM; c += kWarps) {
    const int m = m0 + c;
    const bool valid = m < p.M;
    const size_t bm = (size_t)b * p.M + m;
    const int q = valid ? p.qidx[bm] : 0;
    for (int k = lane; k < K; k += 32)
      nbr[c * K + k] = valid ? p.idx[bm * K + k] : 0;
    if (lane < 4) {
      qs[c * 4 + lane] = lane < 3 ? X[3 * q + lane] : 0.0f;
      dps[c * 4 + lane] = 0.0f;
    }
  }
  __syncthreads();

  // 2. the gathered rows, and GO: bf16(g_out) in each output's winning row
  stage_rows(A, nbr, qs, X, F, R, p.Wp, K, p.C, p.relative, p.dp_scale);
  for (int e = threadIdx.x; e < R * p.coutp; e += kThreads) {
    const int r = e / p.coutp;
    const int col = e - r * p.coutp;
    const int c = r / Kp;
    const int k = r - c * Kp;
    const int m = m0 + c;
    float v = 0.0f;
    if (k < K && col < p.cout && m < p.M) {
      const size_t o = ((size_t)b * p.M + m) * p.cout + col;
      if (p.arg[o] == k) v = p.g_out[o];
    }
    GO[e] = __float2bfloat16_rn(v);
  }
  if (p.gb2)
    for (int e = threadIdx.x; e < p.TM * p.cout; e += kThreads) {
      const int c = e / p.cout;
      const int col = e - c * p.cout;
      if (m0 + c < p.M)
        atomicAdd(p.gb2 + col, p.g_out[((size_t)b * p.M + m0 + c) * p.cout +
                                       col]);
    }
  __syncthreads();

  // 3. H = bf16(relu(A . w1 + b1)), as the forward computed it
  float* sc = scratch + warp * 256;
  const int tpc = Kp / 16;
  const int MT = p.midp / 16;
  const int CT = p.coutp / 16;
  const int WT = p.Wp / 16;
  const int g1 = center_group(p.TM, MT);
  const int n1 = MT * (p.TM / g1);
  for (int u = warp; u < n1; u += kWarps)
    conv1_unit(g1 * tpc, A, p.Wp, p.w1, p.b1, H, p.midp, sc,
               (u / MT) * g1 * tpc, u % MT, lane);
  __syncthreads();

  // 4. gw2 += H^T . GO
  if (p.gw2) {
    for (int u = warp; u < MT * CT; u += kWarps)
      weight_grad_tile(H, p.midp, GO, p.coutp, R, p.gw2, p.coutp, sc, u / CT,
                       u % CT, lane);
    __syncthreads();
  }

  // 5. GH = bf16(mask . (GO . w2^T)) over H
  const int nt = g1 * tpc;
  for (int u = warp; u < n1; u += kWarps) {
    const int rt0 = (u / MT) * nt;
    const int mt = u % MT;
    switch (nt) {
      case 1: grad_h_tiles<1>(p, GO, H, sc, rt0, mt, lane); break;
      case 2: grad_h_tiles<2>(p, GO, H, sc, rt0, mt, lane); break;
      case 3: grad_h_tiles<3>(p, GO, H, sc, rt0, mt, lane); break;
      case 4: grad_h_tiles<4>(p, GO, H, sc, rt0, mt, lane); break;
      case 5: grad_h_tiles<5>(p, GO, H, sc, rt0, mt, lane); break;
      case 6: grad_h_tiles<6>(p, GO, H, sc, rt0, mt, lane); break;
      case 7: grad_h_tiles<7>(p, GO, H, sc, rt0, mt, lane); break;
      default: grad_h_tiles<8>(p, GO, H, sc, rt0, mt, lane); break;
    }
  }
  __syncthreads();

  // 6. gw1 += A^T . GH
  if (p.gw1) {
    for (int u = warp; u < WT * MT; u += kWarps)
      weight_grad_tile(A, p.Wp, H, p.midp, R, p.gw1, p.midp, sc, u / MT,
                       u % MT, lane);
  }

  // 7. g_v = GH . w1^T onto the neighbour rows
  const int gv = center_group(p.TM, WT);
  const int ntv = gv * tpc;
  for (int u = warp; u < WT * (p.TM / gv); u += kWarps) {
    const int rt0 = (u / WT) * ntv;
    const int wt = u % WT;
    switch (ntv) {
      case 1:
        grad_v_tiles<1>(p, H, nbr, dps, sc, b, m0, rt0, wt, lane);
        break;
      case 2:
        grad_v_tiles<2>(p, H, nbr, dps, sc, b, m0, rt0, wt, lane);
        break;
      case 3:
        grad_v_tiles<3>(p, H, nbr, dps, sc, b, m0, rt0, wt, lane);
        break;
      case 4:
        grad_v_tiles<4>(p, H, nbr, dps, sc, b, m0, rt0, wt, lane);
        break;
      case 5:
        grad_v_tiles<5>(p, H, nbr, dps, sc, b, m0, rt0, wt, lane);
        break;
      case 6:
        grad_v_tiles<6>(p, H, nbr, dps, sc, b, m0, rt0, wt, lane);
        break;
      case 7:
        grad_v_tiles<7>(p, H, nbr, dps, sc, b, m0, rt0, wt, lane);
        break;
      default:
        grad_v_tiles<8>(p, H, nbr, dps, sc, b, m0, rt0, wt, lane);
        break;
    }
  }
  __syncthreads();

  // 8. the centers' own rows: g_new - sum_k g_dp, and g_fi
  for (int c = warp; c < p.TM; c += kWarps) {
    const int m = m0 + c;
    if (m >= p.M) continue;
    const size_t bm = (size_t)b * p.M + m;
    const int q = p.qidx[bm];
    if (p.g_xyz && lane < 3) {
      float v = p.g_new ? p.g_new[bm * 3 + lane] : 0.0f;
      if (p.relative) v = __fsub_rn(v, dps[c * 4 + lane]);
      atomicAdd(p.g_xyz + ((size_t)b * p.N + q) * 3 + lane, v);
    }
    if (p.g_feats && p.g_fi)
      for (int cc = lane; cc < p.C; cc += 32)
        atomicAdd(p.g_feats + ((size_t)b * p.N + q) * p.C + cc,
                  p.g_fi[bm * p.C + cc]);
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs at these sizes (bytes); TM * round16(K)
// must be at most 128 rows.
long long sa_train_bwd_smem_bytes(int TM, int K, int Wp, int midp, int coutp) {
  return (long long)layout(TM, K, Wp, midp, coutp).total;
}

// xyz (B,N,3), feats (B,N,C) f32, qidx (B,M) i32, idx (B,M,K) i32 and arg
// (B,M,cout) u8 of the forward; w1 (Wp,midp) bf16, b1 (midp) f32, w2
// (midp,coutp) bf16 as the forward took them; g_out (B,M,cout) f32, g_new
// (B,M,3) and g_fi (B,M,C) f32 or null -> g_xyz (B,N,3), g_feats (B,N,C)
// f32 (either null to skip it) and, when gw1 is not null, gw1 (Wp,midp),
// gb1 (midp), gw2 (midp,coutp), gb2 (coutp) f32. Every output is zeroed here
// on the stream. Returns cudaError_t.
int sa_train_bwd_launch(const float* xyz, const int* qidx, const float* feats,
                        const int* idx, const unsigned char* arg,
                        const void* w1, const float* b1, const void* w2,
                        const float* g_out, const float* g_new,
                        const float* g_fi, int B, int N, int M, int C, int K,
                        int TM, int Wp, int midp, int coutp, int cout,
                        float dp_scale, int relative, float* g_xyz,
                        float* g_feats, float* gw1, float* gb1, float* gw2,
                        float* gb2, cudaStream_t stream) {
  if (B <= 0 || N <= 0 || M <= 0 || K <= 0 || TM <= 0 ||
      TM * round16(K) > 128 || Wp % 16 || midp % 16 || coutp % 16 ||
      Wp < C + 3 || cout > coutp || (gw1 && !(gb1 && gw2 && gb2)))
    return cudaErrorInvalidValue;
  const size_t smem = layout(TM, K, Wp, midp, coutp).total;
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t e;
  const struct { float* ptr; size_t n; } zero[] = {
      {g_xyz, (size_t)B * N * 3}, {g_feats, (size_t)B * N * C},
      {gw1, (size_t)Wp * midp},   {gb1, (size_t)midp},
      {gw2, (size_t)midp * coutp}, {gb2, (size_t)coutp}};
  for (const auto& z : zero) {
    if (!z.ptr || !z.n) continue;
    e = cudaMemsetAsync(z.ptr, 0, z.n * sizeof(float), stream);
    if (e != cudaSuccess) return e;
  }
  Params p;
  p.xyz = xyz;
  p.qidx = qidx;
  p.feats = feats;
  p.idx = idx;
  p.arg = arg;
  p.w1 = static_cast<const bf16*>(w1);
  p.b1 = b1;
  p.w2 = static_cast<const bf16*>(w2);
  p.g_out = g_out;
  p.g_new = g_new;
  p.g_fi = g_fi;
  p.N = N;
  p.M = M;
  p.C = C;
  p.K = K;
  p.TM = TM;
  p.Wp = Wp;
  p.midp = midp;
  p.coutp = coutp;
  p.cout = cout;
  p.dp_scale = dp_scale;
  p.relative = relative;
  p.g_xyz = g_xyz;
  p.g_feats = g_feats;
  p.gw1 = gw1;
  p.gb1 = gw1 ? gb1 : nullptr;
  p.gw2 = gw1 ? gw2 : nullptr;
  p.gb2 = gw1 ? gb2 : nullptr;
  e = cudaFuncSetAttribute(sa_train_bwd_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((M + TM - 1) / TM, B);
  sa_train_bwd_kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

const char* apt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
