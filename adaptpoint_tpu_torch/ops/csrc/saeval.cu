// Fused eval-mode SetAbstraction stage for Hopper (sm_90a): ball group +
// conv (BN folded) + ReLU + conv (BN folded) + max over the K neighbours.
//
// Replaces the TPU kernel adaptpoint_tpu/ops/pallas/saeval.py
// _sa_eval_kernel in both of its calls: sa_eval_pallas (the forward-only
// eval stage) and _sa_train_call (the forward of sa_train_pallas, the
// differentiable stage, whose backward is sa_train_bwd.cu). Same function
// as the plain versions ops/saeval.py sa_eval_plain / sa_train_plain, with
// the TPU kernel's rounding (splits=1):
//   new_xyz = xyz[qidx] exact; fi = bf16(feats[qidx]) returned as f32
//   selection as the ball-group kernel: first K with d2 < f32(r)^2,
//   pad-with-first, empty ball -> point 0
//   gx  = bf16(x) + bf16(x - bf16(x))          (the two-split gather)
//   dp  = (gx - q) * dp_scale                  (when relative)
//   gg  = bf16([dp || bf16(fj)])
//   h   = relu(gg . bf16(w1) + b1)             (f32 accumulate)
//   out = max_k (bf16(h) . bf16(w2) + b2)      (f32 accumulate)
// For the backward the kernel can also write the K neighbour indices of
// each center and, for each output, the first slot that holds the maximum:
// the backward then routes the cotangent to that slot without comparing a
// recomputed value with the saved maximum (a recompute in another sum order
// would match no slot and drop the gradient).
//
// Design: one block of 8 warps per tile of TM query centers of one cloud.
// Each center owns Kp = round16(K) rows (K <= 128), so every 16-row tile
// belongs to one center (TM*Kp = 128 rows at K=32). The cloud's xyz is staged
// in shared memory when it fits (12 KB at N=1024). Each warp runs the ball
// query of a center with __ballot_sync/__popc as the ball-group kernel does;
// the block then stages the gathered rows as bf16 in shared memory (A,
// R x Wp), runs the first conv on the tensor cores with wmma 16x16x16 bf16
// tiles into a bf16 H (R x mid) in shared memory, then the second conv. A
// warp's unit of work is one 16-column tile times a group of whole centers
// (up to 8 row tiles, each with its own accumulator), so each weight
// fragment is loaded once per group and used for every row tile of it, and
// the max over K of a center and column ends in one warp: no atomics, no
// second pass. Nothing grouped goes to device memory. Weights are read by
// the tensor-core loads straight from device memory (they stay in L2):
// stage 4's w1 (259x256) and w2 (256x512) bf16 are 132 KB and 262 KB and
// would not fit in shared memory beside A and H. The ragged last tile of
// centers is masked, not padded.
//
// What bounds it: operations. At PointNeXt-S's stage shapes the two convs do
// about 49 GFLOP per B=32 forward against a few MB of input; plain wmma from
// shared memory reaches a fraction of the bf16 peak (wgmma and TMA are later
// work).
//
// Arithmetic: the distance is rounded step by step (__fmul_rn/__fadd_rn,
// -fmad=false) so the selection equals the plain version's; the conv sums run
// in another order than the plain f32 matmul, which can flip one bf16
// rounding of h (the tolerance in chip_smoke.py and the tests says so).
#include "sa_common.cuh"

namespace {

using namespace apt_sa;

struct Params {
  const float* xyz;
  const int* qidx;
  const float* feats;
  const bf16* w1;    // (Wp, midp) row-major, zero padded
  const float* b1;   // (midp)
  const bf16* w2;    // (midp, coutp) row-major, zero padded
  const float* b2;   // (coutp)
  int N, M, C, K, TM, Wp, midp, coutp, cout;
  float r2, dp_scale;
  int relative, use_xs;
  float* new_xyz;
  float* fi;
  float* out;
  int* idx_out;             // (B, M, K) neighbour indices, or null
  unsigned char* arg_out;   // (B, M, cout) winning slots, or null
};

struct Layout {
  size_t a, h, scratch, omax, oarg, nbr, qs, xs, total;
};

__host__ __device__ inline Layout layout(int TM, int K, int Wp, int midp,
                                         int coutp, int N, int use_xs) {
  const size_t R = (size_t)TM * round16(K);
  Layout L;
  L.a = 0;
  L.h = L.a + align128(R * Wp * 2);
  L.scratch = L.h + align128(R * midp * 2);
  L.omax = L.scratch + align128((size_t)kWarps * 256 * 4);
  L.oarg = L.omax + align128((size_t)TM * coutp * 4);
  L.nbr = L.oarg + align128((size_t)TM * coutp);
  L.qs = L.nbr + align128((size_t)TM * K * 4);
  L.xs = L.qs + align128((size_t)TM * 4 * 4);
  L.total = L.xs + (use_xs ? align128((size_t)N * 3 * 4) : 0);
  return L;
}

// Conv 2 for one unit: the max over the valid rows of each center of
// bf16(h) . w2 + b2 and its first slot, written once per (center, column)
// since a unit holds whole centers. b2 is added before the comparison, as
// the plain version's argmax sees it (the max itself is the same either
// way: rounding is monotone).
template <int NT>
__device__ void conv2_tiles(const Params& p, const bf16* H, float* omax,
                            unsigned char* oarg, float* sc, int rt0, int ct,
                            int lane) {
  FragC acc[NT];
  mma_tiles<NT, FragA, FragB>(acc, H, p.midp, (size_t)16 * p.midp, 16, rt0,
                              p.w2 + ct * 16, p.coutp, (size_t)16 * p.coutp,
                              p.midp / 16);
  const int Kp = round16(p.K);
  const float bias = lane < 16 ? p.b2[ct * 16 + lane] : 0.0f;
  float run = __int_as_float((int)0xff800000u);  // -inf
  int arg = 0;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    wmma::store_matrix_sync(sc, acc[t], 16, wmma::mem_row_major);
    __syncwarp();
    const int r0 = (rt0 + t) * 16;
    if (lane < 16) {
      for (int rr = 0; rr < 16; ++rr) {
        const int k = (r0 + rr) % Kp;
        const float v = __fadd_rn(sc[rr * 16 + lane], bias);
        if (k < p.K && v > run) {
          run = v;
          arg = k;
        }
      }
      if ((r0 + 16) % Kp == 0) {  // last tile of this center
        const size_t o = (size_t)(r0 / Kp) * p.coutp + ct * 16 + lane;
        omax[o] = run;
        oarg[o] = (unsigned char)arg;
        run = __int_as_float((int)0xff800000u);
        arg = 0;
      }
    }
    __syncwarp();
  }
}

__device__ inline void conv2_unit(int nt, const Params& p, const bf16* H,
                                  float* omax, unsigned char* oarg, float* sc,
                                  int rt0, int ct, int lane) {
  switch (nt) {
    case 1: conv2_tiles<1>(p, H, omax, oarg, sc, rt0, ct, lane); break;
    case 2: conv2_tiles<2>(p, H, omax, oarg, sc, rt0, ct, lane); break;
    case 3: conv2_tiles<3>(p, H, omax, oarg, sc, rt0, ct, lane); break;
    case 4: conv2_tiles<4>(p, H, omax, oarg, sc, rt0, ct, lane); break;
    case 5: conv2_tiles<5>(p, H, omax, oarg, sc, rt0, ct, lane); break;
    case 6: conv2_tiles<6>(p, H, omax, oarg, sc, rt0, ct, lane); break;
    case 7: conv2_tiles<7>(p, H, omax, oarg, sc, rt0, ct, lane); break;
    default: conv2_tiles<8>(p, H, omax, oarg, sc, rt0, ct, lane); break;
  }
}

__global__ void __launch_bounds__(kThreads) sa_eval_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(p.TM, p.K, p.Wp, p.midp, p.coutp, p.N, p.use_xs);
  bf16* A = reinterpret_cast<bf16*>(smem + L.a);
  bf16* H = reinterpret_cast<bf16*>(smem + L.h);
  float* scratch = reinterpret_cast<float*>(smem + L.scratch);
  float* omax = reinterpret_cast<float*>(smem + L.omax);
  unsigned char* oarg = smem + L.oarg;
  int* nbr = reinterpret_cast<int*>(smem + L.nbr);
  float* qs = reinterpret_cast<float*>(smem + L.qs);

  const int b = blockIdx.y;
  const int m0 = blockIdx.x * p.TM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* Xg = p.xyz + (size_t)b * p.N * 3;
  const float* F = p.feats + (size_t)b * p.N * p.C;
  const int K = p.K;
  const int Kp = round16(K);
  const int R = p.TM * Kp;

  // 0. the cloud's xyz, in shared memory when it fits
  const float* X = Xg;
  if (p.use_xs) {
    float* xs = reinterpret_cast<float*>(smem + L.xs);
    for (int i = threadIdx.x; i < p.N * 3; i += kThreads) xs[i] = Xg[i];
    X = xs;
    __syncthreads();
  }

  // 1. ball query, one warp per center; a center past M computes on
  //    point 0 and is never written
  for (int c = warp; c < p.TM; c += kWarps) {
    const int m = m0 + c;
    const bool valid = m < p.M;
    const int q = valid ? p.qidx[(size_t)b * p.M + m] : 0;
    const float qx = X[3 * q], qy = X[3 * q + 1], qz = X[3 * q + 2];
    int* nb = nbr + c * K;
    int cnt = 0;
    for (int base = 0; base < p.N && cnt < K; base += 32) {
      const int j = base + lane;
      bool in = false;
      if (j < p.N) {
        const float dx = __fsub_rn(qx, X[3 * j]);
        const float dy = __fsub_rn(qy, X[3 * j + 1]);
        const float dz = __fsub_rn(qz, X[3 * j + 2]);
        const float d2 = __fadd_rn(
            __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
        in = d2 < p.r2;
      }
      const unsigned mask = __ballot_sync(0xffffffffu, in);
      const int rank = cnt + __popc(mask & ((1u << lane) - 1u));
      if (in && rank < K) nb[rank] = j;
      cnt += __popc(mask);
    }
    __syncwarp();
    const int found = cnt < K ? cnt : K;
    const int first = found > 0 ? nb[0] : 0;
    for (int k = found + lane; k < K; k += 32) nb[k] = first;
    __syncwarp();
    if (lane < 3) qs[c * 4 + lane] = X[3 * q + lane];
    if (valid) {
      const size_t bm = (size_t)b * p.M + m;
      if (lane < 3) p.new_xyz[bm * 3 + lane] = X[3 * q + lane];
      for (int cc = lane; cc < p.C; cc += 32)
        p.fi[bm * p.C + cc] = bf16r(F[(size_t)q * p.C + cc]);
      if (p.idx_out)
        for (int k = lane; k < K; k += 32) p.idx_out[bm * K + k] = nb[k];
    }
  }
  __syncthreads();

  // 2. gathered rows [dp || fj] as bf16
  stage_rows(A, nbr, qs, X, F, R, p.Wp, K, p.C, p.relative, p.dp_scale);
  __syncthreads();

  // 3. H = bf16(relu(A . w1 + b1)); 4. max over K of H . w2 + b2
  float* sc = scratch + warp * 256;
  const int tpc = Kp / 16;  // row tiles a center
  const int MT = p.midp / 16;
  const int CT = p.coutp / 16;
  const int g1 = center_group(p.TM, MT);
  const int g2 = center_group(p.TM, CT);
  const int n1 = MT * (p.TM / g1);
  const int n2 = CT * (p.TM / g2);
  for (int u = warp; u < n1; u += kWarps)
    conv1_unit(g1 * tpc, A, p.Wp, p.w1, p.b1, H, p.midp, sc,
               (u / MT) * g1 * tpc, u % MT, lane);
  __syncthreads();
  for (int u = warp; u < n2; u += kWarps)
    conv2_unit(g2 * tpc, p, H, omax, oarg, sc, (u / CT) * g2 * tpc, u % CT,
               lane);
  __syncthreads();

  // 5. out (and the winning slots) for the centers of this tile that exist
  for (int e = threadIdx.x; e < p.TM * p.cout; e += kThreads) {
    const int c = e / p.cout;
    const int col = e - c * p.cout;
    const int m = m0 + c;
    if (m < p.M) {
      const size_t o = ((size_t)b * p.M + m) * p.cout + col;
      p.out[o] = omax[c * p.coutp + col];
      if (p.arg_out) p.arg_out[o] = oarg[c * p.coutp + col];
    }
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs at these sizes without the staged cloud
// (bytes); TM * round16(K) must be at most 128 rows.
long long sa_eval_smem_bytes(int TM, int K, int Wp, int midp, int coutp) {
  return (long long)layout(TM, K, Wp, midp, coutp, 0, 0).total;
}

// xyz (B,N,3) f32, qidx (B,M) i32, feats (B,N,C) f32; w1 (Wp,midp) bf16,
// b1 (midp) f32, w2 (midp,coutp) bf16, b2 (coutp) f32 -- Wp, midp, coutp
// multiples of 16 and zero padded -> new_xyz (B,M,3), fi (B,M,C),
// out (B,M,cout) f32, and when not null the neighbour indices idx_out
// (B,M,K) i32 and each output's first winning slot arg_out (B,M,cout) u8
// (the fused SA under autograd keeps both for its backward). K <= 128.
// Returns cudaError_t.
int sa_eval_launch(const float* xyz, const int* qidx, const float* feats,
                   const void* w1, const float* b1, const void* w2,
                   const float* b2, int B, int N, int M, int C, int K, int TM,
                   int Wp, int midp, int coutp, int cout, float r2,
                   float dp_scale, int relative, float* new_xyz, float* fi,
                   float* out, int* idx_out, unsigned char* arg_out,
                   cudaStream_t stream) {
  if (B <= 0 || N <= 0 || M <= 0 || K <= 0 || TM <= 0 ||
      TM * round16(K) > 128 || Wp % 16 || midp % 16 || coutp % 16 ||
      Wp < C + 3 || cout > coutp)
    return cudaErrorInvalidValue;
  Params p;
  p.xyz = xyz;
  p.qidx = qidx;
  p.feats = feats;
  p.w1 = static_cast<const __nv_bfloat16*>(w1);
  p.b1 = b1;
  p.w2 = static_cast<const __nv_bfloat16*>(w2);
  p.b2 = b2;
  p.N = N;
  p.M = M;
  p.C = C;
  p.K = K;
  p.TM = TM;
  p.Wp = Wp;
  p.midp = midp;
  p.coutp = coutp;
  p.cout = cout;
  p.r2 = r2;
  p.dp_scale = dp_scale;
  p.relative = relative;
  p.use_xs = layout(TM, K, Wp, midp, coutp, N, 1).total <= kSmemLimit;
  p.new_xyz = new_xyz;
  p.fi = fi;
  p.out = out;
  p.idx_out = idx_out;
  p.arg_out = arg_out;
  const size_t smem = layout(TM, K, Wp, midp, coutp, N, p.use_xs).total;
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      sa_eval_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((M + TM - 1) / TM, B);
  sa_eval_kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

const char* apt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
