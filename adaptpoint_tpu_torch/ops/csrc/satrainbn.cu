// Fused train-mode SetAbstraction stage for Hopper (sm_90a): ball group,
// conv, BatchNorm on the batch's own statistics, ReLU, conv, BatchNorm and
// max over the ball, forward and backward, as four passes over the grid.
//
// Replaces the TPU kernel family adaptpoint_tpu/ops/pallas/satrainbn.py
// (sa_trainbn_pallas):
//   sa_trainbn_stats   <- _f1_kernel (call :507): the ball query, then
//                         Sv = sum v and Svv = sum v v^T over every slot
//                         (v = [dp || fj], pad slots included); BN1's
//                         moments follow outside (mu1 = Sv W1 / n,
//                         E[y1^2] = diag(W1^T Svv W1) / n), conv1 never runs.
//   sa_trainbn_fwd     <- _f2_kernel (call :526): y1 = v W1,
//                         h = relu(a1 y1 + nb1), y2 = h W2; sum y2 and
//                         sum y2^2 for BN2; per (b, m, c) the max and the min
//                         of y2 over the ball with their first slots; new_xyz
//                         and fi.
//   sa_trainbn_bwd_w2  <- _bwd_kernel(phase2=False) (call :637): recompute
//                         through y2; BN2's backward in its dense affine form
//                         g_y2 = a2 [slot == k] g + p2 + q2c y2; dW2 = h^T
//                         g_y2; g_h = g_y2 W2^T; BN1's cross-tile sums
//                         sum g_y1' and sum g_y1' xhat1 (g_y1' = g_h where
//                         a1 y1 + nb1 > 0).
//   sa_trainbn_bwd_x   <- _bwd_kernel(phase2=True) (call :657): recompute
//                         through g_y1'; g_y1 = a1 g_y1' + p1 + q1c y1;
//                         dW1 = v^T g_y1; g_v = g_y1 W1^T (dp columns times
//                         f32(1/r) under normalize_dp) added onto each slot's
//                         neighbour row (pad slots and empty balls through
//                         the row they repeat), and g_new - sum_k g_dp and
//                         g_fi onto each center's row.
//
// All arithmetic is f32 (the TPU kernel's bf16 three-way splits only make
// its MXU gathers exact; a load here is exact already). The winners of the
// max-pool are not found again in the backward: the forward writes both the
// max's and the min's first slot, and the backward reads the one the sign
// of BN2's slope selects (ties to the first slot, the port's rule).
//
// Design. The neighbour indices of every (b, m) are found once, by the
// select kernel of the stats pass (one warp per center, the ball-group
// kernel's __ballot_sync scan), and every later pass reads them. Each pass
// is a persistent grid: block g takes tiles g, g + G, ... of TM centers
// (R = TM * K rows), gathers the tile's rows into shared memory k-major
// (channel by channel), and runs the row products out of shared memory:
// the weight is staged 16 rows at a time (the next 16 loaded into
// registers meanwhile), each thread holds a 4 x 4 block
// of outputs in registers and reads two 128-bit words of shared memory for
// every 16 FMAs (f32 on the CUDA cores; TF32 stays off). A sum over rows (Svv, dW2, dW1, the BatchNorm sums) goes into a
// slice of a workspace that block g alone owns, in a fixed thread mapping,
// and a last kernel adds the G slices in order: the results do not depend
// on scheduling. Only the scatter of g_v onto the support points uses
// atomics (not bit-reproducible; held within the reordering bound).
//
// What bounds it on the H100: operations. At PointNeXt-S's four B=32
// stages the passes take 16.9 (stats), 48.7 (forward), 113 and 114 GFLOP
// (the backward passes recompute through y2), 4.4 ms at the f32 peak of
// 67 TFLOP/s; the bytes are a few MB a stage. The products run on the CUDA
// cores at a fraction of that peak (one block of 8 warps an SM at the wide
// stages, where a tile's activations fill shared memory); wgmma on bf16
// splits would be the way to the tensor cores.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;     // output columns of one chunk
constexpr int kKC = 16;        // weight rows staged in shared memory at once
constexpr int kMaxRows = 128;  // R = TM * K at most
constexpr size_t kSmemLimit = 232448;

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
// The leading dimension of a tile buffer: buffers are k-major, element
// (row r, channel c) at [c * LD + r]. LD = 4 * odd keeps the 128-bit reads
// of gram_acc free of bank conflicts, and LD >= 64 + 4 lets gemm_rows read
// a whole 64-row block of any channel.
__host__ __device__ inline int tile_ld(int rows) {
  const int ld = imax(round4(rows), 64) + 4;
  return (ld / 4) % 2 ? ld : ld + 4;
}

struct Geo {
  const float* xyz;    // (B, N, 3)
  const int* qidx;     // (B, M)
  const float* feats;  // (B, N, C)
  const int* idx;      // (B, M, K)
  int B, N, M, C, K, W;
  float dp_scale;
  int relative;
};

// Rows of centers [c0, c0 + nc) into Vs (k-major, ld): row r is slot r % K
// of center c0 + r / K, v = [dp || fj] exactly as the plain ball group
// computes it.
__device__ void gather_rows(const Geo& g, long long c0, int nc, float* Vs,
                            int ld) {
  const int R = nc * g.K;
  for (int e = threadIdx.x; e < R * g.W; e += kThreads) {
    const int r = e / g.W, c = e % g.W;
    const long long center = c0 + r / g.K;
    const int b = (int)(center / g.M);
    const int j = g.idx[center * g.K + r % g.K];
    float v;
    if (c < 3) {
      v = g.xyz[((size_t)b * g.N + j) * 3 + c];
      if (g.relative) {
        const int q = g.qidx[center];
        v = __fmul_rn(__fsub_rn(v, g.xyz[((size_t)b * g.N + q) * 3 + c]),
                      g.dp_scale);
      }
    } else {
      v = g.feats[((size_t)b * g.N + j) * g.C + (c - 3)];
    }
    Vs[c * ld + r] = v;
  }
}

// out(r, col) = sum_kd A[kd][r] * Bm[kd][col] for r < R and the columns
// [col0, col0 + ncol), kd in order; epi(r, col, value) gets the global
// column. A k-major in shared memory (lda = tile_ld), Bm row-major in
// device memory, staged kKC rows at a time through Bs (kKC x 64 floats),
// the next rows loaded into registers while the current ones are used.
// Each thread holds a 4 x 4 block (rows 4 tr.., columns 4 tc..): two
// 128-bit shared loads a step of kd. Every thread of the block must call it.
template <class Epi>
__device__ void gemm_rows(const float* A, int lda, int R, int Kd,
                          const float* __restrict__ Bm, int ldb, int col0,
                          int ncol, float* Bs, Epi epi) {
  static_assert(kKC * 64 == 4 * kThreads, "each thread stages 4 values");
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
  for (int cb = 0; cb < ncol; cb += 64) {
    const int nw = imin(64, ncol - cb);
    for (int rb = 0; rb < R; rb += 64) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      const float* a_base = A + rb + 4 * tr;
      float next[4];
      auto fetch = [&](int k0) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int e = threadIdx.x + q * kThreads;
          const int kk = e >> 6, cc = e & 63;
          next[q] = (k0 + kk < Kd && cc < nw)
                        ? __ldg(Bm + (size_t)(k0 + kk) * ldb + col0 + cb + cc)
                        : 0.f;
        }
      };
      fetch(0);
      for (int k0 = 0; k0 < Kd; k0 += kKC) {
        __syncthreads();  // the previous rows are read
#pragma unroll
        for (int q = 0; q < 4; ++q) Bs[threadIdx.x + q * kThreads] = next[q];
        __syncthreads();
        if (k0 + kKC < Kd) fetch(k0 + kKC);
        const int kc = imin(kKC, Kd - k0);
        for (int kk = 0; kk < kc; ++kk) {
          const float4 a4 =
              *reinterpret_cast<const float4*>(a_base + (size_t)(k0 + kk) * lda);
          const float4 b4 =
              *reinterpret_cast<const float4*>(Bs + kk * 64 + 4 * tc);
          const float a[4] = {a4.x, a4.y, a4.z, a4.w};
          const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = rb + 4 * tr + i, c = 4 * tc + j;
          if (r < R && c < nw) epi(r, col0 + cb + c, acc[i][j]);
        }
    }
  }
}

// out[a][b] += sum_{r < R} A[a][r] * Bs[b][r] for a < Ma, b < Nb, r in
// order within each group of 4 rows. A and Bs k-major in shared memory
// (lda, ldb = tile_ld); out in device memory (ldo), owned by this block,
// each element by one thread. Thread tile t = (ta0, tb0) takes a = ta0 +
// TA i, b = tb0 + TB j (i, j < 4; TA, TB the tile counts): neighbouring
// threads read neighbouring rows of Bs, free of bank conflicts at LD = 4 *
// odd, and write neighbouring entries of out.
__device__ void gram_acc(const float* A, int lda, int Ma, const float* Bs,
                         int ldb, int Nb, int R, float* out, int ldo) {
  const int TA = (Ma + 3) / 4, TB = (Nb + 3) / 4;
  const int R4 = R & ~3;
  for (int t = threadIdx.x; t < TA * TB; t += kThreads) {
    const int ta0 = t / TB, tb0 = t % TB;
    const float* arow[4];
    const float* brow[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      arow[i] = A + (size_t)imin(ta0 + TA * i, Ma - 1) * lda;
      brow[i] = Bs + (size_t)imin(tb0 + TB * i, Nb - 1) * ldb;
    }
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int r = 0; r < R4; r += 4) {
      float4 av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = *reinterpret_cast<const float4*>(arow[i] + r);
        bv[i] = *reinterpret_cast<const float4*>(brow[i] + r);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x = acc[i][j];
          x = __fmaf_rn(av[i].x, bv[j].x, x);
          x = __fmaf_rn(av[i].y, bv[j].y, x);
          x = __fmaf_rn(av[i].z, bv[j].z, x);
          acc[i][j] = __fmaf_rn(av[i].w, bv[j].w, x);
        }
    }
    for (int r = R4; r < R; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = __fmaf_rn(arow[i][r], brow[j][r], acc[i][j]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int a = ta0 + TA * i, b = tb0 + TB * j;
        if (a < Ma && b < Nb) out[(size_t)a * ldo + b] += acc[i][j];
      }
  }
}

__device__ void zero_slice(float* p, long long E) {
  for (long long e = threadIdx.x; e < E; e += kThreads) p[e] = 0.f;
  __syncthreads();
}

__device__ __forceinline__ float bn_relu(float y, float a, float nb) {
  return fmaxf(__fadd_rn(__fmul_rn(y, a), nb), 0.f);
}

// ---- the ball query: one warp per center (ballgroup.cu's scan) ----------
__global__ void __launch_bounds__(kThreads)
select_kernel(const float* __restrict__ xyz, const int* __restrict__ qidx,
              int B, int N, int M, int K, float r2, int* __restrict__ idx) {
  extern __shared__ int snbr[];  // kWarps x K
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long gc = (long long)blockIdx.x * kWarps + warp;
  if (gc >= (long long)B * M) return;  // whole warp; the block never syncs
  const int b = (int)(gc / M);
  int* nbr = snbr + warp * K;
  const float* X = xyz + (size_t)b * N * 3;
  const int q = qidx[gc];
  const float qx = X[3 * q], qy = X[3 * q + 1], qz = X[3 * q + 2];
  int cnt = 0;
  for (int base = 0; base < N && cnt < K; base += 32) {
    const int j = base + lane;
    bool in = false;
    if (j < N) {
      const float dx = __fsub_rn(qx, X[3 * j]);
      const float dy = __fsub_rn(qy, X[3 * j + 1]);
      const float dz = __fsub_rn(qz, X[3 * j + 2]);
      const float d2 = __fadd_rn(
          __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
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
  for (int k = lane; k < K; k += 32) idx[gc * K + k] = nbr[k];
}

// ---- pass 1: Sv and Svv (workspace slice [W + W*W]) ---------------------
__global__ void __launch_bounds__(kThreads)
stats_kernel(Geo g, int TM, long long tiles, float* __restrict__ part) {
  extern __shared__ float4 smem4[];
  float* Vs = reinterpret_cast<float*>(smem4);
  const int W = g.W, ld = tile_ld(TM * g.K);
  const long long E = (long long)W + (long long)W * W;
  float* mine = part + blockIdx.x * E;
  zero_slice(mine, E);
  const long long centers = (long long)g.B * g.M;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long c0 = t * TM;
    const int nc = (int)(centers - c0 < TM ? centers - c0 : TM);
    const int R = nc * g.K;
    gather_rows(g, c0, nc, Vs, ld);
    __syncthreads();
    for (int c = threadIdx.x; c < W; c += kThreads) {
      float s = 0.f;
      for (int r = 0; r < R; ++r) s = __fadd_rn(s, Vs[c * ld + r]);
      mine[c] += s;
    }
    gram_acc(Vs, ld, W, Vs, ld, W, R, mine + W, W);
    __syncthreads();
  }
}

// ---- pass 2: the forward (workspace slice [2 * cout]: sum y2, sum y2^2) --
__global__ void __launch_bounds__(kThreads)
fwd_kernel(Geo g, int TM, long long tiles, const float* __restrict__ w1,
           const float* __restrict__ a1, const float* __restrict__ nb1,
           const float* __restrict__ w2, int mid, int cout,
           float* __restrict__ new_xyz, float* __restrict__ fi,
           float* __restrict__ ymax, float* __restrict__ ymin,
           uint8_t* __restrict__ amax, uint8_t* __restrict__ amin,
           float* __restrict__ part) {
  extern __shared__ float4 smem4[];
  const int W = g.W, K = g.K, ld = tile_ld(TM * K);
  float* Vs = reinterpret_cast<float*>(smem4);
  float* Hs = Vs + W * ld;
  float* Ds = Hs + mid * ld;
  float* Bs = Ds + kChunk * ld;
  float* mine = part + (long long)blockIdx.x * 2 * cout;
  zero_slice(mine, 2LL * cout);
  const long long centers = (long long)g.B * g.M;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long c0 = t * TM;
    const int nc = (int)(centers - c0 < TM ? centers - c0 : TM);
    const int R = nc * K;
    gather_rows(g, c0, nc, Vs, ld);
    for (int e = threadIdx.x; e < nc * 3; e += kThreads) {
      const long long center = c0 + e / 3;
      const int b = (int)(center / g.M), q = g.qidx[center];
      new_xyz[center * 3 + e % 3] = g.xyz[((size_t)b * g.N + q) * 3 + e % 3];
    }
    for (int e = threadIdx.x; e < nc * g.C; e += kThreads) {
      const long long center = c0 + e / g.C;
      const int b = (int)(center / g.M), q = g.qidx[center];
      fi[center * g.C + e % g.C] =
          g.feats[((size_t)b * g.N + q) * g.C + e % g.C];
    }
    gemm_rows(Vs, ld, R, W, w1, mid, 0, mid, Bs, [&](int r, int j, float y) {
      Hs[j * ld + r] = bn_relu(y, a1[j], nb1[j]);
    });
    for (int col0 = 0; col0 < cout; col0 += kChunk) {
      const int nw = imin(kChunk, cout - col0);
      gemm_rows(Hs, ld, R, mid, w2, cout, col0, nw, Bs,
                [&](int r, int c, float y) { Ds[(c - col0) * ld + r] = y; });
      __syncthreads();
      for (int p = threadIdx.x; p < nc * nw; p += kThreads) {
        const int i = p / nw, c = p % nw;
        const float* col = Ds + c * ld + i * K;
        float hi = col[0], lo = col[0];
        int khi = 0, klo = 0;
        for (int k = 1; k < K; ++k) {
          const float v = col[k];
          if (v > hi) { hi = v; khi = k; }
          if (v < lo) { lo = v; klo = k; }
        }
        const size_t o = (size_t)(c0 + i) * cout + col0 + c;
        ymax[o] = hi;
        ymin[o] = lo;
        amax[o] = (uint8_t)khi;
        amin[o] = (uint8_t)klo;
      }
      for (int c = threadIdx.x; c < nw; c += kThreads) {
        float s = 0.f, s2 = 0.f;
        for (int r = 0; r < R; ++r) {
          const float v = Ds[c * ld + r];
          s = __fadd_rn(s, v);
          s2 = __fadd_rn(s2, __fmul_rn(v, v));
        }
        mine[col0 + c] += s;
        mine[cout + col0 + c] += s2;
      }
    }
    __syncthreads();
  }
}

struct BwdArgs {
  const float *w1, *a1, *nb1, *w2, *w2t, *w1t;
  const float *mu1, *r1, *a2, *p2, *q2c, *p1, *q1c;
  const uint8_t* slot;  // (B, M, cout)
  const float* gout;    // (B, M, cout)
  const float* g_fi;    // (B, M, C) or null
  const float* g_new;   // (B, M, 3) or null
  float* g_xyz;         // (B, N, 3), zeroed
  float* g_feats;       // (B, N, C), zeroed
  int mid, cout;
};

// ---- passes 3 and 4: the backward ---------------------------------------
// kPhaseX false: workspace slice [mid * cout + 2 * mid] = dW2, sum g_y1',
// sum g_y1' xhat1. kPhaseX true: slice [W * mid] = dW1, and the scatter.
template <bool kPhaseX>
__global__ void __launch_bounds__(kThreads)
bwd_kernel(Geo g, int TM, long long tiles, BwdArgs a, float* __restrict__ part) {
  extern __shared__ float4 smem4[];
  const int W = g.W, K = g.K, mid = a.mid, cout = a.cout;
  const int ld = tile_ld(TM * K);
  float* Ps = reinterpret_cast<float*>(smem4);  // v, then g_h
  float* Ys = Ps + imax(W, mid) * ld;           // y1
  float* Hs = Ys + mid * ld;                    // h, then g_y1 (phase X)
  float* Ds = Hs + mid * ld;                    // a chunk of g_y2 or g_v
  float* Bs = Ds + kChunk * ld;                 // staged weight rows
  const long long E = kPhaseX ? (long long)W * mid
                              : (long long)mid * cout + 2LL * mid;
  float* mine = part + blockIdx.x * E;
  zero_slice(mine, E);
  const long long centers = (long long)g.B * g.M;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long c0 = t * TM;
    const int nc = (int)(centers - c0 < TM ? centers - c0 : TM);
    const int R = nc * K;
    gather_rows(g, c0, nc, Ps, ld);
    gemm_rows(Ps, ld, R, W, a.w1, mid, 0, mid, Bs, [&](int r, int j, float y) {
      Ys[j * ld + r] = y;
      Hs[j * ld + r] = bn_relu(y, a.a1[j], a.nb1[j]);
    });
    __syncthreads();
    for (int e = threadIdx.x; e < R * mid; e += kThreads)
      Ps[(e / R) * ld + e % R] = 0.f;
    for (int col0 = 0; col0 < cout; col0 += kChunk) {
      const int nw = imin(kChunk, cout - col0);
      gemm_rows(Hs, ld, R, mid, a.w2, cout, col0, nw, Bs,
                [&](int r, int c, float y) {
                  const size_t o = (size_t)(c0 + r / K) * cout + c;
                  const float gs = a.slot[o] == r % K ? a.gout[o] : 0.f;
                  Ds[(c - col0) * ld + r] = __fadd_rn(
                      __fadd_rn(__fmul_rn(a.a2[c], gs), a.p2[c]),
                      __fmul_rn(a.q2c[c], y));
                });
      __syncthreads();
      if (!kPhaseX) gram_acc(Hs, ld, mid, Ds, ld, nw, R, mine + col0, cout);
      gemm_rows(Ds, ld, R, nw, a.w2t + (size_t)col0 * mid, mid, 0, mid, Bs,
                [&](int r, int j, float v) { Ps[j * ld + r] += v; });
    }
    __syncthreads();
    if (!kPhaseX) {
      float* sums = mine + (long long)mid * cout;
      for (int j = threadIdx.x; j < mid; j += kThreads) {
        float s = 0.f, sx = 0.f;
        for (int r = 0; r < R; ++r) {
          const float y = Ys[j * ld + r];
          const float yp = __fadd_rn(__fmul_rn(y, a.a1[j]), a.nb1[j]);
          const float gp = yp > 0.f ? Ps[j * ld + r] : 0.f;
          s = __fadd_rn(s, gp);
          sx = __fadd_rn(sx, __fmul_rn(gp, __fmul_rn(__fsub_rn(y, a.mu1[j]),
                                                     a.r1[j])));
        }
        sums[j] += s;
        sums[mid + j] += sx;
      }
      __syncthreads();
      continue;
    }
    for (int e = threadIdx.x; e < R * mid; e += kThreads) {
      const int j = e / R, r = e % R;
      const float y = Ys[j * ld + r];
      const float yp = __fadd_rn(__fmul_rn(y, a.a1[j]), a.nb1[j]);
      const float gp = yp > 0.f ? Ps[j * ld + r] : 0.f;
      Hs[j * ld + r] = __fadd_rn(__fadd_rn(__fmul_rn(a.a1[j], gp), a.p1[j]),
                                 __fmul_rn(a.q1c[j], y));
    }
    __syncthreads();
    gather_rows(g, c0, nc, Ps, ld);
    __syncthreads();
    gram_acc(Ps, ld, W, Hs, ld, mid, R, mine, mid);
    for (int col0 = 0; col0 < W; col0 += kChunk) {
      const int nw = imin(kChunk, W - col0);
      gemm_rows(Hs, ld, R, mid, a.w1t, W, col0, nw, Bs,
                [&](int r, int c, float v) {
                  Ds[(c - col0) * ld + r] = c < 3 ? __fmul_rn(v, g.dp_scale) : v;
                });
      __syncthreads();
      for (int e = threadIdx.x; e < R * nw; e += kThreads) {
        const int r = e / nw, c = col0 + e % nw;
        const long long center = c0 + r / K;
        const int b = (int)(center / g.M);
        const int j = g.idx[center * K + r % K];
        const float v = Ds[(c - col0) * ld + r];
        if (c < 3)
          atomicAdd(a.g_xyz + ((size_t)b * g.N + j) * 3 + c, v);
        else
          atomicAdd(a.g_feats + ((size_t)b * g.N + j) * g.C + (c - 3), v);
      }
      if (col0 == 0) {
        for (int e = threadIdx.x; e < nc * 3; e += kThreads) {
          const int i = e / 3, c = e % 3;
          const long long center = c0 + i;
          const int b = (int)(center / g.M), q = g.qidx[center];
          float s = a.g_new != nullptr ? a.g_new[center * 3 + c] : 0.f;
          if (g.relative) {
            float d = 0.f;
            for (int k = 0; k < K; ++k)
              d = __fadd_rn(d, Ds[c * ld + i * K + k]);
            s = __fsub_rn(s, d);
          }
          atomicAdd(a.g_xyz + ((size_t)b * g.N + q) * 3 + c, s);
        }
      }
    }
    if (a.g_fi != nullptr) {
      for (int e = threadIdx.x; e < nc * g.C; e += kThreads) {
        const long long center = c0 + e / g.C;
        const int b = (int)(center / g.M), q = g.qidx[center];
        atomicAdd(a.g_feats + ((size_t)b * g.N + q) * g.C + e % g.C,
                  a.g_fi[center * g.C + e % g.C]);
      }
    }
    __syncthreads();
  }
}

// out[e] = sum_g part[g * E + e], g in order.
__global__ void reduce_kernel(const float* __restrict__ part, int G,
                              long long E, float* __restrict__ out) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < E;
       e += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int i = 0; i < G; ++i) s = __fadd_rn(s, part[(long long)i * E + e]);
    out[e] = s;
  }
}

cudaError_t reduce(const float* part, int G, long long E, float* out,
                   cudaStream_t stream) {
  const int blocks = (int)imin((int)((E + 255) / 256), 4096);
  reduce_kernel<<<blocks, 256, 0, stream>>>(part, G, E, out);
  return cudaGetLastError();
}

// kind 0 stats, 1 forward, 2 backward (both phases)
size_t smem_bytes(int kind, int TM, int K, int W, int mid) {
  const size_t ld = tile_ld(TM * K);
  const size_t staged = (size_t)kKC * 64;
  if (kind == 0) return (size_t)W * ld * 4;
  if (kind == 1) return ((W + mid + kChunk) * ld + staged) * 4;
  return ((imax(W, mid) + 2 * mid + kChunk) * ld + staged) * 4;
}

const void* kernel_of(int kind, int phase_x) {
  if (kind == 0) return (const void*)stats_kernel;
  if (kind == 1) return (const void*)fwd_kernel;
  return phase_x ? (const void*)bwd_kernel<true> : (const void*)bwd_kernel<false>;
}

Geo make_geo(const float* xyz, const int* qidx, const float* feats,
             const int* idx, int B, int N, int M, int C, int K,
             float dp_scale, int relative) {
  Geo g;
  g.xyz = xyz; g.qidx = qidx; g.feats = feats; g.idx = idx;
  g.B = B; g.N = N; g.M = M; g.C = C; g.K = K; g.W = C + 3;
  g.dp_scale = dp_scale; g.relative = relative;
  return g;
}

}  // namespace

extern "C" {

// The tile (TM centers a block) and the grid (G blocks) a pass runs with at
// these shapes: kind 0 stats, 1 forward, 2 backward w2, 3 backward x. The
// caller sizes the workspace G * E floats from them. Returns cudaError_t.
int sa_trainbn_plan(int kind, int B, int M, int K, int C, int mid, int* tm,
                    int* grid) {
  if (B <= 0 || M <= 0 || K <= 0 || K > 255 || C < 0 || mid <= 0 ||
      kind < 0 || kind > 3)
    return cudaErrorInvalidValue;
  const int W = C + 3;
  const int skind = kind > 2 ? 2 : kind;
  int t = 8;
  while (t > 1 && (t * K > kMaxRows || smem_bytes(skind, t, K, W, mid) > kSmemLimit))
    t /= 2;
  const size_t smem = smem_bytes(skind, t, K, W, mid);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  const void* fn = kernel_of(skind, kind == 3);
  // the most any shape asks: a later plan for smaller tiles must not lower
  // what an earlier shape's launches need
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemLimit);
  if (e != cudaSuccess) return e;
  int per_sm = 0, dev = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, smem);
  if (e != cudaSuccess) return e;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long long tiles = ((long long)B * M + t - 1) / t;
  long long gsz = (long long)imax(per_sm, 1) * sms;
  if (gsz > tiles) gsz = tiles;
  *tm = t;
  *grid = (int)gsz;
  return cudaSuccess;
}

// Pass 1. xyz (B,N,3), qidx (B,M) i32, feats (B,N,C) f32 contiguous ->
// idx (B,M,K) i32 and out [W + W*W] = (Sv, Svv row-major); part is the
// workspace of G * (W + W*W) floats.
int sa_trainbn_stats_launch(const float* xyz, const int* qidx,
                            const float* feats, int B, int N, int M, int C,
                            int K, float r2, float dp_scale, int relative,
                            int TM, int G, int* idx, float* part, float* out,
                            cudaStream_t stream) {
  const size_t ssel = (size_t)kWarps * K * sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(
      select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ssel);
  if (e != cudaSuccess) return e;
  const long long centers = (long long)B * M;
  select_kernel<<<(int)((centers + kWarps - 1) / kWarps), kThreads, ssel,
                  stream>>>(xyz, qidx, B, N, M, K, r2, idx);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const Geo g = make_geo(xyz, qidx, feats, idx, B, N, M, C, K, dp_scale,
                         relative);
  const long long tiles = (centers + TM - 1) / TM;
  stats_kernel<<<G, kThreads, smem_bytes(0, TM, K, g.W, 1), stream>>>(
      g, TM, tiles, part);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return reduce(part, G, (long long)g.W + (long long)g.W * g.W, out, stream);
}

// Pass 2. w1 (W, mid), a1, nb1 (mid), w2 (mid, cout) f32 -> new_xyz
// (B,M,3), fi (B,M,C), ymax, ymin (B,M,cout) f32, amax, amin (B,M,cout) u8,
// out [2 * cout] = (sum y2, sum y2^2); part: G * 2 * cout floats.
int sa_trainbn_fwd_launch(const float* xyz, const int* qidx,
                          const float* feats, const int* idx, int B, int N,
                          int M, int C, int K, float dp_scale, int relative,
                          const float* w1, const float* a1, const float* nb1,
                          const float* w2, int mid, int cout, int TM, int G,
                          float* new_xyz, float* fi, float* ymax, float* ymin,
                          uint8_t* amax, uint8_t* amin, float* part,
                          float* out, cudaStream_t stream) {
  const Geo g = make_geo(xyz, qidx, feats, idx, B, N, M, C, K, dp_scale,
                         relative);
  const long long tiles = ((long long)B * M + TM - 1) / TM;
  fwd_kernel<<<G, kThreads, smem_bytes(1, TM, K, g.W, mid), stream>>>(
      g, TM, tiles, w1, a1, nb1, w2, mid, cout, new_xyz, fi, ymax, ymin,
      amax, amin, part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return reduce(part, G, 2LL * cout, out, stream);
}

// Passes 3 (phase_x 0) and 4 (phase_x 1). w2t (cout, mid) and w1t (mid, W)
// are the transposed weights; per-channel rows mu1, r1, a1, nb1, p1, q1c
// (mid) and a2, p2, q2c (cout); slot (B,M,cout) u8 the winning slot, gout
// (B,M,cout) the pooled cotangent. Phase 3: out [mid*cout + 2*mid] = (dW2,
// sum g_y1', sum g_y1' xhat1), workspace G * that; p1, q1c may be null.
// Phase 4: g_xyz (B,N,3) and g_feats (B,N,C) are overwritten, out [W*mid]
// = dW1; mu1, r1, g_fi (B,M,C) and g_new (B,M,3) may be null.
int sa_trainbn_bwd_launch(int phase_x, const float* xyz, const int* qidx,
                          const float* feats, const int* idx, int B, int N,
                          int M, int C, int K, float dp_scale, int relative,
                          const float* w1, const float* a1, const float* nb1,
                          const float* w2, const float* w2t, const float* w1t,
                          int mid, int cout, const float* mu1,
                          const float* r1, const float* a2, const float* p2,
                          const float* q2c, const float* p1, const float* q1c,
                          const uint8_t* slot, const float* gout,
                          const float* g_fi, const float* g_new, int TM,
                          int G, float* g_xyz, float* g_feats, float* part,
                          float* out, cudaStream_t stream) {
  const Geo g = make_geo(xyz, qidx, feats, idx, B, N, M, C, K, dp_scale,
                         relative);
  BwdArgs a;
  a.w1 = w1; a.a1 = a1; a.nb1 = nb1; a.w2 = w2; a.w2t = w2t; a.w1t = w1t;
  a.mu1 = mu1; a.r1 = r1; a.a2 = a2; a.p2 = p2; a.q2c = q2c; a.p1 = p1;
  a.q1c = q1c; a.slot = slot; a.gout = gout; a.g_fi = g_fi; a.g_new = g_new;
  a.g_xyz = g_xyz; a.g_feats = g_feats; a.mid = mid; a.cout = cout;
  const long long tiles = ((long long)B * M + TM - 1) / TM;
  const size_t smem = smem_bytes(2, TM, K, g.W, mid);
  cudaError_t e;
  long long E;
  if (phase_x) {
    e = cudaMemsetAsync(g_xyz, 0, (size_t)B * N * 3 * sizeof(float), stream);
    if (e != cudaSuccess) return e;
    e = cudaMemsetAsync(g_feats, 0, (size_t)B * N * C * sizeof(float), stream);
    if (e != cudaSuccess) return e;
    bwd_kernel<true><<<G, kThreads, smem, stream>>>(g, TM, tiles, a, part);
    E = (long long)g.W * mid;
  } else {
    bwd_kernel<false><<<G, kThreads, smem, stream>>>(g, TM, tiles, a, part);
    E = (long long)mid * cout + 2LL * mid;
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return reduce(part, G, E, out, stream);
}

const char* apt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
