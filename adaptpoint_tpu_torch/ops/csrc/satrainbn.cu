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
//                         and fi; and the ReLU's mask, a bit a (row, channel).
//   sa_trainbn_bwd_w2  <- _bwd_kernel(phase2=False) (call :637): recompute
//                         y1, take h = a1 y1 + nb1 where the forward's mask
//                         is set (else 0), y2 = h W2; BN2's backward in its
//                         dense affine form g_y2 = a2 [slot == k] g + p2 +
//                         q2c y2; dW2 = h^T g_y2; g_h = g_y2 W2^T; g_y1' =
//                         g_h under the mask; BN1's cross-tile sums sum g_y1'
//                         and sum g_y1' xhat1. It hands y1 and g_y1' (n x
//                         mid f32 each) to the next pass.
//   sa_trainbn_bwd_x   <- _bwd_kernel(phase2=True) (call :657): from the
//                         handed-over y1 and g_y1', g_y1 = a1 g_y1' + p1 +
//                         q1c y1; dW1 = v^T g_y1; g_v = g_y1 W1^T (dp columns
//                         times f32(1/r) under normalize_dp) added onto each
//                         slot's neighbour row (pad slots and empty balls
//                         through the row they repeat), and g_new - sum_k
//                         g_dp and g_fi onto each center's row.
//
// Stats and forward: all arithmetic f32 on the CUDA cores (the TPU kernel's
// bf16 three-way splits only make its MXU gathers exact; a load here is
// exact already). The winners of the max-pool are not found again in the
// backward: the forward writes both the max's and the min's first slot, and
// the backward reads the one the sign of BN2's slope selects (ties to the
// first slot, the port's rule). Nor is the ReLU's mask: the backward
// computes y1 in another order (below), so it takes the forward's bits.
//
// Design of the stats and forward passes. The neighbour indices of every
// (b, m) are found once, by the select kernel of the stats pass (one warp
// per center, the ball-group kernel's __ballot_sync scan), and every later
// pass reads them. Each pass is a persistent grid: block g takes tiles g,
// g + G, ... of TM centers (R = TM * K rows), gathers the tile's rows into
// shared memory k-major (channel by channel), and runs the row products out
// of shared memory: the weight is staged 16 rows at a time, each thread
// holds a 4 x 4 block of outputs in registers (f32 FMA). A sum over rows
// (Svv, the BatchNorm sums) goes into a slice of a workspace that block g
// alone owns, in a fixed thread mapping, and a last kernel adds the G slices
// in order: the results do not depend on scheduling.
//
// Design of the backward passes. The products run on the tensor cores as
// 3xTF32: each f32 operand is split x = hi + lo, hi its round to TF32 (10
// mantissa bits, to nearest, ties away) and lo = x - hi (exact), of which
// mma.sync.m16n8k8.tf32 reads the TF32 part, and lo.hi + hi.lo + hi.hi go
// into f32 accumulators: f32-grade products (the dropped lo.lo and lo's
// truncation are each under 2^-21 of |a b|), as the TPU kernel's f32
// products on its MXU ("parity ~1e-5", satrainbn.py:60-64). A block of 8
// warps owns RT = 32 NT rows (the instance NT = 4, 2 or 1: 128 rows, or 64
// or 32 where the tile's rows do not fit shared memory; 64 at PointNeXt-S's
// widest stage in the second and third kernels) of B*M*K, whatever K is
// (a tile may split a ball). Rows are row-major in shared memory with a
// stride of 8 or 24 mod 32 floats: a lane's two k of a fragment are one
// conflict-free float2 (each k8 step takes its k in the order 2t, 2t + 1 in
// both operands), and the transposed reads of the row sums (dW1, dW2: X^T Y
// over the tile's rows) are conflict-free scalar loads. Weights stream 64
// output columns by 64 k at a time through a ring of 2-6 cp.async stages
// (as deep as shared memory allows beside one or two blocks an SM), from
// copies padded to multiples of 8 (weight_rows_kernel). A product gives each
// warp a 32 x 8 NT tile of a 64-column chunk and loads all of a k8 step's
// fragments before its 6 NT mma, issued as three sweeps (lo.hi, hi.lo,
// hi.hi) over the warp's accumulators so that no mma waits on the one
// before; a row sum gives each warp a 32 x 32 block of 128 x 64 outputs, or
// a share of the rows where the output has few rows. Row sums go out as
// 16-byte L2 reductions (REDG.F32x4) into one of 8 copies of dW1 / dW2 (by
// block), summed in order after the kernel: per-block slices read back and
// rewritten every tile moved ~1 GB a pass at stage 4.
//   bwd_w2 is two kernels: the first recomputes y1 (to device memory), then
//   h in shared memory over the gathered rows, and per 64 output channels
//   y2, g_y2 (kept beside it and written to device memory) and its dW2
//   block; the second reads g_y2 back a tile at a time, computes g_h per 64
//   hidden channels, masks it, writes g_y1' and sums the BatchNorm terms
//   (block slices added in order). Splitting there keeps no (RT x mid) g_h
//   accumulator live across the cout loop: the g_y2 round trip (n x cout
//   f32) costs less than the smaller tiles or register spills that needs.
//   bwd_x reads y1 and g_y1' (recomputing y1 from the gathered rows gives
//   the same bits but timed slower) and writes nothing per row but the
//   scatter of g_v: a warp takes one center's run of rows in the tile and a
//   slice of channels, merges each run of equal neighbour index (a partial
//   ball's pad slots) in registers and adds it with 16-byte L2 reductions
//   where C % 4 == 0 and C > 32, else one reduction a channel, as the
//   ball-group backward (ballgroup_bwd.cu) does, after the two memsets.
//   A tile's neighbour indices, centers and slots are loaded a tile ahead,
//   its features by cp.async; g_y2's sparse term reads the tile's winning
//   slots and pooled cotangents staged in shared memory.
// The L2 reductions (dW1, dW2, the scatter) land in no fixed order: not
// bit-reproducible, held within the reordering bound.
//
// What bounds it on the H100: operations. The backward passes do 113.1 and
// 33.0 GFLOP at PointNeXt-S's four B=32 stages; as 3xTF32 that is 3x the
// work at the dense TF32 rate of 495 TFLOP/s, 0.686 and 0.200 ms. Their
// bytes (the rows and weights read once, y1 and g_y1' written once and read
// once, the gradients) are 0.59 GB a pass, 0.18 ms at 3.35 TB/s. The stats
// and forward passes run f32 FMAs on the CUDA cores.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sa_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;     // output columns of one chunk
constexpr int kKC = 16;        // weight rows staged in shared memory at once
constexpr int kMaxRows = 128;  // R = TM * K at most
constexpr size_t kSmemLimit = 232448;

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }
__host__ __device__ inline int round8(int x) { return (x + 7) & ~7; }
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
// mask: (ceil(mid / 32), B*M*K) words, bit j % 32 of word (j / 32, row) set
// where the ReLU passed (h > 0).
__global__ void __launch_bounds__(kThreads)
fwd_kernel(Geo g, int TM, long long tiles, const float* __restrict__ w1,
           const float* __restrict__ a1, const float* __restrict__ nb1,
           const float* __restrict__ w2, int mid, int cout,
           float* __restrict__ new_xyz, float* __restrict__ fi,
           float* __restrict__ ymax, float* __restrict__ ymin,
           uint8_t* __restrict__ amax, uint8_t* __restrict__ amin,
           uint32_t* __restrict__ mask, float* __restrict__ part) {
  extern __shared__ float4 smem4[];
  const int W = g.W, K = g.K, ld = tile_ld(TM * K);
  float* Vs = reinterpret_cast<float*>(smem4);
  float* Hs = Vs + W * ld;
  float* Ds = Hs + mid * ld;
  float* Bs = Ds + kChunk * ld;
  float* mine = part + (long long)blockIdx.x * 2 * cout;
  zero_slice(mine, 2LL * cout);
  const long long centers = (long long)g.B * g.M;
  const long long n = centers * K;
  const int nwords = (mid + 31) / 32;
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
    __syncthreads();
    for (int e = threadIdx.x; e < nwords * R; e += kThreads) {
      const int wd = e / R, r = e % R;
      uint32_t bits = 0;
      for (int b = 0; b < 32 && 32 * wd + b < mid; ++b)
        bits |= (Hs[(32 * wd + b) * ld + r] > 0.f ? 1u : 0u) << b;
      mask[(size_t)wd * n + c0 * K + r] = bits;
    }
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

// ---- passes 3 and 4: the backward, 3xTF32 on the tensor cores ------------
constexpr int kNC = 64;                 // output columns of a product pass
constexpr int kKR = 64;                 // k of one weight ring stage
constexpr int kLdR = kKR + 8;           // its row stride (8 mod 32)
constexpr int kStageFloats = kNC * kLdR;
constexpr int kMaxRing = 6;             // ring stages at most
constexpr int kLdD = kNC + 8;           // stride of a 64-column chunk buffer
constexpr int kSumFloats = 4 * kNC * 2;  // the BatchNorm sums' cross-warp step
constexpr int kCopies = 8;              // copies of dW1, dW2 the blocks add to
constexpr int kIdxInts = 4 * 128;       // a tile's rows: neighbour, center,
                                        // slot, query
// Centers whose rows a tile of RT rows can hold (at most).
__host__ __device__ inline int centers_spanned(int RT, int K) {
  return imin(RT, (RT + K - 1) / K + 1);
}

// floats past the last buffer: a row-sum pass may read up to 127 columns
// past a row's end, whose products it drops
constexpr int kSlack = 256;

// A row stride for the row-major tile buffers: a multiple of 8 that is 8 or
// 24 mod 32 (both keep a warp's float2 fragment loads, rows g and columns 2t,
// and its transposed scalar loads, rows t and columns g, on distinct banks).
__host__ __device__ inline int ld_rm(int cols) {
  const int x = round8(cols);
  return (x & 8) ? x : x + 8;
}

// TF32 (10 mantissa bits) of x, to nearest with ties away from zero, as f32
// bits; x - hi is then exact in f32.
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo exactly; the product reads lo's top 19 bits (its tf32 part,
// truncated), so lo's own error is under 2^-10 |lo| <= 2^-21 |x|.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_bits(x);
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));
}

struct FragA { uint32_t hi[4], lo[4]; };  // m16 x k8
struct FragB { uint32_t hi[2], lo[2]; };  // k8 x n8

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[i][j] += a[i] b[j] (3xTF32) for i < 2, j < NT, as three sweeps over
// the 2 NT accumulators (lo.hi, hi.lo, hi.hi), so that a product never
// waits on the one just issued.
template <int NT>
__device__ __forceinline__ void mma3_sweeps(float (&acc)[2][4][4],
                                            const FragA (&a)[2],
                                            const FragB (&b)[NT]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], a[i].lo, b[j].hi[0], b[j].hi[1]);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], a[i].hi, b[j].lo[0], b[j].lo[1]);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], a[i].hi, b[j].hi[0], b[j].hi[1]);
}

// A warp's accumulators: 2 m16 tiles by up to 4 n8 tiles, element e of tile
// (i, j) at row 16 i + g + 8 (e >> 1) and column 8 j + 2 t + (e & 1) of the
// warp's block (g = lane / 4, t = lane % 4).
typedef float Acc[2][4][4];

// A product pass's warp block: RT / 32 row warps (wr) by 8 / (RT / 32)
// column warps (wc), each 32 rows by 8 nt = RT / 4 columns.
struct PassWarp {
  int nt, wr, wc, g, t;
  __device__ PassWarp(int RT) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    nt = RT / 32;
    wr = warp % nt;
    wc = warp / nt;
    g = lane >> 2;
    t = lane & 3;
  }
  __device__ int row(int i, int e) const { return wr * 32 + i * 16 + g + 8 * (e >> 1); }
  __device__ int col(int j) const { return wc * 8 * nt + j * 8 + 2 * t; }
};

__device__ __forceinline__ void zero_acc(Acc& acc) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// cp.async.wait_group n for a runtime n < kMaxRing
__device__ __forceinline__ void cp_wait_dyn(int n) {
  switch (n) {
    case 0: apt_sa::cp_wait<0>(); break;
    case 1: apt_sa::cp_wait<1>(); break;
    case 2: apt_sa::cp_wait<2>(); break;
    case 3: apt_sa::cp_wait<3>(); break;
    default: apt_sa::cp_wait<4>(); break;
  }
}

// acc = A B^T over k < Kd for B's rows n0 .. n0 + 63: A (RT rows, Kd a
// multiple of 8 columns) row-major in shared memory (lda), B row-major in
// device memory (nb rows of Kd floats, zero past the weight's k: see
// weight_rows_kernel), staged kKR k at a time through a ring of nring stages
// (rows past nb read as zero). Each k8 step takes the fragments' k in the
// order 2t, 2t + 1 in both operands, so that a lane's two k of a row are
// one conflict-free float2. Element (row, col) of the warp's block is
// output row row, column n0 + col (PassWarp); n8 tiles past nb are skipped.
// Every thread of the block calls it.
template <int NT>
__device__ void product(Acc& acc, const float* A, int lda,
                        const float* __restrict__ Bg, int nb, int n0, int Kd,
                        float* ring, int nring) {
  const PassWarp w(32 * NT);
  zero_acc(acc);
  const int nk = (Kd + kKR - 1) / kKR;
  const bool idle = n0 + w.wc * 8 * NT >= nb;  // no column of this warp's
  __syncthreads();  // the ring's and the operands' last readers are done
  auto issue = [&](int kt) {
    float* st = ring + (kt % nring) * kStageFloats;
    constexpr int kPieces = kKR / 4;  // 16-byte pieces of a row
    for (int q = threadIdx.x; q < kNC * kPieces; q += kThreads) {
      const int n = q / kPieces, f = (q % kPieces) * 4;
      const int k = kt * kKR + f;
      const bool full = n0 + n < nb && k < Kd;
      apt_sa::cp_async16(st + n * kLdR + f,
                         full ? Bg + (size_t)(n0 + n) * Kd + k : Bg, full);
    }
  };
  for (int s = 0; s < nring - 1; ++s) {
    if (s < nk) issue(s);
    apt_sa::cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait_dyn(nring - 2);  // stage kt has landed
    __syncthreads();
    if (kt + nring - 1 < nk) issue(kt + nring - 1);
    apt_sa::cp_commit();
    const float* st = ring + (kt % nring) * kStageFloats;
    const int steps = imin(kKR, Kd - kt * kKR) / 8;
    if (idle) continue;
#pragma unroll
    for (int s = 0; s < kKR / 8; ++s) {
      if (s >= steps) break;
      const int k = s * 8 + 2 * w.t;
      FragA a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float* p = A + (size_t)(w.wr * 32 + i * 16 + w.g) * lda +
                         kt * kKR + k;
        const float2 x0 = *reinterpret_cast<const float2*>(p);
        const float2 x1 = *reinterpret_cast<const float2*>(p + 8 * lda);
        split(x0.x, a[i].hi[0], a[i].lo[0]);
        split(x1.x, a[i].hi[1], a[i].lo[1]);
        split(x0.y, a[i].hi[2], a[i].lo[2]);
        split(x1.y, a[i].hi[3], a[i].lo[3]);
      }
      FragB b[NT];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 y = *reinterpret_cast<const float2*>(
            st + (w.wc * 8 * NT + j * 8 + w.g) * kLdR + k);
        split(y.x, b[j].hi[0], b[j].lo[0]);
        split(y.y, b[j].hi[1], b[j].lo[1]);
      }
      mma3_sweeps<NT>(acc, a, b);
    }
  }
  apt_sa::cp_wait<0>();
}

// A weight as product() reads it: dst row n (n < nrows) holds Kd floats,
// B[n][k] = src[k * nrows + n] (transpose) or src[n * kcols + k], zero for
// k >= kcols (rows 16-byte aligned for the ring's copies).
__global__ void weight_rows_kernel(const float* __restrict__ src, int nrows,
                                   int kcols, int transpose, int Kd,
                                   float* __restrict__ dst) {
  const long long total = (long long)nrows * Kd;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const int n = (int)(e / Kd), k = (int)(e % Kd);
    dst[e] = k >= kcols ? 0.f
             : transpose ? src[(size_t)k * nrows + n]
                         : src[(size_t)n * kcols + k];
  }
}

cudaError_t weight_rows(const float* src, int nrows, int kcols, int transpose,
                        int Kd, float* dst, cudaStream_t stream) {
  const long long total = (long long)nrows * Kd;
  const int blocks = (int)((total + 255) / 256 < 1024 ? (total + 255) / 256
                                                      : 1024);
  weight_rows_kernel<<<blocks, 256, 0, stream>>>(src, nrows, kcols, transpose,
                                                 Kd, dst);
  return cudaGetLastError();
}

// The warp's block of a row-sum pass: X columns mb .., Y columns nb ..
// (32 each), rows k0 .. k1. Four X blocks by two Y blocks; where X has only
// one or two blocks of columns (mx <= 32, 64), the idle warps take a share
// of the rows instead (their partial sums add in the L2 reductions).
struct SumWarp {
  int mb, nb, k0, k1;
  __device__ SumWarp(int mx, int RT) {
    const int warp = threadIdx.x >> 5;
    const int kg = mx <= 32 ? 4 : mx <= 64 ? 2 : 1;  // row groups
    mb = (warp & 3) / kg * 32;
    nb = (warp >> 2) * 32;
    const int part = RT / kg, q = (warp & 3) % kg;
    k0 = q * part;
    k1 = k0 + part;
  }
};

// acc = X^T Y over the rows of the warp's block (SumWarp) for X's columns 0
// .. 127 and Y's 0 .. 63: X, Y row-major in shared memory (ldx, ldy), read
// transposed a float a lane, k in natural order. Element (i, j, e) is output
// (mb + 16 i + g + 8 (e >> 1), nb + 8 j + 2 t + (e & 1)). Warps whose block
// starts past mx or ny skip the work. Rows that hold no slot must be zero in
// one operand.
__device__ void row_sum(Acc& acc, const float* X, int ldx, int mx,
                        const float* Y, int ldy, int ny, int RT) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const SumWarp w(mx, RT);
  zero_acc(acc);
  if (w.mb >= mx || w.nb >= ny) return;
  for (int k0 = w.k0; k0 < w.k1; k0 += 8) {
    const float* x0 = X + (size_t)(k0 + t) * ldx + w.mb + g;
    const float* x4 = x0 + 4 * (size_t)ldx;
    FragA a[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      split(x0[16 * i], a[i].hi[0], a[i].lo[0]);
      split(x0[16 * i + 8], a[i].hi[1], a[i].lo[1]);
      split(x4[16 * i], a[i].hi[2], a[i].lo[2]);
      split(x4[16 * i + 8], a[i].hi[3], a[i].lo[3]);
    }
    const float* y0 = Y + (size_t)(k0 + t) * ldy + w.nb + g;
    const float* y4 = y0 + 4 * (size_t)ldy;
    FragB b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      split(y0[8 * j], b[j].hi[0], b[j].lo[0]);
      split(y4[8 * j], b[j].hi[1], b[j].lo[1]);
    }
    mma3_sweeps<4>(acc, a, b);
  }
}

// out[m * ldo + n] += the row sum's element (m, n) for m < mx, n < ny, as
// L2 reductions into device memory that every block adds to: lanes t and
// t ^ 1 swap halves so that each lane holds four neighbouring columns of one
// row (row g for even t, g + 8 for odd), one 16-byte reduction each
// (REDG.F32x4) where ldo % 4 == 0 and the four are in range, else one a
// column.
__device__ void red_row_sum(const Acc& acc, float* out, int ldo, int mx,
                            int ny, int RT) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const SumWarp w(mx, RT);
  const int mb = w.mb, nb = w.nb;
  if (mb >= mx || nb >= ny) return;
  const bool odd = t & 1;
  const bool vec = (ldo & 3) == 0;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* c = acc[i][j];
      const float s0 = __shfl_xor_sync(0xffffffffu, odd ? c[0] : c[2], 1);
      const float s1 = __shfl_xor_sync(0xffffffffu, odd ? c[1] : c[3], 1);
      const float4 v = odd ? make_float4(s0, s1, c[2], c[3])
                           : make_float4(c[0], c[1], s0, s1);
      const int m = mb + 16 * i + g + (odd ? 8 : 0);
      const int n0 = nb + 8 * j + 4 * (t >> 1);
      if (m >= mx || n0 >= ny) continue;
      float* p = out + (size_t)m * ldo + n0;
      if (vec && n0 + 3 < ny) {
        atomicAdd(reinterpret_cast<float4*>(p), v);
      } else {
        const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (n0 + q < ny) atomicAdd(p + q, vv[q]);
      }
    }
}

// A store of two floats that the block does not read again soon (evict
// first: keeps the weights in L2)
__device__ __forceinline__ void st_stream(float* p, float x, float y) {
  __stcs(reinterpret_cast<float2*>(p), make_float2(x, y));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   apt_sa::smem_u32(dst)),
               "l"(src)
               : "memory");
}

// Row tid of a tile (threads tid < RT): its neighbour, center, slot and
// query point, loaded a tile ahead so that the loads overlap the tile
// before.
struct RowPre {
  int j, center, k, q;
};

__device__ RowPre prefetch_rows(const Geo& g, long long n, long long row0,
                                int RT) {
  RowPre p{0, 0, 0, 0};
  const int r = threadIdx.x;
  if (r < RT && row0 + r < n) {
    const int row = (int)(row0 + r);
    p.center = row / g.K;
    p.k = row - p.center * g.K;
    p.j = g.idx[row];
    p.q = g.qidx[p.center];
  }
  return p;
}

// Rows row0 .. row0 + R - 1 of the stage (row = (b M + m) K + k: slot k of
// center b M + m; pre: prefetch_rows of them) into X row-major (ld floats a
// row), v = [dp || fj] as the plain ball group computes it; columns W .. W8
// - 1 and rows R .. RT - 1 zero. Each row's neighbour index, center, slot
// and query go to rows (RT of each, in that order). The features come by
// cp.async (one group, which the caller waits for).
__device__ void gather_tile(const Geo& g, int R, int RT, float* X, int ld,
                            int W8, int* rows, const RowPre& pre) {
  int* scen = rows + RT;
  int* sk = scen + RT;
  int* sq = sk + RT;
  if (threadIdx.x < RT) {
    rows[threadIdx.x] = pre.j;
    scen[threadIdx.x] = pre.center;
    sk[threadIdx.x] = pre.k;
    sq[threadIdx.x] = pre.q;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < RT; r += kWarps) {
    float* dst = X + (size_t)r * ld;
    if (r >= R) {
      for (int c = lane; c < W8; c += 32) dst[c] = 0.f;
      continue;
    }
    const int b = scen[r] / g.M;
    const float* fj = g.feats + ((size_t)b * g.N + rows[r]) * g.C - 3;
    for (int c = 3 + lane; c < W8; c += 32) {
      if (c < g.W)
        cp_async4(dst + c, fj + c);
      else
        dst[c] = 0.f;
    }
  }
  apt_sa::cp_commit();
  for (int e = threadIdx.x; e < RT * 3; e += kThreads) {
    const int r = e / 3, c = e % 3;
    float v = 0.f;
    if (r < R) {
      const float* X0 = g.xyz + (size_t)(scen[r] / g.M) * g.N * 3;
      v = X0[(size_t)rows[r] * 3 + c];
      if (g.relative)
        v = __fmul_rn(__fsub_rn(v, X0[(size_t)sq[r] * 3 + c]), g.dp_scale);
    }
    X[(size_t)r * ld + c] = v;
  }
}

// Weights below are weight_rows_kernel's copies: B[n][k] with n the output
// column, Kd floats a row.
struct W2Args {
  const float *w1t, *a1, *nb1;  // w1t: W1^T, mid rows, Kd = W8
  const uint32_t* mask;         // (ceil(mid / 32), n): the forward's ReLU
  const float *w2t, *a2, *p2, *q2c;  // w2t: W2^T, cout rows, Kd = mid8
  const uint8_t* slot;          // (B, M, cout)
  const float* gout;            // (B, M, cout)
  const float* w2p;             // W2, mid rows, Kd = cout8
  const float *mu1, *r1;
  float* y1;                    // (n, mid8)
  float* gy2;                   // (n, cout8)
  float* gy1;                   // (n, mid8): g_y1'
  int mid, cout;
};

// bwd_w2, first kernel: y1 (to a.y1), h, y2, g_y2 (to a.gy2) and dW2
// (workspace slice [mid * cout]).
template <int NT>
__global__ void __launch_bounds__(kThreads, 2)
bwd_y2_kernel(Geo g, int nring, W2Args a, float* __restrict__ dw2) {
  constexpr int RT = 32 * NT;
  extern __shared__ float4 smem4[];
  const int mid = a.mid, cout = a.cout;
  const int W8 = round8(g.W), mid8 = round8(mid), cout8 = round8(cout);
  const int ldx = ld_rm(imax(W8, mid8));
  float* X = reinterpret_cast<float*>(smem4);  // v, then h
  float* D = X + (size_t)RT * ldx;             // a 64-column chunk of g_y2
  float* ring = D + (size_t)RT * kLdD;
  // a chunk's pooled cotangents and winning slots, for the tile's centers
  const int ncmax = centers_spanned(RT, g.K);
  float* sgo = ring + nring * kStageFloats;
  uint8_t* swin = reinterpret_cast<uint8_t*>(sgo + ncmax * kNC);
  int* sidx = reinterpret_cast<int*>(swin + ncmax * kNC);
  const int* scen = sidx + RT;
  const int* sk = scen + RT;
  const long long n = (long long)g.B * g.M * g.K;
  const long long tiles = (n + RT - 1) / RT;
  const PassWarp w(RT);
  Acc acc;
  dw2 += (size_t)(blockIdx.x % kCopies) * mid * cout;
  RowPre pre = prefetch_rows(g, n, (long long)blockIdx.x * RT, RT);
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = (int)(tile * RT);
    const int R = (int)(n - row0 < RT ? n - row0 : RT);
    gather_tile(g, R, RT, X, ldx, W8, sidx, pre);
    pre = prefetch_rows(g, n, (tile + gridDim.x) * RT, RT);
    for (int j0 = 0; j0 < mid8; j0 += kNC) {  // y1 = v W1
      product<NT>(acc, X, ldx, a.w1t, mid, j0, W8, ring, nring);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = w.row(i, 2 * h), c = j0 + w.col(j);
            if (j < w.nt && r < R && c < mid8)
              *reinterpret_cast<float2*>(a.y1 + (size_t)(row0 + r) * mid8 + c) =
                  make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
          }
    }
    __syncthreads();  // v is read, y1 is written
    // h = a1 y1 + nb1 where the forward's ReLU passed, else 0, over v;
    // four rounds of loads in flight a thread
    const int q4 = mid8 / 4;
    for (int e0 = threadIdx.x; e0 < RT * q4; e0 += 4 * kThreads) {
      float4 y[4];
      uint32_t word[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * kThreads, r = e / q4, j = 4 * (e % q4);
        y[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        word[u] = 0u;
        if (e < RT * q4 && r < R) {
          y[u] = *reinterpret_cast<const float4*>(a.y1 + (size_t)(row0 + r) * mid8 + j);
          word[u] = a.mask[(size_t)(j >> 5) * n + row0 + r];
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * kThreads, r = e / q4, j = 4 * (e % q4);
        if (e >= RT * q4) break;
        const float yv[4] = {y[u].x, y[u].y, y[u].z, y[u].w};
        float hv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int jj = j + q;
          hv[q] = jj < mid && ((word[u] >> (jj & 31)) & 1u)
                      ? __fadd_rn(__fmul_rn(yv[q], a.a1[jj]), a.nb1[jj])
                      : 0.f;
        }
        *reinterpret_cast<float4*>(X + (size_t)r * ldx + j) =
            make_float4(hv[0], hv[1], hv[2], hv[3]);
      }
    }
    const int cfirst = row0 / g.K;
    const int nc = (row0 + R - 1) / g.K - cfirst + 1;
    for (int c0 = 0; c0 < cout8; c0 += kNC) {  // y2, g_y2, dW2, 64 columns
      for (int e = threadIdx.x; e < nc * kNC; e += kThreads) {
        const int c = c0 + e % kNC;
        if (c < cout) {
          const size_t at = (size_t)(cfirst + e / kNC) * cout + c;
          swin[e] = a.slot[at];
          cp_async4(sgo + e, a.gout + at);
        } else {
          swin[e] = 0xff;
        }
      }
      apt_sa::cp_commit();  // landed before the product's first stage
      product<NT>(acc, X, ldx, a.w2t, cout, c0, mid8, ring, nring);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (j >= w.nt) continue;
            const int r = w.row(i, 2 * h), c = c0 + w.col(j);
            float o[2] = {0.f, 0.f};
            if (r < R) {
              const int at0 = (scen[r] - cfirst) * kNC + c - c0;
#pragma unroll
              for (int q = 0; q < 2; ++q) {
                if (c + q >= cout) continue;
                const float gs = swin[at0 + q] == sk[r] ? sgo[at0 + q] : 0.f;
                o[q] = __fadd_rn(__fadd_rn(__fmul_rn(a.a2[c + q], gs),
                                           a.p2[c + q]),
                                 __fmul_rn(a.q2c[c + q], acc[i][j][2 * h + q]));
              }
              if (c < cout8)
                st_stream(a.gy2 + (size_t)(row0 + r) * cout8 + c, o[0], o[1]);
            }
            *reinterpret_cast<float2*>(D + (size_t)r * kLdD + c - c0) =
                make_float2(o[0], o[1]);
          }
      __syncthreads();
      for (int m0 = 0; m0 < mid; m0 += 128) {
        row_sum(acc, X + m0, ldx, mid - m0, D, kLdD, imin(kNC, cout - c0), RT);
        red_row_sum(acc, dw2 + (size_t)m0 * cout + c0, cout, mid - m0,
                    imin(kNC, cout - c0), RT);
      }
    }
    __syncthreads();
  }
}

// bwd_w2, second kernel: g_h = g_y2 W2^T per 64 hidden channels, g_y1' =
// g_h where the forward's ReLU passed (to a.gy1), and the workspace slice
// [2 * mid] = (sum g_y1', sum g_y1' xhat1).
template <int NT>
__global__ void __launch_bounds__(kThreads, 2)
bwd_gh_kernel(long long n, int nring, W2Args a, float* __restrict__ part) {
  constexpr int RT = 32 * NT;
  extern __shared__ float4 smem4[];
  const int mid = a.mid, mid8 = round8(mid), cout8 = round8(a.cout);
  const int ldx = ld_rm(cout8);
  float* X = reinterpret_cast<float*>(smem4);  // g_y2 of the tile
  float* red = X + (size_t)RT * ldx;           // [row warp][column][2]
  float* ring = red + kSumFloats;
  const long long tiles = (n + RT - 1) / RT;
  float* mine = part + blockIdx.x * 2LL * mid;
  zero_slice(mine, 2LL * mid);
  const PassWarp w(RT);
  Acc acc;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = (int)(tile * RT);
    const int R = (int)(n - row0 < RT ? n - row0 : RT);
    for (int q = threadIdx.x; q < RT * (cout8 / 4); q += kThreads) {
      const int r = q / (cout8 / 4), c = 4 * (q % (cout8 / 4));
      apt_sa::cp_async16(X + (size_t)r * ldx + c,
                         r < R ? a.gy2 + (size_t)(row0 + r) * cout8 + c : a.gy2, r < R);
    }
    apt_sa::cp_commit();
    apt_sa::cp_wait<0>();
    for (int j0 = 0; j0 < mid8; j0 += kNC) {
      product<NT>(acc, X, ldx, a.w2p, mid, j0, cout8, ring, nring);
      float s[4][2], sx[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) s[j][q] = sx[j][q] = 0.f;
      // y1 and the mask at each element, loaded first
      float2 yv[2][4][2];
      uint32_t word[2][4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = w.row(i, 2 * h), c = j0 + w.col(j);
            yv[i][j][h] = make_float2(0.f, 0.f);
            word[i][j][h] = 0u;
            if (j < w.nt && r < R && c < mid) {
              yv[i][j][h] = __ldg(reinterpret_cast<const float2*>(
                  a.y1 + (size_t)(row0 + r) * mid8 + c));
              word[i][j][h] = __ldg(a.mask + (size_t)(c >> 5) * n + row0 + r);
            }
          }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = w.row(i, 2 * h), c = j0 + w.col(j);
            if (j >= w.nt || r >= R || c >= mid8) continue;
            const float y2v[2] = {yv[i][j][h].x, yv[i][j][h].y};
            float gp[2] = {0.f, 0.f};
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              if (c + q >= mid || !((word[i][j][h] >> ((c + q) & 31)) & 1u))
                continue;
              gp[q] = acc[i][j][2 * h + q];
              const float x = __fmul_rn(__fsub_rn(y2v[q], a.mu1[c + q]),
                                        a.r1[c + q]);
              s[j][q] = __fadd_rn(s[j][q], gp[q]);
              sx[j][q] = __fadd_rn(sx[j][q], __fmul_rn(gp[q], x));
            }
            st_stream(a.gy1 + (size_t)(row0 + r) * mid8 + c, gp[0], gp[1]);
          }
      // over the warp's rows (lanes of one t), then over the row warps
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) {
            s[j][q] = __fadd_rn(s[j][q], __shfl_xor_sync(0xffffffffu, s[j][q], o));
            sx[j][q] = __fadd_rn(sx[j][q], __shfl_xor_sync(0xffffffffu, sx[j][q], o));
          }
      if (w.g == 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 2; ++q)
            if (j < w.nt) {
              float* p = red + ((size_t)w.wr * kNC + w.col(j) + q) * 2;
              p[0] = s[j][q];
              p[1] = sx[j][q];
            }
      }
      __syncthreads();
      for (int c = threadIdx.x; c < kNC && j0 + c < mid; c += kThreads) {
        float t0 = 0.f, t1 = 0.f;
        for (int wr = 0; wr < w.nt; ++wr) {
          t0 = __fadd_rn(t0, red[((size_t)wr * kNC + c) * 2]);
          t1 = __fadd_rn(t1, red[((size_t)wr * kNC + c) * 2 + 1]);
        }
        mine[j0 + c] += t0;
        mine[mid + j0 + c] += t1;
      }
    }
    __syncthreads();
  }
}

struct XArgs {
  const float *y1, *gy1;       // (n, mid8), from bwd_w2
  const float *a1, *p1, *q1c;
  const float* w1p;            // W1, W rows, Kd = mid8 (g_v = g_y1 W1^T)
  const float* g_fi;           // (B, M, C) or null
  const float* g_new;          // (B, M, 3) or null
  float* g_xyz;                // (B, N, 3), zeroed
  float* g_feats;              // (B, N, C), zeroed, 16-byte aligned
  int mid;
};

__device__ __forceinline__ float g_y1_of(const XArgs& a, int c, float gp,
                                         float y) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a.a1[c], gp), a.p1[c]),
                   __fmul_rn(a.q1c[c], y));
}

// Add the tile's g_v rows (GV row-major, ld: dp at columns 1..3, features
// from column 4, 16-byte aligned; their neighbour indices in sidx) onto the
// support points. A work item is
// one center's rows in the tile by a slice of channels (128 a warp in
// float4s where C > 32 and C % 4 == 0, else 32); runs of equal neighbour
// index are summed in registers first. The slice of the center's slot 0
// also adds g_new (and, relative, subtracts the dp rows' sum) and g_fi.
__device__ void scatter_tile(const Geo& g, const XArgs& a, long long row0,
                             int R, const float* GV, int ld,
                             const int* sidx) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int K = g.K, C = g.C;
  const long long cfirst = row0 / K;
  const int nseg = (int)((row0 + R - 1) / K - cfirst + 1);
  const bool vec = C > 32 && (C & 3) == 0;
  const int span = vec ? 128 : 32;
  const int pieces = imax(1, (C + span - 1) / span);
  for (int item = warp; item < nseg * pieces; item += kWarps) {
    const int sg = item / pieces, p = item % pieces;
    const long long center = cfirst + sg;
    const int b = (int)(center / g.M), q = g.qidx[center];
    const long long lo = center * K - row0;
    const int r0 = lo > 0 ? (int)lo : 0;
    const int r1 = (int)(lo + K < R ? lo + K : R);
    const bool first = lo >= 0;
    float* GX = a.g_xyz + (size_t)b * g.N * 3;
    float* GF = a.g_feats + (size_t)b * g.N * C;
    const int ch = p * span + (vec ? 4 * lane : lane);
    const bool has = ch < C, dp = p == 0 && lane < 3;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    float accd = 0.f, dsum = 0.f;
    int run = sidx[r0];
    auto flush = [&]() {
      if (has) {
        if (vec)
          atomicAdd(reinterpret_cast<float4*>(GF + (size_t)run * C + ch), acc);
        else
          atomicAdd(GF + (size_t)run * C + ch, acc.x);
      }
      if (dp) atomicAdd(GX + (size_t)run * 3 + lane, accd);
    };
    for (int r = r0; r < r1; ++r) {
      const int j = sidx[r];
      if (j != run) {
        flush();
        run = j;
        acc = make_float4(0.f, 0.f, 0.f, 0.f);
        accd = 0.f;
      }
      const float* src = GV + (size_t)r * ld;
      if (has) {
        if (vec) {
          const float4 v = *reinterpret_cast<const float4*>(src + 4 + ch);
          acc.x = __fadd_rn(acc.x, v.x);
          acc.y = __fadd_rn(acc.y, v.y);
          acc.z = __fadd_rn(acc.z, v.z);
          acc.w = __fadd_rn(acc.w, v.w);
        } else {
          acc.x = __fadd_rn(acc.x, src[4 + ch]);
        }
      }
      if (dp) {
        const float d = src[1 + lane];
        accd = __fadd_rn(accd, d);
        dsum = __fadd_rn(dsum, d);
      }
    }
    flush();
    if (dp) {
      float v = first && a.g_new ? a.g_new[center * 3 + lane] : 0.f;
      if (g.relative) v = __fsub_rn(v, dsum);
      if (first || g.relative) atomicAdd(GX + (size_t)q * 3 + lane, v);
    }
    if (first && a.g_fi && has) {
      if (vec)
        atomicAdd(reinterpret_cast<float4*>(GF + (size_t)q * C + ch),
                  *reinterpret_cast<const float4*>(a.g_fi + center * C + ch));
      else
        atomicAdd(GF + (size_t)q * C + ch, a.g_fi[center * C + ch]);
    }
  }
}

// bwd_x: g_y1 from the hand-over, dW1 (into copy blockIdx.x % kCopies) and
// the scatter of g_v.
template <int NT>
__global__ void __launch_bounds__(kThreads, 2)
bwd_x_kernel(Geo g, int nring, XArgs a, float* __restrict__ dw1) {
  constexpr int RT = 32 * NT;
  extern __shared__ float4 smem4[];
  const int W = g.W, W8 = round8(W), mid = a.mid, mid8 = round8(mid);
  const int ld1 = ld_rm(round8(W + 1)), ld2 = ld_rm(mid8);
  float* X1 = reinterpret_cast<float*>(smem4);  // v, then g_v
  float* X2 = X1 + (size_t)RT * ld1;            // g_y1
  float* ring = X2 + (size_t)RT * ld2;
  int* sidx = reinterpret_cast<int*>(ring + nring * kStageFloats);
  const long long n = (long long)g.B * g.M * g.K;
  const long long tiles = (n + RT - 1) / RT;
  const PassWarp w(RT);
  Acc acc;
  dw1 += (size_t)(blockIdx.x % kCopies) * W * mid;
  RowPre pre = prefetch_rows(g, n, (long long)blockIdx.x * RT, RT);
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = (int)(tile * RT);
    const int R = (int)(n - row0 < RT ? n - row0 : RT);
    gather_tile(g, R, RT, X1, ld1, W8, sidx, pre);
    pre = prefetch_rows(g, n, (tile + gridDim.x) * RT, RT);
    // g_y1 over the tile, four rounds of loads in flight a thread
    const int q4 = mid8 / 4;
    for (int e0 = threadIdx.x; e0 < RT * q4; e0 += 4 * kThreads) {
      float4 y[4], gp[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * kThreads, r = e / q4, j = 4 * (e % q4);
        y[u] = gp[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (e < RT * q4 && r < R) {
          const size_t at = (size_t)(row0 + r) * mid8 + j;
          y[u] = *reinterpret_cast<const float4*>(a.y1 + at);
          gp[u] = *reinterpret_cast<const float4*>(a.gy1 + at);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * kThreads, r = e / q4, j = 4 * (e % q4);
        if (e >= RT * q4) break;
        const float yv[4] = {y[u].x, y[u].y, y[u].z, y[u].w};
        const float gv[4] = {gp[u].x, gp[u].y, gp[u].z, gp[u].w};
        float o[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          o[q] = r < R && j + q < mid ? g_y1_of(a, j + q, gv[q], yv[q])
                                      : 0.f;
        *reinterpret_cast<float4*>(X2 + (size_t)r * ld2 + j) =
            make_float4(o[0], o[1], o[2], o[3]);
      }
    }
    apt_sa::cp_wait<0>();  // the gathered features
    __syncthreads();
    for (int m0 = 0; m0 < W; m0 += 128)  // dW1 += v^T g_y1
      for (int n0 = 0; n0 < mid; n0 += kNC) {
        row_sum(acc, X1 + m0, ld1, W - m0, X2 + n0, ld2, imin(kNC, mid - n0),
                RT);
        red_row_sum(acc, dw1 + (size_t)m0 * mid + n0, mid, W - m0,
                    imin(kNC, mid - n0), RT);
      }
    for (int c0 = 0; c0 < W; c0 += kNC) {  // g_v = g_y1 W1^T, over v
      product<NT>(acc, X2, ld2, a.w1p, W, c0, mid8, ring, nring);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = w.row(i, e), c = c0 + w.col(j) + (e & 1);
            if (j >= w.nt || c >= W) continue;
            const float v = acc[i][j][e];
            X1[(size_t)r * ld1 + 1 + c] = c < 3 ? __fmul_rn(v, g.dp_scale) : v;
          }
    }
    __syncthreads();
    scatter_tile(g, a, row0, R, X1, ld1, sidx);
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

enum Kind { kStats, kFwd, kBwdY2, kBwdGh, kBwdX };

// Shared memory (bytes) of a pass at its tile: TM centers (stats, forward)
// or RT rows (the backward's kernels).
size_t smem_bytes(int kind, int tile, int K, int W, int mid, int cout,
                  int ring = 2) {
  if (kind == kStats) return (size_t)W * tile_ld(tile * K) * 4;
  if (kind == kFwd) {
    const size_t ld = tile_ld(tile * K);
    return ((W + mid + kChunk) * ld + (size_t)kKC * 64) * 4;
  }
  const int W8 = round8(W), mid8 = round8(mid), cout8 = round8(cout);
  size_t f;
  if (kind == kBwdY2)
    f = (size_t)tile * (ld_rm(imax(W8, mid8)) + kLdD) +
        (size_t)centers_spanned(tile, K) * kNC * 5 / 4;
  else if (kind == kBwdGh)
    f = (size_t)tile * ld_rm(cout8) + kSumFloats;
  else
    f = (size_t)tile * (ld_rm(round8(W + 1)) + ld_rm(mid8));
  return (f + (size_t)ring * kStageFloats + kIdxInts + kSlack) * 4;
}

// The instance of a pass's kernel for its tile (RT = 32 NT rows for the
// backward's).
const void* kernel_of(int kind, int tile) {
  const int nt = tile / 32;
  switch (kind) {
    case kStats: return (const void*)stats_kernel;
    case kFwd: return (const void*)fwd_kernel;
    case kBwdY2:
      return nt == 4 ? (const void*)bwd_y2_kernel<4>
             : nt == 2 ? (const void*)bwd_y2_kernel<2>
                       : (const void*)bwd_y2_kernel<1>;
    case kBwdGh:
      return nt == 4 ? (const void*)bwd_gh_kernel<4>
             : nt == 2 ? (const void*)bwd_gh_kernel<2>
                       : (const void*)bwd_gh_kernel<1>;
    default:
      return nt == 4 ? (const void*)bwd_x_kernel<4>
             : nt == 2 ? (const void*)bwd_x_kernel<2>
                       : (const void*)bwd_x_kernel<1>;
  }
}

// Launches the backward's kernel instance for RT = 32 NT rows.
template <int NT>
void launch_y2(int grid, size_t smem, cudaStream_t st, const Geo& g,
               int nring, const W2Args& a, float* dw2) {
  bwd_y2_kernel<NT><<<grid, kThreads, smem, st>>>(g, nring, a, dw2);
}
template <int NT>
void launch_gh(int grid, size_t smem, cudaStream_t st, long long n,
               int nring, const W2Args& a, float* part) {
  bwd_gh_kernel<NT><<<grid, kThreads, smem, st>>>(n, nring, a, part);
}
template <int NT>
void launch_x(int grid, size_t smem, cudaStream_t st, const Geo& g,
              int nring, const XArgs& a, float* dw1) {
  bwd_x_kernel<NT><<<grid, kThreads, smem, st>>>(g, nring, a, dw1);
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

// The tile and the grid (G blocks) a pass runs with at these shapes: kind 0
// stats and 1 forward (tile: TM centers a block), 2 and 3 the two kernels
// of bwd_w2, 4 bwd_x (tile: RT rows a block, 128, 64 or 32: force_rows
// where it fits shared memory, else as below), and the backward's weight
// ring stages. The caller sizes the workspace G * E floats from them. Returns
// cudaError_t.
int sa_trainbn_plan(int kind, int B, int M, int K, int C, int mid, int cout,
                    int force_rows, int* tile, int* grid, int* ring) {
  if (B <= 0 || M <= 0 || K <= 0 || K > 255 || C < 0 || mid <= 0 ||
      cout <= 0 || kind < kStats || kind > kBwdX)
    return cudaErrorInvalidValue;
  const int W = C + 3;
  if ((long long)B * M * K > 0x7fffffffLL) return cudaErrorInvalidValue;
  int t = 0;
  if (kind <= kFwd) {
    t = 8;
    while (t > 1 && (t * K > kMaxRows ||
                     smem_bytes(kind, t, K, W, mid, cout) > kSmemLimit))
      t /= 2;
  } else if (force_rows != 0 && force_rows != 32 && force_rows != 64 &&
             force_rows != 128) {
    return cudaErrorInvalidValue;
  } else if (force_rows &&
             smem_bytes(kind, force_rows, K, W, mid, cout) <= kSmemLimit) {
    t = force_rows;
  } else {
    // two blocks an SM hide each other's waits: 128 rows where two fit, else
    // 64 where two fit (faster than one block of 128 at PointNeXt-S's third
    // stage), else the most rows one block takes
    const auto fits = [&](int rt, size_t cap) {
      return smem_bytes(kind, rt, K, W, mid, cout) <= cap;
    };
    if (fits(128, kSmemLimit / 2)) {
      t = 128;
    } else if (fits(64, kSmemLimit / 2)) {
      t = 64;
    } else {
      t = 128;
      while (t > 32 && !fits(t, kSmemLimit)) t /= 2;
    }
  }
  // the weight ring: as deep as fits beside two blocks an SM where two
  // fit, else beside one
  int nr = 2;
  if (kind > kFwd) {
    const size_t cap = smem_bytes(kind, t, K, W, mid, cout, 2) <= kSmemLimit / 2
                           ? kSmemLimit / 2 : kSmemLimit;
    while (nr < kMaxRing && smem_bytes(kind, t, K, W, mid, cout, nr + 1) <= cap)
      ++nr;
  }
  const size_t smem = smem_bytes(kind, t, K, W, mid, cout, nr);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  const void* fn = kernel_of(kind, t);
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
  const long long units = kind <= kFwd ? (long long)B * M
                                       : (long long)B * M * K;
  const long long tiles = (units + t - 1) / t;
  long long gsz = (long long)imax(per_sm, 1) * sms;
  if (gsz > tiles) gsz = tiles;
  *tile = t;
  *grid = (int)gsz;
  *ring = nr;
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
  stats_kernel<<<G, kThreads, smem_bytes(kStats, TM, K, g.W, 1, 1), stream>>>(
      g, TM, tiles, part);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return reduce(part, G, (long long)g.W + (long long)g.W * g.W, out, stream);
}

// Pass 2. w1 (W, mid), a1, nb1 (mid), w2 (mid, cout) f32 -> new_xyz
// (B,M,3), fi (B,M,C), ymax, ymin (B,M,cout) f32, amax, amin (B,M,cout) u8,
// mask (ceil(mid/32), B*M*K) u32, out [2 * cout] = (sum y2, sum y2^2);
// part: G * 2 * cout floats.
int sa_trainbn_fwd_launch(const float* xyz, const int* qidx,
                          const float* feats, const int* idx, int B, int N,
                          int M, int C, int K, float dp_scale, int relative,
                          const float* w1, const float* a1, const float* nb1,
                          const float* w2, int mid, int cout, int TM, int G,
                          float* new_xyz, float* fi, float* ymax, float* ymin,
                          uint8_t* amax, uint8_t* amin, uint32_t* mask,
                          float* part, float* out, cudaStream_t stream) {
  const Geo g = make_geo(xyz, qidx, feats, idx, B, N, M, C, K, dp_scale,
                         relative);
  const long long tiles = ((long long)B * M + TM - 1) / TM;
  fwd_kernel<<<G, kThreads, smem_bytes(kFwd, TM, K, g.W, mid, cout),
               stream>>>(g, TM, tiles, w1, a1, nb1, w2, mid, cout, new_xyz,
                         fi, ymax, ymin, amax, amin, mask, part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return reduce(part, G, 2LL * cout, out, stream);
}

// Pass 3, two kernels, after three weight_rows_kernel launches. w1 (W,
// mid) and w2 (mid, cout) f32; a1, nb1, mu1, r1 (mid) and a2, p2, q2c (cout)
// per-channel rows; mask (ceil(mid/32), B*M*K) u32 the forward's ReLU; slot
// (B,M,cout) u8 the winning slot, gout (B,M,cout) the pooled cotangent.
// wsplit: the weight copies' scratch, mid * W8 + cout * mid8 + mid * cout8
// floats (X8 = round8(X)). Writes y1 and gy1 = g_y1' ((B*M*K, mid8)
// each), gy2 (B*M*K, cout8) scratch, dw2 [mid * cout] (16-byte aligned;
// zeroed here) and sums [2 * mid] = (sum g_y1', sum g_y1' xhat1) through
// the workspace part (grid_b * 2 * mid).
int sa_trainbn_bwd_w2_launch(
    const float* xyz, const int* qidx, const float* feats, const int* idx,
    int B, int N, int M, int C, int K, float dp_scale, int relative,
    const float* w1, const float* w2, const float* a1, const float* nb1,
    const uint32_t* mask, const float* a2, const float* p2, const float* q2c,
    const uint8_t* slot, const float* gout, const float* mu1,
    const float* r1, int mid, int cout, int rt_a, int grid_a, int rt_b,
    int grid_b, int ring_a, int ring_b, float* wsplit, float* y1,
    float* gy2, float* gy1, float* dw2_part, float* dw2, float* part,
    float* sums, cudaStream_t stream) {
  const Geo g = make_geo(xyz, qidx, feats, idx, B, N, M, C, K, dp_scale,
                         relative);
  const int W8 = round8(g.W), mid8 = round8(mid), cout8 = round8(cout);
  W2Args a;
  a.w1t = wsplit;
  a.w2t = a.w1t + (size_t)mid * W8;
  a.w2p = a.w2t + (size_t)cout * mid8;
  a.a1 = a1; a.nb1 = nb1; a.mask = mask; a.a2 = a2; a.p2 = p2; a.q2c = q2c;
  a.slot = slot; a.gout = gout; a.mu1 = mu1; a.r1 = r1; a.y1 = y1;
  a.gy2 = gy2; a.gy1 = gy1; a.mid = mid; a.cout = cout;
  cudaError_t e = weight_rows(w1, mid, g.W, 1, W8, wsplit, stream);
  if (e != cudaSuccess) return e;
  e = weight_rows(w2, cout, mid, 1, mid8, const_cast<float*>(a.w2t), stream);
  if (e != cudaSuccess) return e;
  e = weight_rows(w2, mid, cout, 0, cout8, const_cast<float*>(a.w2p), stream);
  if (e != cudaSuccess) return e;
  e = cudaMemsetAsync(dw2_part, 0,
                      (size_t)kCopies * mid * cout * sizeof(float), stream);
  if (e != cudaSuccess) return e;
  const size_t smem_a = smem_bytes(kBwdY2, rt_a, K, g.W, mid, cout, ring_a);
  if (rt_a == 128)
    launch_y2<4>(grid_a, smem_a, stream, g, ring_a, a, dw2_part);
  else if (rt_a == 64)
    launch_y2<2>(grid_a, smem_a, stream, g, ring_a, a, dw2_part);
  else
    launch_y2<1>(grid_a, smem_a, stream, g, ring_a, a, dw2_part);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = reduce(dw2_part, kCopies, (long long)mid * cout, dw2, stream);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t smem_b = smem_bytes(kBwdGh, rt_b, K, g.W, mid, cout, ring_b);
  const long long n = (long long)B * M * K;
  if (rt_b == 128)
    launch_gh<4>(grid_b, smem_b, stream, n, ring_b, a, part);
  else if (rt_b == 64)
    launch_gh<2>(grid_b, smem_b, stream, n, ring_b, a, part);
  else
    launch_gh<1>(grid_b, smem_b, stream, n, ring_b, a, part);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return reduce(part, grid_b, 2LL * mid, sums, stream);
}

// Pass 4. y1, gy1 ((B*M*K, mid8)) from pass 3; a1, p1, q1c (mid); w1 (W,
// mid) f32; g_fi (B,M,C) and g_new (B,M,3) or null. wsplit: W * mid8 floats
// of scratch; dw1_part: kCopies * W * mid (16-byte aligned). g_xyz (B,N,3),
// g_feats (B,N,C, 16-byte aligned) and dw1 [W * mid] are overwritten.
int sa_trainbn_bwd_x_launch(
    const float* xyz, const int* qidx, const float* feats, const int* idx,
    int B, int N, int M, int C, int K, float dp_scale, int relative,
    const float* y1, const float* gy1, const float* a1, const float* p1,
    const float* q1c, const float* w1, int mid, const float* g_fi,
    const float* g_new, int rt, int grid, int ring, float* wsplit,
    float* g_xyz, float* g_feats, float* dw1_part, float* dw1,
    cudaStream_t stream) {
  if ((reinterpret_cast<size_t>(g_feats) |
       reinterpret_cast<size_t>(dw1_part)) & 15)
    return cudaErrorInvalidValue;
  const Geo g = make_geo(xyz, qidx, feats, idx, B, N, M, C, K, dp_scale,
                         relative);
  const int mid8 = round8(mid);
  XArgs a;
  a.y1 = y1; a.gy1 = gy1; a.a1 = a1; a.p1 = p1; a.q1c = q1c;
  a.w1p = wsplit; a.g_fi = g_fi; a.g_new = g_new; a.g_xyz = g_xyz;
  a.g_feats = g_feats; a.mid = mid;
  cudaError_t e = weight_rows(w1, g.W, mid, 0, mid8, wsplit, stream);
  if (e != cudaSuccess) return e;
  e = cudaMemsetAsync(g_xyz, 0, (size_t)B * N * 3 * sizeof(float), stream);
  if (e != cudaSuccess) return e;
  e = cudaMemsetAsync(g_feats, 0, (size_t)B * N * C * sizeof(float), stream);
  if (e != cudaSuccess) return e;
  e = cudaMemsetAsync(dw1_part, 0, (size_t)kCopies * g.W * mid * sizeof(float),
                      stream);
  if (e != cudaSuccess) return e;
  const size_t smem = smem_bytes(kBwdX, rt, K, g.W, mid, 1, ring);
  if (rt == 128)
    launch_x<4>(grid, smem, stream, g, ring, a, dw1_part);
  else if (rt == 64)
    launch_x<2>(grid, smem, stream, g, ring, a, dw1_part);
  else
    launch_x<1>(grid, smem, stream, g, ring, a, dw1_part);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return reduce(dw1_part, kCopies, (long long)g.W * mid, dw1, stream);
}

const char* apt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
