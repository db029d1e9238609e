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
// Numerics. The forward's and the backward's products run on the tensor
// cores as 3xTF32: each f32 operand is split x = hi + lo, hi its round to
// TF32 (10 mantissa bits, to nearest, ties away) and lo = x - hi (exact), of
// which mma.sync.m16n8k8.tf32 reads the TF32 part, and lo.hi + hi.lo + hi.hi
// go into f32 accumulators: f32-grade products (the dropped lo.lo and lo's
// truncation are each under 2^-21 of |a b|), as the TPU kernel's f32
// products on its MXU ("parity ~1e-5", satrainbn.py:60-64). The statistics
// (Sv, Svv) take f32 FMAs on the CUDA cores: BN1's variance is flax's E[y^2]
// - E[y]^2 from Svv, which cancels as |mean| / std grows, and 3xTF32 sums
// moved the stage's gradients by 1.9e-2 from the TPU kernel's at |mean| /
// std = 10 and 100 (tests/test_torch_satrainbn_fwd.py), f32 ones by 1.5e-5
// and 2.5e-3. The winners of the max-pool are not found again in the
// backward: the forward writes both the max's and the min's first slot, and
// the backward reads the one the sign of BN2's slope selects (ties to the
// first slot, the port's rule). Nor is the ReLU's mask: the backward
// computes y1 in another order, so it takes the forward's bits.
//
// Common pieces. The neighbour indices of every (b, m) are found once, by
// the select kernel of the stats pass (one warp per center, the ball-group
// kernel's __ballot_sync scan), and every later pass reads them. A block of
// 8 warps owns tiles of rows of B*M*K; a tile's neighbour indices, centers,
// slots and queries are loaded a tile ahead, its features by cp.async. Rows
// are row-major in shared memory with a stride of 8 or 24 mod 32 floats: a
// lane's two k of an mma fragment are one conflict-free float2 (each k8 step
// takes its k in the order 2t, 2t + 1 in both operands), and the transposed
// reads of the row sums (dW1, dW2: X^T Y over the tile's rows) are
// conflict-free scalar loads. Weights stream 64 output columns by 64 k at a
// time through a ring of 2-6 cp.async stages (as deep as shared memory allows
// beside one or two blocks an SM), from copies padded to multiples of 8
// (weight_rows_kernel: W1^T and W2^T, made by the forward's call and handed
// to bwd_w2, and W1, W2). A product gives each warp a 32 x 8 NT tile of a
// 64-column chunk (RT = 32 NT rows a block, NT = 4, 2 or 1) and loads all of
// a k8 step's fragments before its 6 NT mma, issued as three sweeps (lo.hi,
// hi.lo, hi.hi) over the warp's accumulators so that no mma waits on the one
// before.
//
// stats: the upper triangle of S = sum u u^T, u = [dp || 1 || fj] (C + 4
// columns, so that the features start 16-byte aligned and Sv is S's column
// 3), in blocks of 64 x 64. A block owns one output block (si <= sj) and a
// contiguous range of tiles of 128 rows, gathers only the two column slices
// it needs, and keeps its 64 x 64 sums in registers across the range: four
// groups of 64 threads take every fourth row, each thread 8 x 8 outputs from
// four 16-byte shared loads a row. It writes its partial once (the groups
// added in order); a second kernel adds the parts of each block in order and
// reads every Svv entry from the upper triangle, so Svv is symmetric bit for
// bit.
//
// forward: a tile is TM whole balls (TM = RT / K; a ball of K > RT rows is
// one tile taken RT rows at a time), so the max over K stays in the block.
// v is gathered to shared memory, h = relu(a1 (v W1) + nb1) kept there per
// 64 hidden channels, then y2 = h W2 per 64 output channels; its epilogues
// run on the accumulators: BN2's sums over the lane's rows, then the row
// groups (shuffles), then the row warps in a fixed order into the block's
// sums (a slice per block, added in order afterwards); the max and the min
// with their first slot over the lane's rows and the row groups (shuffles)
// where a warp's 32 rows are one ball, then across warps as 64-bit keys
// (value, slot) in shared memory (atomicMax / atomicMin: the result does not
// depend on their order); the ReLU bits of a row's 32 channels, spread over
// the four lanes of a row group, by shuffles. Every result is the same bits
// run to run.
//
// bwd_w2 is two kernels: the first recomputes y1 (to device memory), then h
// in shared memory over the gathered rows, and per 64 output channels y2,
// g_y2 (kept beside it and written to device memory) and its dW2 block; the
// second reads g_y2 back a tile at a time, computes g_h per 64 hidden
// channels, masks it, writes g_y1' and sums the BatchNorm terms (block slices
// added in order). Splitting there keeps no (RT x mid) g_h accumulator live
// across the cout loop: the g_y2 round trip (n x cout f32) costs less than
// the smaller tiles or register spills that needs. bwd_x reads y1 and g_y1'
// (recomputing y1 from the gathered rows gives the same bits but timed
// slower) and writes nothing per row but the scatter of g_v: a warp takes
// one center's run of rows in the tile and a slice of channels, merges each
// run of equal neighbour index (a partial ball's pad slots) in registers and
// adds it with 16-byte L2 reductions where C % 4 == 0 and C > 32, else one
// reduction a channel, as the ball-group backward (ballgroup_bwd.cu) does,
// after the two memsets. Row sums (dW1, dW2) go out as 16-byte L2
// reductions (REDG.F32x4) into one of 8 copies (by block), summed in order
// after the kernel. The L2 reductions (dW1, dW2, the scatter) land in no
// fixed order: not bit-reproducible, held within the reordering bound.
//
// What bounds it on the H100: operations. At PointNeXt-S's four B=32 stages
// the forward does 48.7 GFLOP and the backward passes 113.1 and 33.0; as
// 3xTF32 that is 3x the work at the dense TF32 rate of 495 TFLOP/s, 0.295,
// 0.686 and 0.200 ms. The statistics' 8.6 GFLOP (Svv counted once, as the
// symmetric matrix it is) at the f32 rate of 67 TFLOP/s take 0.128 ms.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sa_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr size_t kSmemLimit = 232448;
// the most a block may use for two to fit an SM (228 KB, 1 KB reserved a
// block)
constexpr size_t kSmemTwo = (233472 - 2 * 1024) / 2;

__host__ __device__ inline int round8(int x) { return (x + 7) & ~7; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

struct Geo {
  const float* xyz;    // (B, N, 3)
  const int* qidx;     // (B, M)
  const float* feats;  // (B, N, C)
  const int* idx;      // (B, M, K)
  int B, N, M, C, K, W;
  float dp_scale;
  int relative;
};

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

// ---- the tensor-core products (passes 2-4), 3xTF32 ------------------------
constexpr int kNC = 64;                 // output columns of a product pass
constexpr int kKR = 64;                 // k of one weight ring stage (the
                                        // forward's one-block instances 128)
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

// acc += one k8 step of A B^T: A's rows of the warp (row-major, lda) at
// columns ka .., the warp's B rows (Bw: its first output column's row,
// ldb floats a row) at columns kb ..; each takes its k in the order 2t, 2t +
// 1, so that a lane's two k of a row are one conflict-free float2.
template <int NT>
__device__ __forceinline__ void kstep(Acc& acc, const float* A, int lda,
                                      int ka, const float* Bw, int ldb,
                                      int kb, const PassWarp& w) {
  FragA a[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float* p = A + (size_t)(w.wr * 32 + i * 16 + w.g) * lda + ka +
                     2 * w.t;
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
        Bw + (size_t)(j * 8 + w.g) * ldb + kb + 2 * w.t);
    split(y.x, b[j].hi[0], b[j].lo[0]);
    split(y.y, b[j].hi[1], b[j].lo[1]);
  }
  mma3_sweeps<NT>(acc, a, b);
}

// acc = A B^T over k < Kd for B's rows n0 .. n0 + 63: A (RT rows, Kd a
// multiple of 8 columns) row-major in shared memory (lda), B row-major in
// device memory (nb rows of Kd floats, zero past the weight's k: see
// weight_rows_kernel), staged KR k at a time through a ring of nring stages
// (rows past nb read as zero). Element (row, col) of the warp's block is
// output row row, column n0 + col (PassWarp); n8 tiles past nb are skipped.
// Every thread of the block calls it.
template <int NT, int KR = kKR>
__device__ void product(Acc& acc, const float* A, int lda,
                        const float* __restrict__ Bg, int nb, int n0, int Kd,
                        float* ring, int nring) {
  constexpr int kLd = KR + 8, kStage = kNC * kLd;  // a stage's rows
  const PassWarp w(32 * NT);
  zero_acc(acc);
  const int nk = (Kd + KR - 1) / KR;
  const bool idle = n0 + w.wc * 8 * NT >= nb;  // no column of this warp's
  __syncthreads();  // the ring's and the operands' last readers are done
  auto issue = [&](int kt) {
    float* st = ring + (kt % nring) * kStage;
    constexpr int kPieces = KR / 4;  // 16-byte pieces of a row
    for (int q = threadIdx.x; q < kNC * kPieces; q += kThreads) {
      const int n = q / kPieces, f = (q % kPieces) * 4;
      const int k = kt * KR + f;
      const bool full = n0 + n < nb && k < Kd;
      apt_sa::cp_async16(st + n * kLd + f,
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
    const float* st =
        ring + (kt % nring) * kStage + w.wc * 8 * NT * kLd;
    const int steps = imin(KR, Kd - kt * KR) / 8;
    if (idle) continue;
#pragma unroll
    for (int s = 0; s < KR / 8; ++s) {
      if (s >= steps) break;
      kstep<NT>(acc, A, lda, kt * KR + s * 8, st, kLd, s * 8, w);
    }
  }
  apt_sa::cp_wait<0>();
}

// product() with B resident in shared memory (Bs: rows of ldb floats, zero
// past the weight's rows and k, at least n0 + 64 rows): no ring and no
// barrier; the caller orders A's and B's writers before it.
template <int NT>
__device__ void product_res(Acc& acc, const float* A, int lda,
                            const float* Bs, int ldb, int nb, int n0,
                            int Kd) {
  const PassWarp w(32 * NT);
  zero_acc(acc);
  if (n0 + w.wc * 8 * NT >= nb) return;
  const float* Bw = Bs + (size_t)(n0 + w.wc * 8 * NT) * ldb;
#pragma unroll 2
  for (int k = 0; k < Kd; k += 8) kstep<NT>(acc, A, lda, k, Bw, ldb, k, w);
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

// ---- pass 1: the statistics, f32 FMAs on the CUDA cores -------------------
constexpr int kTs = 64 + 4;  // a partial block's row stride and rows
constexpr int kDepth = 3;    // tiles in flight a block

// The feature columns of a slice of u = [fj || dp || 1]: 64, or 32 where C
// <= 32 (the block's threads then cover a 32 x 32 output 4 rows deeper).
__host__ __device__ inline int slice_of(int C) { return C <= 32 ? 32 : 64; }
// Slices of the C feature columns (at least one, empty where C = 0); t =
// [dp || 1] are u's last 4 columns.
__host__ __device__ inline int slices_of(int C) {
  const int S = slice_of(C);
  return C > S ? (C + S - 1) / S : 1;
}
// Outputs a thread sums, and the threads of a group: S / 8 x S / 8 threads
// of 8 x 8 outputs, the slice's features against t (each thread S / group
// of its columns), and one entry of t t^T.
template <int S>
struct StatsShape {
  static constexpr int kGroupThreads = (S / 8) * (S / 8);
  static constexpr int kGroups = 256 / kGroupThreads;
  static constexpr int kTail = S / kGroupThreads;  // columns a thread
  static constexpr int kOut = 64 + 4 * kTail + 1;
  static constexpr int kStage = (kGroups - 1) * kOut * kGroupThreads;
};

// Index of the output block (si, sj), si <= sj, in the upper triangle's
// row-major order, and back.
__host__ __device__ inline int pair_index(int si, int sj, int ns) {
  return si * ns - si * (si - 1) / 2 + (sj - si);
}
__device__ inline void pair_of(int p, int ns, int& si, int& sj) {
  si = 0;
  while (p >= ns - si) {
    p -= ns - si;
    ++si;
  }
  sj = si + p;
}

// One row of a tile: its neighbour, cloud and query (ok: the row exists).
struct StatRow {
  int j, b, q;
  bool ok;
};
__device__ inline StatRow stat_row(const Geo& g, long long n, long long row) {
  StatRow s{0, 0, 0, false};
  if (row < n) {  // n < 2^31 (sa_trainbn_plan)
    const int center = (int)row / g.K;
    s.j = g.idx[row];
    s.b = center / g.M;
    s.q = g.qidx[center];
    s.ok = true;
  }
  return s;
}

// The thread's share (pieces part, part + parts, ...) of one row's features
// x0 .. x0 + wx - 1 into Xr by cp.async (16 bytes a piece where vec).
__device__ inline void issue_slice(const Geo& g, const StatRow& s, float* Xr,
                                   int x0, int wx, bool vec, int part,
                                   int parts) {
  const float* src = g.feats + ((size_t)s.b * g.N + s.j) * g.C + x0;
  if (vec) {
    for (int p = part; p < wx / 4; p += parts)
      apt_sa::cp_async16(Xr + 4 * p, src + 4 * p, true);
  } else {
    for (int c = part; c < wx; c += parts) cp_async4(Xr + c, src + c);
  }
}

// The partial sums of output block (si, sj) of U = sum u u^T, u = [fj ||
// dp || 1], over tiles t0 .. t1 - 1 of RT rows (blockIdx.x = block * P +
// part), into part[(block * P + part) * kTs * kTs]: element (a, b) for the
// features S si + a, S sj + b (a, b < S, the slice width); on the diagonal
// also (a, 64 + c) = sum fj[S si + a] t[c], and in block (0, 0) (64 + c, 64
// + d) = sum t[c] t[d]. A thread (group, ty, tx) sums rows group, group +
// kGroups, ... into the features' outputs a in {4 ty .. 4 ty + 3, S / 2 + 4
// ty ..}, b in {4 tx .., S / 2 + 4 tx ..}, each in row order. kDepth tiles are in flight: a thread
// issues its share of row r = tid % RT of tile t + 2 (and loads the indices
// of tile t + 3) before summing tile t. A buffer holds the tile's x slice,
// t (4 floats a row, on the diagonal) and, off the diagonal, its y slice;
// the thread that issues a row loads its coordinates and writes its t an
// iteration later, before the barrier that hands the tile over.
template <int S>
__global__ void __launch_bounds__(kThreads, 2)
stats_kernel(Geo g, int RT, int P, int vec, float* __restrict__ part) {
  using Sh = StatsShape<S>;
  constexpr int kG = Sh::kGroups, kGT = Sh::kGroupThreads, kTd = S / 8;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const size_t tile_f = (size_t)RT * S;
  auto Xb = [&](int b) { return sm + b * tile_f; };
  auto Tb = [&](int b) { return sm + kDepth * tile_f + (size_t)b * 4 * RT; };
  auto Yb = [&](int b) {
    return sm + kDepth * (tile_f + 4 * RT) + b * tile_f;
  };
  const int ns = slices_of(g.C), pt = blockIdx.x % P;
  int si, sj;
  pair_of(blockIdx.x / P, ns, si, sj);
  const bool diag = si == sj;
  const long long n = (long long)g.B * g.M * g.K;
  const long long tiles = (n + RT - 1) / RT;
  const long long t0 = tiles * pt / P, t1 = tiles * (pt + 1) / P;
  const int grp = threadIdx.x / kGT, tl = threadIdx.x % kGT, tx = tl % kTd,
            ty = tl / kTd;
  const int r = threadIdx.x % RT, part_ = threadIdx.x / RT,
            parts = kThreads / RT;
  // the feature columns of the two slices; the 4 x 4 quarters of the
  // thread's outputs that lie inside them
  const int wx = imin(S, g.C - si * S), wy = imin(S, g.C - sj * S);
  const bool qa[2] = {4 * ty < wx, S / 2 + 4 * ty < wx};
  const bool qb[2] = {4 * tx < wy, S / 2 + 4 * tx < wy};
  const bool full = wx >= S && wy >= S;  // every quarter, every thread
  const bool tt_lane = si == 0 && sj == 0 && tl < 16;  // an entry of t t^T
  float acc[8][8], tacc[Sh::kTail][4], tt = 0.f;
#pragma unroll
  for (int u = 0; u < Sh::kTail; ++u)
#pragma unroll
    for (int c = 0; c < 4; ++c) tacc[u][c] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  // row r of tile t (to buffer (t - t0) % kDepth): its features by
  // cp.async; on the diagonal its neighbour's and query's coordinates into
  // cj, cq (written out as t by put_t)
  float cj[3] = {0.f, 0.f, 0.f}, cq[3] = {0.f, 0.f, 0.f};
  int tb = -1;  // the buffer cj, cq belong to
  auto issue = [&](long long t, const StatRow& s) {
    if (!s.ok) return;  // past the last row: never read
    const int b = (int)((t - t0) % kDepth);
    issue_slice(g, s, Xb(b) + (size_t)r * S, si * S, wx, vec, part_, parts);
    if (!diag) {
      issue_slice(g, s, Yb(b) + (size_t)r * S, sj * S, wy, vec, part_,
                  parts);
    } else if (part_ == 0) {
      const float* X3 = g.xyz + (size_t)s.b * g.N * 3;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        cj[c] = X3[(size_t)s.j * 3 + c];
        cq[c] = X3[(size_t)s.q * 3 + c];
      }
      tb = b;
    }
  };
  auto put_t = [&]() {
    if (tb < 0) return;
    float d[3];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      d[c] = g.relative ? __fmul_rn(__fsub_rn(cj[c], cq[c]), g.dp_scale)
                        : cj[c];
    *reinterpret_cast<float4*>(Tb(tb) + 4 * r) =
        make_float4(d[0], d[1], d[2], 1.f);
    tb = -1;
  };
  for (int d = 0; d < kDepth - 1; ++d) {
    if (t0 + d < t1) issue(t0 + d, stat_row(g, n, (t0 + d) * RT + r));
    put_t();
    apt_sa::cp_commit();
  }
  StatRow nxt = stat_row(g, n, (t0 + kDepth - 1) * RT + r);
  for (long long t = t0; t < t1; ++t) {
    const int b = (int)((t - t0) % kDepth);
    put_t();  // tile t + 1's
    apt_sa::cp_wait<kDepth - 2>();
    __syncthreads();  // tile t is in buffer b; tile t - 1's is free
    if (t + kDepth - 1 < t1) issue(t + kDepth - 1, nxt);
    apt_sa::cp_commit();
    nxt = stat_row(g, n, (t + kDepth) * RT + r);
    const int R = (int)(n - t * RT < RT ? n - t * RT : RT);
    const float* X = Xb(b);
    const float* Y = diag ? X : Yb(b);
    const float* T = Tb(b);
    // the tile's rows; the quarter tests and the diagonal's work compiled
    // in or out (kFull: every quarter of every thread inside the slices)
    auto rows = [&](auto full_c, auto diag_c) {
      constexpr bool kFull = decltype(full_c)::value;
      constexpr bool kDiag = decltype(diag_c)::value;
      for (int rr = grp; rr < R; rr += kG) {
        const float* xr = X + (size_t)rr * S + 4 * ty;
        const float* yr = Y + (size_t)rr * S + 4 * tx;
        float a[8], bv[8];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4 x4 = *reinterpret_cast<const float4*>(xr + S / 2 * h);
          const float4 y4 = *reinterpret_cast<const float4*>(yr + S / 2 * h);
          a[4 * h] = x4.x; a[4 * h + 1] = x4.y; a[4 * h + 2] = x4.z; a[4 * h + 3] = x4.w;
          bv[4 * h] = y4.x; bv[4 * h + 1] = y4.y; bv[4 * h + 2] = y4.z; bv[4 * h + 3] = y4.w;
        }
#pragma unroll
        for (int ha = 0; ha < 2; ++ha)
#pragma unroll
          for (int hb = 0; hb < 2; ++hb) {
            // (on the diagonal the quarter below it is never read)
            if ((kDiag && ha > hb) || (!kFull && (!qa[ha] || !qb[hb])))
              continue;
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                acc[4 * ha + i][4 * hb + j] = __fmaf_rn(
                    a[4 * ha + i], bv[4 * hb + j], acc[4 * ha + i][4 * hb + j]);
          }
        if (kDiag) {  // the features against t, and t against t
          const float* tr = T + 4 * rr;
          const float4 t4 = *reinterpret_cast<const float4*>(tr);
#pragma unroll
          for (int u = 0; u < Sh::kTail; ++u)
            if (kFull || tl + u * kGT < wx) {
              const float x = X[(size_t)rr * S + tl + u * kGT];
              tacc[u][0] = __fmaf_rn(x, t4.x, tacc[u][0]);
              tacc[u][1] = __fmaf_rn(x, t4.y, tacc[u][1]);
              tacc[u][2] = __fmaf_rn(x, t4.z, tacc[u][2]);
              tacc[u][3] = __fmaf_rn(x, t4.w, tacc[u][3]);
            }
          if (tt_lane) tt = __fmaf_rn(tr[tl >> 2], tr[tl & 3], tt);
        }
      }
    };
    if (full && diag)
      rows(std::true_type(), std::true_type());
    else if (full)
      rows(std::true_type(), std::false_type());
    else if (diag)
      rows(std::false_type(), std::true_type());
    else
      rows(std::false_type(), std::false_type());
  }
  apt_sa::cp_wait<0>();
  __syncthreads();
  // groups 1 .. kG - 1 onto group 0, in that order, through the buffers
  constexpr int kOut = Sh::kOut;  // a thread's outputs
  float* stage = sm;              // [group - 1][output][kGT threads]
  if (grp > 0) {
    float* dst = stage + (size_t)(grp - 1) * kOut * kGT + tl;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) dst[(8 * i + j) * kGT] = acc[i][j];
#pragma unroll
    for (int u = 0; u < Sh::kTail; ++u)
#pragma unroll
      for (int c = 0; c < 4; ++c) dst[(64 + 4 * u + c) * kGT] = tacc[u][c];
    dst[(kOut - 1) * kGT] = tt;
  }
  __syncthreads();
  if (grp > 0) return;
  auto total = [&](float v, int o) {
    for (int q = 0; q < kG - 1; ++q)
      v = __fadd_rn(v, stage[((size_t)q * kOut + o) * kGT + tl]);
    return v;
  };
  float* out = part + (size_t)blockIdx.x * kTs * kTs;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = total(acc[i][j], 8 * i + j);
    const int a = (i < 4 ? 0 : S / 2) + 4 * ty + (i & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float4*>(out + (size_t)a * kTs + S / 2 * h + 4 * tx) =
          make_float4(o[4 * h], o[4 * h + 1], o[4 * h + 2], o[4 * h + 3]);
  }
  if (diag) {
#pragma unroll
    for (int u = 0; u < Sh::kTail; ++u)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        out[(size_t)(tl + u * kGT) * kTs + 64 + c] =
            total(tacc[u][c], 64 + 4 * u + c);
    if (si == 0 && tl < 16)
      out[(size_t)(64 + (tl >> 2)) * kTs + 64 + (tl & 3)] =
          total(tt, kOut - 1);
  }
}

// out = (Sv, Svv row-major) in v's order: v's column a is u's ua = C + a
// (a < 3, dp) or a - 3 (the features), u's column C + 3 the ones; element
// (a, b) of Svv is S's (ua, ub), read from the upper triangle (ua <= ub),
// Sv[a] S's (ua, C + 3). A warp an element: lane l sums parts l, l + 32,
// ... in order, then the lanes in a fixed tree.
__global__ void stats_reduce_kernel(const float* __restrict__ part, int P,
                                    int C, float* __restrict__ out) {
  const int W = C + 3, S = slice_of(C), ns = slices_of(C),
            lane = threadIdx.x & 31;
  const long long E = (long long)W + (long long)W * W;
  for (long long e = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       e < E; e += ((long long)gridDim.x * blockDim.x) >> 5) {
    int ua, ub;
    if (e < W) {
      ua = (int)e < 3 ? C + (int)e : (int)e - 3;
      ub = C + 3;
    } else {
      const int a = (int)((e - W) / W), b = (int)((e - W) % W);
      ua = a < 3 ? C + a : a - 3;
      ub = b < 3 ? C + b : b - 3;
    }
    if (ua > ub) {
      const int t = ua;
      ua = ub;
      ub = t;
    }
    size_t at;
    if (ub < C) {  // features by features
      const int si = ua / S, sj = ub / S;
      at = (size_t)pair_index(si, sj, ns) * P * kTs * kTs +
           (size_t)(ua - si * S) * kTs + (ub - sj * S);
    } else if (ua < C) {  // features by t, on the diagonal
      const int si = ua / S;
      at = (size_t)pair_index(si, si, ns) * P * kTs * kTs +
           (size_t)(ua - si * S) * kTs + 64 + (ub - C);
    } else {  // t by t, in block (0, 0)
      at = (size_t)(64 + ua - C) * kTs + 64 + (ub - C);
    }
    float s = 0.f;
    for (int i = lane; i < P; i += 32)
      s = __fadd_rn(s, part[at + (size_t)i * kTs * kTs]);
    for (int o = 16; o > 0; o >>= 1)
      s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
    if (lane == 0) out[e] = s;
  }
}

// ---- pass 2: the forward, 3xTF32 on the tensor cores ----------------------
typedef unsigned long long u64;

struct FArgs {
  const float *w1t, *a1, *nb1;  // w1t: W1^T, mid rows, Kd = W8
  const float* w2t;             // W2^T, cout rows, Kd = mid8
  float *new_xyz, *fi;          // (B, M, 3), (B, M, C)
  float *ymax, *ymin;           // (B, M, cout)
  uint8_t *amax, *amin;         // (B, M, cout)
  uint32_t* mask;               // (ceil(mid / 32), n)
  float* part;                  // (G, 2 cout): the block's sum y2, sum y2^2
  int mid, cout;
};

// A float as an unsigned integer of the same order (-0 taken as +0), and
// back.
__device__ __forceinline__ uint32_t ord_of(float v) {
  const uint32_t b = __float_as_uint(__fadd_rn(v, 0.f));
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}
__device__ __forceinline__ float float_of(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}
__device__ __forceinline__ uint32_t umax(uint32_t a, uint32_t b) {
  return a > b ? a : b;
}
__device__ __forceinline__ uint32_t umin(uint32_t a, uint32_t b) {
  return a < b ? a : b;
}
// (value, slot) as keys whose max is the max with the first slot, whose min
// is the min with the first slot
__device__ __forceinline__ u64 key_max(float v, int k) {
  return ((u64)ord_of(v) << 32) | (uint32_t)(255 - k);
}
__device__ __forceinline__ u64 key_min(float v, int k) {
  return ((u64)ord_of(v) << 32) | (uint32_t)k;
}

// The forward's shared memory, in floats: v, h, the weights (a ring of
// nring stages of kr k, or with nring = 0 both resident: W1^T's mid and W2^T's cout
// rows, each padded to a multiple of 64 rows of ld_rm(k) floats), the BN2
// sums' cross-warp step, the max / min keys of the
// tile's centers (64 columns a center, or every column where a ball takes
// several passes of RT rows), the tile's mask words and its rows.
struct FwdLayout {
  int ldv, ldh, tm, nkeys, nwords;
  size_t v, h, ring, w2, red, keys, wkeys, mask, rows, total;
};
__host__ __device__ inline int round64(int x) { return (x + 63) & ~63; }
__host__ __device__ inline FwdLayout fwd_layout(int RT, int K, int W, int mid,
                                                int cout, int nring,
                                                int kr) {
  FwdLayout L;
  L.ldv = ld_rm(round8(W));
  L.ldh = ld_rm(round8(mid));
  L.tm = K <= RT ? RT / K : 1;
  L.nkeys = K <= RT ? L.tm * kNC : round8(cout);
  L.nwords = (mid + 31) / 32;
  size_t o = 0;
  L.v = o;
  o += (size_t)RT * L.ldv;
  L.h = o;
  o += (size_t)RT * L.ldh;
  L.ring = o;  // the ring, or W1^T resident
  if (nring) {
    o += (size_t)nring * kNC * (kr + 8);
    L.w2 = o;
  } else {
    o += (size_t)round64(mid) * L.ldv;
    L.w2 = o;
    o += (size_t)round64(cout) * L.ldh;
  }
  L.red = o;
  o += (size_t)(RT / 32) * kNC * 2;
  L.keys = o;
  o += (size_t)L.nkeys * 4;  // two u64 a key
  L.wkeys = o;  // a row warp's keys of its ball (64 columns), its ball
  o += (size_t)(RT / 32) * kNC * 4 + 8;
  L.mask = o;
  o += (size_t)L.nwords * RT;
  L.rows = o;
  o += 4 * RT;  // a row's neighbour, center, slot and query
  L.total = o;
  return L;
}

// kRes: the weights resident in shared memory (nring = 0), loaded once;
// else streamed through the ring for every product. kBlocks: the blocks an
// SM holds; with one, a thread may keep 255 registers and a ring stage holds
// 128 k (half the stages and barriers a product).
template <int NT, bool kRes, int kBlocks>
__global__ void __launch_bounds__(kThreads, kBlocks)
fwd_kernel(Geo g, int nring, FArgs a) {
  constexpr int RT = 32 * NT;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int K = g.K, mid = a.mid, cout = a.cout;
  const int W8 = round8(g.W), mid8 = round8(mid);
  constexpr int KR = !kRes && kBlocks == 1 ? 128 : kKR;
  const FwdLayout L = fwd_layout(RT, K, g.W, mid, cout, nring, KR);
  float* V = sm + L.v;
  float* H = sm + L.h;
  float* ring = sm + L.ring;
  float* red = sm + L.red;
  // the block's BN2 sums, its slice of the workspace: column c's by thread
  // c % 64 alone
  float* mine = a.part + (size_t)blockIdx.x * 2 * cout;
  u64* kmax = reinterpret_cast<u64*>(sm + L.keys);
  u64* kmin = kmax + L.nkeys;
  u64* wmax = reinterpret_cast<u64*>(sm + L.wkeys);  // [row warp][64]
  u64* wmin = wmax + NT * kNC;
  int* wball = reinterpret_cast<int*>(wmin + NT * kNC);  // [row warp]
  uint32_t* smask = reinterpret_cast<uint32_t*>(sm + L.mask);
  int* sidx = reinterpret_cast<int*>(sm + L.rows);
  const int* scen = sidx + RT;
  const int* sk = scen + RT;
  const int* sq = sk + RT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool whole = K <= RT;  // a tile's balls take one pass of RT rows
  const int TM = L.tm, nsub = whole ? 1 : (K + RT - 1) / RT;
  const long long centers = (long long)g.B * g.M, n = centers * K;
  const long long tiles = (centers + TM - 1) / TM;
  const PassWarp w(RT);
  Acc acc;
  float* W1s = ring;  // the resident weights
  float* W2s = sm + L.w2;


  if (kRes) {  // landed before the first tile's gather is waited for
    for (int e = threadIdx.x; e < round64(mid) * (W8 / 4); e += kThreads) {
      const int r = e / (W8 / 4), c = 4 * (e % (W8 / 4));
      apt_sa::cp_async16(W1s + (size_t)r * L.ldv + c,
                         r < mid ? a.w1t + (size_t)r * W8 + c : a.w1t,
                         r < mid);
    }
    for (int e = threadIdx.x; e < round64(cout) * (mid8 / 4); e += kThreads) {
      const int r = e / (mid8 / 4), c = 4 * (e % (mid8 / 4));
      apt_sa::cp_async16(W2s + (size_t)r * L.ldh + c,
                         r < cout ? a.w2t + (size_t)r * mid8 + c : a.w2t,
                         r < cout);
    }
    apt_sa::cp_commit();
  }
  for (int e = threadIdx.x; e < L.nkeys; e += kThreads) {
    kmax[e] = 0ull;
    kmin[e] = ~0ull;
  }
  if (threadIdx.x < kNC)
    for (int c = threadIdx.x; c < cout; c += kNC) mine[c] = mine[cout + c] = 0.f;
  for (int e = threadIdx.x; e < L.nwords * RT; e += kThreads) smask[e] = 0u;
  // (the first product's barrier orders these before their first use)
  RowPre pre = prefetch_rows(g, n, (long long)blockIdx.x * TM * K, RT);
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long cfirst = t * TM;
    const int nc = (int)(centers - cfirst < TM ? centers - cfirst : TM);
    for (int sub = 0; sub < nsub; ++sub) {
      const long long row0 = cfirst * K + (long long)sub * RT;
      const int R = imin(RT, nc * K - sub * RT);
      gather_tile(g, R, RT, V, L.ldv, W8, sidx, pre);
      pre = prefetch_rows(
          g, n, sub + 1 < nsub ? row0 + RT : (t + gridDim.x) * TM * K, RT);
      if (sub == 0)  // new_xyz and fi, a warp a center
        for (int cl = warp; cl < nc; cl += kWarps) {
          const long long center = cfirst + cl;
          const size_t src = (size_t)(center / g.M) * g.N + sq[cl * K];
          if (lane < 3) a.new_xyz[center * 3 + lane] = g.xyz[src * 3 + lane];
          for (int ch = lane; ch < g.C; ch += 32)
            a.fi[center * g.C + ch] = g.feats[src * g.C + ch];
        }
      // the lane's four rows 16 i + g + 8 h (s = 2 i + h) and their center
      // in the tile (-1 past R), from the tile's rows in shared memory; and
      // whether the warp's 32 rows are one ball
      auto row_of = [&](int s) { return w.row(s >> 1, 2 * (s & 1)); };
      auto center_of = [&](int s) {
        const int r = row_of(s);
        return r < R ? (int)(scen[r] - cfirst) : -1;
      };
      const int cl0 = __shfl_sync(0xffffffffu, center_of(0), 0);
      const bool one = __all_sync(
          0xffffffffu, cl0 >= 0 && center_of(0) == cl0 &&
                           center_of(1) == cl0 && center_of(2) == cl0 &&
                           center_of(3) == cl0);
      if (w.wc == 0 && lane == 0) wball[w.wr] = one ? cl0 : -1;
      if (kRes) {  // the gather (and the weights) landed
        apt_sa::cp_wait<0>();
        __syncthreads();
      }
      // h = relu(a1 y1 + nb1) per 64 hidden channels, and its ReLU bits
      for (int j0 = 0; j0 < mid8; j0 += kNC) {
        if (kRes) {
          product_res<NT>(acc, V, L.ldv, W1s, L.ldv, mid, j0, W8);
        } else {
          product<NT, KR>(acc, V, L.ldv, a.w1t, mid, j0, W8, ring, nring);
        }
        uint32_t bits[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int c = j0 + w.col(j);
          if (c >= mid8) continue;
          float s1[2], s0[2];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            s1[q] = c + q < mid ? __ldg(a.a1 + c + q) : 0.f;
            s0[q] = c + q < mid ? __ldg(a.nb1 + c + q) : 0.f;
          }
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            float h[2];
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              h[q] = c + q < mid
                         ? bn_relu(acc[s >> 1][j][2 * (s & 1) + q], s1[q], s0[q])
                         : 0.f;
              if (h[q] > 0.f) bits[s] |= 1u << ((c + q) & 31);
            }
            *reinterpret_cast<float2*>(
                H + (size_t)w.row(s >> 1, 2 * (s & 1)) * L.ldh + c) =
                make_float2(h[0], h[1]);
          }
        }
        // a row's bits of the warp's 8 NT channels (one word's share) are
        // spread over the four lanes of its row group
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          bits[s] |= __shfl_xor_sync(0xffffffffu, bits[s], 1);
          bits[s] |= __shfl_xor_sync(0xffffffffu, bits[s], 2);
        }
        const int wd = (j0 + w.wc * 8 * NT) >> 5;
        if (w.t == 0)
#pragma unroll
          for (int s = 0; s < 4; ++s)
            if (row_of(s) < R && bits[s])
              atomicOr(smask + (size_t)wd * RT + row_of(s), bits[s]);
      }
      __syncthreads();  // h and the mask words are complete
      for (int e = threadIdx.x; e < L.nwords * RT; e += kThreads) {
        const int wd = e / RT, r = e % RT;
        if (r < R) a.mask[(size_t)wd * n + row0 + r] = smask[e];
        smask[e] = 0u;
      }
      // y2 = h W2 per 64 output channels, and its epilogues
      for (int c0 = 0; c0 < cout; c0 += kNC) {
        // the block's sums so far, loaded ahead of the chunk's readout
        const bool own = threadIdx.x < kNC && c0 + threadIdx.x < cout;
        float s1 = 0.f, s2 = 0.f;
        if (own) {
          s1 = mine[c0 + threadIdx.x];
          s2 = mine[cout + c0 + threadIdx.x];
        }
        if (kRes) {
          __syncthreads();  // the last chunk's sums and keys are read
          product_res<NT>(acc, H, L.ldh, W2s, L.ldh, cout, c0, mid8);
        } else {
          product<NT, KR>(acc, H, L.ldh, a.w2t, cout, c0, mid8, ring, nring);
        }
        // the epilogues on the accumulators; kOne: the warp's 32 rows are one
        // ball (every valid warp where K % 32 == 0), compiled without the
        // rows' tests
        auto epilogue = [&](auto one_c) {
          constexpr bool kOne = decltype(one_c)::value;
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              float t1 = 0.f, t2 = 0.f;  // BN2's sums over the lane's rows
#pragma unroll
              for (int s = 0; s < 4; ++s)
                if (kOne || row_of(s) < R) {
                  const float y = acc[s >> 1][j][2 * (s & 1) + q];
                  t1 = __fadd_rn(t1, y);
                  t2 = __fadd_rn(t2, __fmul_rn(y, y));
                }
#pragma unroll
              for (int o = 4; o < 32; o <<= 1) {
                t1 = __fadd_rn(t1, __shfl_xor_sync(0xffffffffu, t1, o));
                t2 = __fadd_rn(t2, __shfl_xor_sync(0xffffffffu, t2, o));
              }
              if (w.g == 0) {
                float* p = red + ((size_t)w.wr * kNC + w.col(j) + q) * 2;
                p[0] = t1;
                p[1] = t2;
              }
              const int c = c0 + w.col(j) + q;
              const int kb = whole ? c - c0 : c;  // the key's column
              if (kOne || one) {
                // the warp's rows g + 8 s are its ball's slots in order: the
                // max and the min as ordered keys over the lane's rows and
                // the row groups, then the first row holding each
                uint32_t o4[4];
#pragma unroll
                for (int s = 0; s < 4; ++s)
                  o4[s] = ord_of(acc[s >> 1][j][2 * (s & 1) + q]);
                uint32_t hv = umax(umax(o4[0], o4[1]), umax(o4[2], o4[3]));
                uint32_t lv = umin(umin(o4[0], o4[1]), umin(o4[2], o4[3]));
#pragma unroll
                for (int o = 4; o < 32; o <<= 1) {
                  hv = umax(hv, __shfl_xor_sync(0xffffffffu, hv, o));
                  lv = umin(lv, __shfl_xor_sync(0xffffffffu, lv, o));
                }
                int hr = 32, lr = 32;
#pragma unroll
                for (int s = 3; s >= 0; --s) {
                  if (o4[s] == hv) hr = w.g + 8 * s;
                  if (o4[s] == lv) lr = w.g + 8 * s;
                }
#pragma unroll
                for (int o = 4; o < 32; o <<= 1) {
                  hr = imin(hr, __shfl_xor_sync(0xffffffffu, hr, o));
                  lr = imin(lr, __shfl_xor_sync(0xffffffffu, lr, o));
                }
                if (w.g == 0 && c < cout) {  // the warp's own keys of its ball
                  const int k0 = sk[w.wr * 32];  // the warp's first slot
                  wmax[w.wr * kNC + c - c0] =
                      ((u64)hv << 32) | (uint32_t)(255 - k0 - hr);
                  wmin[w.wr * kNC + c - c0] = ((u64)lv << 32) | (uint32_t)(k0 + lr);
                }
              } else if (c < cout) {
#pragma unroll
                for (int s = 0; s < 4; ++s) {
                  const int cl = center_of(s);
                  if (cl < 0) continue;
                  const float y = acc[s >> 1][j][2 * (s & 1) + q];
                  const int e = (whole ? cl * kNC : 0) + kb, k = sk[row_of(s)];
                  atomicMax(kmax + e, key_max(y, k));
                  atomicMin(kmin + e, key_min(y, k));
                }
              }
            }
        };
        if (K % 32 == 0 && one)
          epilogue(std::true_type());
        else
          epilogue(std::false_type());
        __syncthreads();
        // the chunk's sums into the block's, row warps in order
        if (own) {
          float u1 = 0.f, u2 = 0.f;
          for (int wr = 0; wr < NT; ++wr) {
            u1 = __fadd_rn(u1, red[((size_t)wr * kNC + threadIdx.x) * 2]);
            u2 = __fadd_rn(u2, red[((size_t)wr * kNC + threadIdx.x) * 2 + 1]);
          }
          mine[c0 + threadIdx.x] = __fadd_rn(s1, u1);
          mine[cout + c0 + threadIdx.x] = __fadd_rn(s2, u2);
        }
        // the keys of each (center, column): the shared ones (rows of warps
        // that hold several balls) and those of the warps holding one ball
        for (int e = threadIdx.x; e < (whole ? TM * kNC : kNC);
             e += kThreads) {
          const int cl_ = whole ? e / kNC : 0, cc = e % kNC, c = c0 + cc;
          const int ke = whole ? e : c;
          if (c < cout) {
            u64 hx = kmax[ke], lx = kmin[ke];
            for (int wr = 0; wr < NT; ++wr)
              if (wball[wr] == cl_) {
                hx = hx > wmax[wr * kNC + cc] ? hx : wmax[wr * kNC + cc];
                lx = lx < wmin[wr * kNC + cc] ? lx : wmin[wr * kNC + cc];
              }
            if (whole && cl_ < nc) {
              const size_t o = (size_t)(cfirst + cl_) * cout + c;
              a.ymax[o] = float_of((uint32_t)(hx >> 32));
              a.amax[o] = (uint8_t)(255 - (uint32_t)hx);
              a.ymin[o] = float_of((uint32_t)(lx >> 32));
              a.amin[o] = (uint8_t)(uint32_t)lx;
            }
            kmax[ke] = whole ? 0ull : hx;
            kmin[ke] = whole ? ~0ull : lx;
          } else if (whole) {
            kmax[ke] = 0ull;
            kmin[ke] = ~0ull;
          }
        }
      }
    }
    if (!whole) {  // one ball, every column
      __syncthreads();
      for (int c = threadIdx.x; c < cout; c += kThreads) {
        const size_t o = (size_t)cfirst * cout + c;
        a.ymax[o] = float_of((uint32_t)(kmax[c] >> 32));
        a.amax[o] = (uint8_t)(255 - (uint32_t)kmax[c]);
        a.ymin[o] = float_of((uint32_t)(kmin[c] >> 32));
        a.amin[o] = (uint8_t)(uint32_t)kmin[c];
        kmax[c] = 0ull;
        kmin[c] = ~0ull;
      }
    }
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

// Shared memory (bytes) of a pass at its tile of RT rows.
size_t smem_bytes(int kind, int tile, int K, int W, int mid, int cout,
                  int ring = 2) {
  if (kind == kStats) {
    // kDepth tiles of the x slice and the coordinates, and of the y slice
    // where there are two slices; after the last tile, three groups'
    // partial sums
    const int S = slice_of(W - 3);
    const size_t f = (size_t)kDepth * tile *
                     (S + 4 + (slices_of(W - 3) > 1 ? S : 0));
    const size_t g = S == 32 ? StatsShape<32>::kStage : StatsShape<64>::kStage;
    return (f > g ? f : g) * 4;
  }
  if (kind == kFwd) {  // 128-k ring stages where two blocks do not fit
    const size_t b = fwd_layout(tile, K, W, mid, cout, ring, kKR).total * 4;
    return ring && b > kSmemTwo
               ? fwd_layout(tile, K, W, mid, cout, ring, 128).total * 4
               : b;
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

// The instance of a pass's kernel for its tile (RT = 32 NT rows), ring (the
// forward's 0: resident weights) and shared memory (the forward's ring
// instance for one block an SM where two do not fit).
const void* kernel_of(int kind, int tile, int ring, size_t smem) {
  const int nt = tile / 32;
  switch (kind) {
    case kStats: return (const void*)stats_kernel<64>;
    case kFwd:
      if (ring == 0)
        return nt == 4 ? (const void*)fwd_kernel<4, true, 2>
               : nt == 2 ? (const void*)fwd_kernel<2, true, 2>
                         : (const void*)fwd_kernel<1, true, 2>;
      if (smem > kSmemTwo)
        return nt == 4 ? (const void*)fwd_kernel<4, false, 1>
               : nt == 2 ? (const void*)fwd_kernel<2, false, 1>
                         : (const void*)fwd_kernel<1, false, 1>;
      return nt == 4 ? (const void*)fwd_kernel<4, false, 2>
             : nt == 2 ? (const void*)fwd_kernel<2, false, 2>
                       : (const void*)fwd_kernel<1, false, 2>;
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

// Launches a pass's kernel instance for RT = 32 NT rows.
template <int NT>
void launch_fwd(int grid, size_t smem, cudaStream_t st, const Geo& g,
                int nring, const FArgs& a) {
  if (nring == 0)
    fwd_kernel<NT, true, 2><<<grid, kThreads, smem, st>>>(g, nring, a);
  else if (smem > kSmemTwo)
    fwd_kernel<NT, false, 1><<<grid, kThreads, smem, st>>>(g, nring, a);
  else
    fwd_kernel<NT, false, 2><<<grid, kThreads, smem, st>>>(g, nring, a);
}
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

// Bytes of shared memory a block of pass `kind` takes at RT = tile rows and
// `ring` weight stages (ops/satrainbn.py smem_bytes is the host's copy).
long long sa_trainbn_smem_bytes(int kind, int tile, int K, int C, int mid,
                                int cout, int ring) {
  return (long long)smem_bytes(kind, tile, K, C + 3, mid, cout, ring);
}

// The tile and the grid (G blocks) a pass runs with at these shapes: kind 0
// stats (tile: RT rows a block, or force_rows; ring: P, the parts the
// rows are cut into, G = P times the output blocks), 1 forward (tile: RT
// rows a block, whole balls), 2 and 3 the two kernels of bwd_w2, 4 bwd_x
// (tile: RT rows a block); for 1-4 RT is 128, 64 or 32: force_rows where it
// fits shared memory, else as below, and ring the weight ring's stages (the
// forward's 0: both weights resident, where they fit beside two blocks an
// SM, or beside one at force_rows). The caller sizes the workspaces from
// them. Returns cudaError_t.
int sa_trainbn_plan(int kind, int B, int M, int K, int C, int mid, int cout,
                    int force_rows, int* tile, int* grid, int* ring) {
  if (B <= 0 || M <= 0 || K <= 0 || K > 255 || C < 0 || mid <= 0 ||
      cout <= 0 || kind < kStats || kind > kBwdX)
    return cudaErrorInvalidValue;
  if (force_rows != 0 && force_rows != 32 && force_rows != 64 &&
      force_rows != 128)
    return cudaErrorInvalidValue;
  const int W = C + 3;
  const long long n = (long long)B * M * K;
  if (n > 0x7fffffffLL) return cudaErrorInvalidValue;
  const auto fits = [&](int rt, size_t cap) {
    return smem_bytes(kind, rt, K, W, mid, cout) <= cap;
  };
  // the forward's weights resident: no ring, no barrier a weight stage
  const auto fits_res = [&](int rt, size_t cap) {
    return kind == kFwd && smem_bytes(kind, rt, K, W, mid, cout, 0) <= cap;
  };
  int t = 0;
  bool res = false;
  if (kind == kStats) {  // 128 rows where one slice, else 64: two blocks
    t = force_rows ? force_rows : slices_of(C) == 1 ? 128 : 64;
  } else if (force_rows && fits_res(force_rows, kSmemLimit)) {
    t = force_rows;
    res = true;
  } else if (!force_rows && fits_res(128, kSmemTwo)) {
    t = 128;
    res = true;
  } else if (!force_rows && fits_res(64, kSmemTwo)) {
    t = 64;
    res = true;
  } else if (force_rows && fits(force_rows, kSmemLimit)) {
    t = force_rows;
  } else if (fits(128, kSmemTwo)) {
    // two blocks an SM hide each other's waits: 128 rows where two fit,
    // else 64 where two fit, else the most rows one block takes
    t = 128;
  } else if (fits(64, kSmemTwo)) {
    t = 64;
  } else {
    t = 128;
    while (t > 32 && !fits(t, kSmemLimit)) t /= 2;
  }
  // the weight ring: as deep as fits beside two blocks an SM where two
  // fit, else beside one
  int nr = res ? 0 : 2;
  if (kind != kStats && !res) {
    const size_t cap = smem_bytes(kind, t, K, W, mid, cout, 2) <= kSmemTwo
                           ? kSmemTwo : kSmemLimit;
    while (nr < kMaxRing && smem_bytes(kind, t, K, W, mid, cout, nr + 1) <= cap)
      ++nr;
  }
  const size_t smem = smem_bytes(kind, t, K, W, mid, cout, nr);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  const void* fn = kind == kStats && slice_of(C) == 32
                       ? (const void*)stats_kernel<32>
                       : kernel_of(kind, t, nr, smem);
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
  const long long slots = (long long)imax(per_sm, 1) * sms;
  if (kind == kStats) {
    const int ns = slices_of(C), pairs = ns * (ns + 1) / 2;
    const long long tiles = (n + t - 1) / t;
    long long P = (slots + pairs - 1) / pairs;
    if (P > tiles) P = tiles;
    *tile = t;
    *grid = (int)(P * pairs);
    *ring = (int)P;
    return cudaSuccess;
  }
  const long long tiles =
      kind == kFwd ? ((long long)B * M + (K <= t ? t / K : 1) - 1) /
                         (K <= t ? t / K : 1)
                   : (n + t - 1) / t;
  *tile = t;
  *grid = (int)(slots < tiles ? slots : tiles);
  *ring = nr;
  return cudaSuccess;
}

// Pass 1. xyz (B,N,3), qidx (B,M) i32, feats (B,N,C) f32 contiguous ->
// idx (B,M,K) i32 and out [W + W*W] = (Sv, Svv row-major); RT, G, P from
// sa_trainbn_plan; part is the workspace of G * 68 * 68 floats.
int sa_trainbn_stats_launch(const float* xyz, const int* qidx,
                            const float* feats, int B, int N, int M, int C,
                            int K, float r2, float dp_scale, int relative,
                            int RT, int G, int P, int* idx, float* part,
                            float* out, cudaStream_t stream) {
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
  const int vec = C % 4 == 0 && (reinterpret_cast<size_t>(feats) & 15) == 0;
  const size_t smem = smem_bytes(kStats, RT, K, g.W, 1, 1);
  if (slice_of(C) == 32)
    stats_kernel<32><<<G, kThreads, smem, stream>>>(g, RT, P, vec, part);
  else
    stats_kernel<64><<<G, kThreads, smem, stream>>>(g, RT, P, vec, part);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long E = (long long)g.W + (long long)g.W * g.W;
  stats_reduce_kernel<<<(int)((E + kWarps - 1) / kWarps < 8192
                                  ? (E + kWarps - 1) / kWarps : 8192),
                        kThreads, 0, stream>>>(part, P, C, out);
  return cudaGetLastError();
}

// Pass 2. w1 (W, mid), a1, nb1 (mid), w2 (mid, cout) f32 -> new_xyz
// (B,M,3), fi (B,M,C), ymax, ymin (B,M,cout) f32, amax, amin (B,M,cout) u8,
// mask (ceil(mid/32), B*M*K) u32, out [2 * cout] = (sum y2, sum y2^2); RT,
// G, ring from sa_trainbn_plan; wt: the weight copies W1^T (mid * W8
// floats) and W2^T (cout * mid8), written here and handed to bwd_w2; part:
// G * 2 * cout floats.
int sa_trainbn_fwd_launch(const float* xyz, const int* qidx,
                          const float* feats, const int* idx, int B, int N,
                          int M, int C, int K, float dp_scale, int relative,
                          const float* w1, const float* a1, const float* nb1,
                          const float* w2, int mid, int cout, int RT, int G,
                          int ring, float* wt, float* new_xyz, float* fi,
                          float* ymax, float* ymin, uint8_t* amax,
                          uint8_t* amin, uint32_t* mask, float* part,
                          float* out, cudaStream_t stream) {
  const Geo g = make_geo(xyz, qidx, feats, idx, B, N, M, C, K, dp_scale,
                         relative);
  const int W8 = round8(g.W), mid8 = round8(mid);
  FArgs a;
  a.w1t = wt; a.w2t = wt + (size_t)mid * W8; a.a1 = a1; a.nb1 = nb1;
  a.new_xyz = new_xyz; a.fi = fi; a.ymax = ymax; a.ymin = ymin;
  a.amax = amax; a.amin = amin; a.mask = mask; a.part = part;
  a.mid = mid; a.cout = cout;
  cudaError_t e = weight_rows(w1, mid, g.W, 1, W8, wt, stream);
  if (e != cudaSuccess) return e;
  e = weight_rows(w2, cout, mid, 1, mid8, const_cast<float*>(a.w2t), stream);
  if (e != cudaSuccess) return e;
  const size_t smem = smem_bytes(kFwd, RT, K, g.W, mid, cout, ring);
  if (RT == 128)
    launch_fwd<4>(G, smem, stream, g, ring, a);
  else if (RT == 64)
    launch_fwd<2>(G, smem, stream, g, ring, a);
  else
    launch_fwd<1>(G, smem, stream, g, ring, a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return reduce(part, G, 2LL * cout, out, stream);
}

// Pass 3, two kernels, after a weight_rows_kernel launch. w2 (mid, cout)
// f32; a1, nb1, mu1, r1 (mid) and a2, p2, q2c (cout) per-channel rows; mask
// (ceil(mid/32), B*M*K) u32 the forward's ReLU; slot (B,M,cout) u8 the
// winning slot, gout (B,M,cout) the pooled cotangent. wt: the forward's
// weight copies W1^T, W2^T (mid * W8 + cout * mid8 floats, X8 = round8(X));
// w2p: mid * cout8 floats, W2's copy, made here. Writes y1 and gy1 = g_y1'
// ((B*M*K, mid8) each), gy2 (B*M*K, cout8) scratch, dw2 [mid * cout]
// (16-byte aligned; zeroed here) and sums [2 * mid] = (sum g_y1', sum g_y1'
// xhat1) through the workspace part (grid_b * 2 * mid).
int sa_trainbn_bwd_w2_launch(
    const float* xyz, const int* qidx, const float* feats, const int* idx,
    int B, int N, int M, int C, int K, float dp_scale, int relative,
    const float* w2, const float* a1, const float* nb1, const uint32_t* mask,
    const float* a2, const float* p2, const float* q2c, const uint8_t* slot,
    const float* gout, const float* mu1, const float* r1, int mid, int cout,
    int rt_a, int grid_a, int rt_b, int grid_b, int ring_a, int ring_b,
    const float* wt, float* w2p, float* y1, float* gy2, float* gy1,
    float* dw2_part, float* dw2, float* part, float* sums,
    cudaStream_t stream) {
  const Geo g = make_geo(xyz, qidx, feats, idx, B, N, M, C, K, dp_scale,
                         relative);
  const int W8 = round8(g.W), cout8 = round8(cout);
  W2Args a;
  a.w1t = wt;
  a.w2t = wt + (size_t)mid * W8;
  a.w2p = w2p;
  a.a1 = a1; a.nb1 = nb1; a.mask = mask; a.a2 = a2; a.p2 = p2; a.q2c = q2c;
  a.slot = slot; a.gout = gout; a.mu1 = mu1; a.r1 = r1; a.y1 = y1;
  a.gy2 = gy2; a.gy1 = gy1; a.mid = mid; a.cout = cout;
  cudaError_t e = weight_rows(w2, mid, cout, 0, cout8, w2p, stream);
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
