// Flash self-attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels adaptpoint_tpu/ops/pallas/attention.py _mha_call
// (_fwd_kernel) and _mha_bwd (_bwd_kernel). Same functions as the plain
// versions ops/attention.py mha_plain and mha_bwd_plain, over flattened
// heads q, k, v (BH, N, d), d in {16, 32, 64}, any N >= 1:
//   S = bf16(q) bf16(k)^T / scale        f32 accumulate
//   P = softmax(S)                        f32, max-subtracted, normalised
//   out = bf16(P) bf16(v)                 f32 accumulate, f32 output
//   dv = bf16(P)^T bf16(do)
//   dP = bf16(do) bf16(v)^T
//   dS = P (dP - rowsum(dP * P)) / scale  P unrounded
//   dq = bf16(dS) bf16(k),  dk = bf16(dS)^T bf16(q)     in q's type
// The operand rounding is part of the function, so the products are
// mma.sync m16n8k16 with bf16 operands and f32 accumulators; the (N, N)
// logits live in registers only.
//
// What bounds it on the H100: the special-function unit and the issue of
// the instructions around each exp. P is normalised BEFORE it is rounded to
// bf16, so no P can be rounded until its row's sum is known: the forward
// takes two passes over the keys, 2 exps an element (the first for the row
// sum, the second for P), where a one-pass online softmax takes 1 but
// rounds unnormalised exps, another function. The backward needs 1 exp an
// element. At (128, 2048, 16) that is 1.07e9 exps forward and 0.54e9
// backward against 16 exps a clock on each of 132 SMs (0.26 and 0.13 ms at
// 1.98 GHz); bytes (25 MB) and the tensor cores (34 GFLOP forward, 86
// backward) weigh less. The forward issues some 11 other instructions an
// element (pass 1: max, fma, sum; pass 2: fma, normalising multiply, two
// bf16 packs, P_lo and three products), the backward some 8, so the design
// counts them. One exp is ex2.approx of one explicit __fmaf_rn(acc,
// log2(e) / scale, row_off) on the raw product q.k (the file builds with
// -fmad=false): the forward's pass 2 and the backward form P =
// ex2(fma) * row_inv from the same saved row_off = -log2(e) max_j S_ij and
// row_inv = 1 / sum_j exp(S_ij - max), so the backward's P is the forward's.
//
// Forward. A block of 8 warps owns 128 query rows (16 a warp, whose Q
// fragments stay in registers) and streams 128-key tiles of bf16 K (pass 1)
// and K, V (pass 2) through a ring of 3 shared-memory stages filled by
// cp.async (16 bytes a thread, zero-filled past N, rows padded by 16 bytes
// so that ldmatrix is free of bank conflicts): the copy of tile i + 2
// overlaps the math of tile i, with one __syncthreads a tile. f32 inputs are
// cast to bf16 once a call by a prologue kernel (into a scratch the wrapper
// allocates). Both passes walk a tile 16 keys at a time, so that no tile of
// S is held in registers and three blocks fit on an SM at d = 16. Pass 1
// does the S product, the row max and the exp-sum only, the sum against a
// reference max from before the tile: where the tile's max exceeds the
// reference by 2^8 (the first tile; later ones rarely) the warp rescales
// the sum and recomputes that tile against the new reference, so no f32
// sum overflows and the rescaling exp is rare; a last exp brings the sum to
// the true max. A quarter of pass 1's exps as a polynomial on the FMA pipe
// (the FlashAttention-4 trick; the sum needs f32 accuracy, not P's) was
// measured slower on the H100 (PERF.md) and is not used: the exps are not
// what binds. Pass 2 recomputes S, forms P, rounds it, and
// multiplies by V, whose B fragments come from ldmatrix.trans on the
// row-major tile; with the backward's extras also P_lo = bf16(P -
// bf16(P)), so o32 = (P_hi + P_lo) V carries 16 bits of P for the
// backward's rowsum(dP * P) = bf16(do) . o32. Only the ragged last key tile
// masks: each pass body is compiled for full tiles and for that one.
// mma.sync m16n8k16 stays: at d = 16 the products are 0.035 ms of
// tensor-core time at the bound, and the accumulator layout of S is the
// A-fragment layout of the next product, so P never leaves registers;
// wgmma needs 64-row warpgroup tiles and would not move the exp bound.
//
// Backward. A pre-pass writes bf16(do) and, per query row, {row_off,
// row_inv, delta} with delta = bf16(do) . o32. The main kernel gives a block
// 256 keys at d <= 32 (32 a warp, as two 16-row A tiles of K and of V in
// registers; 128 keys at d = 64, where the registers allow one tile), V /
// scale where scale is a power of two, which folds the division into the
// product exactly, and walks the query tiles of 64 through the same ring
// (Q, dO and the row statistics). Per element: S^T and dP^T from two
// products, 1 exp, dS = P (dP - delta) / scale; dv += bf16(P)^T dO and
// dk += bf16(dS)^T Q from registers, B fragments by ldmatrix.trans. dq needs
// a sum over the key blocks, option (a) of the redesign: each block stores
// bf16(dS) to shared memory (stmatrix.trans gives the query-major tile),
// and its 8 warps multiply it by the block's K tile into the block's own
// slice of an f32 workspace [BH, key blocks, N, d]; a last kernel sums the
// slices in key-block order and rounds to q's type. No atomics: the result
// is bit-reproducible, the pattern of the fused train-BN kernels. The
// workspace is 134 MB at (128, 2048, 16), written once and read once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;              // bf16 of padding per staged row
constexpr int kStages = 3;           // ring depth
constexpr int kFwdRows = 16 * kWarps;  // queries a forward block owns
constexpr int kFwdKeys = 128;          // keys a forward tile stages
constexpr int kBwdQueries = 64;        // queries a backward tile
// 16-row tiles of keys a backward warp owns: two where the registers allow
__host__ __device__ constexpr int bwd_mtiles(int D) { return D <= 32 ? 2 : 1; }
__host__ __device__ constexpr int bwd_keys(int D) {
  return 16 * bwd_mtiles(D) * kWarps;
}
constexpr float kRefStep = 8.0f;  // pass 1 rescales when the max moves by 2^8

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros where !full.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void ldm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void stm_x4_t(void* p, const uint32_t (&r)[4]) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1,%2,%3,%4};\n"
      ::"r"(smem_u32(p)), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
      : "memory");
}

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit (about 2 ulp, 0 for -inf, subnormal
// results flushed to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float lo_of(uint32_t u) {
  return __uint_as_float(u << 16);
}

__device__ __forceinline__ float hi_of(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ void store2(void* base, int bf16_out, size_t off,
                                       float a, float b) {
  if (bf16_out) {
    *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(base) + off) =
        __floats2bfloat162_rn(a, b);
  } else {
    *reinterpret_cast<float2*>(static_cast<float*>(base) + off) =
        make_float2(a, b);
  }
}

// A fragments of rows row0 .. row0 + 15 of a bf16 (N, D) matrix in global
// memory (rows >= N as zeros).
template <int D>
__device__ __forceinline__ void load_a(const bf16* src, int row0, int N,
                                       uint32_t (&a)[D / 16][4]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = row0 + g + 8 * rr;
        a[ks][2 * h + rr] =
            row < N ? *reinterpret_cast<const uint32_t*>(
                          src + (size_t)row * D + 16 * ks + 8 * h + 2 * t)
                    : 0u;
      }
}

// Rows row0 .. row0 + kRows - 1 of a (N, D) bf16 matrix into a shared tile
// [kRows][D + kPad], zeros past N; the caller commits the group.
template <int D, int kRows>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           int row0, int N) {
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
  constexpr int kAll = kRows * kChunks;
#pragma unroll
  for (int it = 0; it < (kAll + kThreads - 1) / kThreads; ++it) {
    const int e = threadIdx.x + it * kThreads;
    if (kAll % kThreads == 0 || e < kAll) {
      const int r = e / kChunks, cc = (e % kChunks) * 8;
      const bool in = row0 + r < N;
      cp_async16(dst + r * (D + kPad) + cc,
                 src + (size_t)(in ? row0 + r : 0) * D + cc, in);
    }
  }
}

// B fragments of the rows 16 j .. 16 j + 15 of a staged row-major tile as
// the n side of a product over D: b[ks] = {b0, b1} of rows 16 j .. + 7,
// {b0, b1} of rows 16 j + 8 .. + 15, for the k-step ks.
template <int D>
__device__ __forceinline__ void ldm_rows(uint32_t (&b)[D / 16][4],
                                         const bf16* tile, int j) {
  const int lane = threadIdx.x & 31;
  const bf16* p = tile + (16 * j + (lane & 7) + ((lane >> 4) << 3)) *
                             (D + kPad) + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) ldm_x4(b[ks], p + 16 * ks);
}

// B fragments of the rows 16 j .. 16 j + 15 of a staged row-major tile as
// the k side of a product into D columns: b[np] = {b0, b1} of columns
// 16 np .. + 7, {b0, b1} of columns 16 np + 8 .. + 15.
template <int D>
__device__ __forceinline__ void ldm_cols(uint32_t (&b)[D / 16][4],
                                         const bf16* tile, int j) {
  const int lane = threadIdx.x & 31;
  const bf16* p = tile + (16 * j + (lane & 7) + ((lane >> 3) & 1) * 8) *
                             (D + kPad) + (lane >> 4) * 8;
#pragma unroll
  for (int np = 0; np < D / 16; ++np) ldm_x4_t(b[np], p + 16 * np);
}

// acc[nd] (16 x 8, nd < D / 8) += A (16 x 16) times the 16 x D B fragments
__device__ __forceinline__ void mul_cols_acc(float (*acc)[4],
                                             const uint32_t (&a)[4],
                                             const uint32_t (*b)[4], int np2) {
#pragma unroll
  for (int np = 0; np < np2; ++np) {
    mma16816(acc[2 * np], a, b[np][0], b[np][1]);
    mma16816(acc[2 * np + 1], a, b[np][2], b[np][3]);
  }
}

// ---------------------------------------------------------------- forward
template <int D>
constexpr int fwd_smem_bytes() {
  return kStages * 2 * kFwdKeys * (D + kPad) * 2;
}

template <int D, bool kO32>
__global__ void __launch_bounds__(kThreads, D == 16 ? 3 : D == 32 ? 2 : 1)
mha_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, int N, int qblocks, float c,
               float ref_step, float* __restrict__ out,
               float* __restrict__ o32, float* __restrict__ row_off,
               float* __restrict__ row_inv) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kTile = kFwdKeys * (D + kPad);
  constexpr int kNt = kFwdKeys / 8;  // column groups of 8 keys a tile
  // 16-key steps unrolled at once: all of a tile's, or four where the
  // backward's extras would otherwise spill registers
  constexpr int kUnroll = kO32 ? 4 : kNt / 2;
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);  // stages x {K, V}
  const int bh = blockIdx.x / qblocks;
  const int q0 = (blockIdx.x % qblocks) * kFwdRows;
  const size_t base = (size_t)bh * N * D;
  const bf16* K = k + base;
  const bf16* V = v + base;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + warp * 16;
  const int T = (N + kFwdKeys - 1) / kFwdKeys;

  // the tile sequence: i < T is K tile i (pass 1), T <= i < 2T K and V tile
  // i - T (pass 2); past the end an empty group keeps the count uniform
  auto stage = [&](int i) {
    if (i < 2 * T) {
      bf16* dst = ring + (i % kStages) * 2 * kTile;
      const int key0 = (i < T ? i : i - T) * kFwdKeys;
      stage_rows<D, kFwdKeys>(dst, K, key0, N);
      if (i >= T) stage_rows<D, kFwdKeys>(dst + kTile, V, key0, N);
    }
    cp_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) stage(i);

  uint32_t qa[D / 16][4];
  load_a<D>(q + base, r0, N, qa);

  // pass 1: per row the true max and the exp-sum relative to a reference
  // mref, streamed 16 keys at a time (no tile of S held in registers). The
  // exps of a tile use the reference from before it; where the tile's max
  // exceeds that by 2^8 (the first tile, rarely a later one) the warp
  // recomputes the tile against the new reference. A tile body is compiled
  // for full tiles and for the ragged last one, so that only the latter
  // masks.
  float mref[2] = {-INFINITY, -INFINITY}, mtrue[2] = {-INFINITY, -INFINITY};
  float off1[2] = {0.0f, 0.0f}, l[2] = {0.0f, 0.0f};
  // per row this thread's part of the tile's exp-sum against off1, and the
  // tile's max
  auto tile_sum = [&](const bf16* Ks, int key0, auto ragged, float (&sum)[2],
                      float (&mx)[2]) {
    constexpr bool kRagged = decltype(ragged)::value;
    float sp[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
    float mp[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};
#pragma unroll(kUnroll)
    for (int j = 0; j < kNt / 2; ++j) {
      uint32_t b[D / 16][4];
      ldm_rows<D>(b, Ks, j);
      float s[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        mma16816(s[0], qa[ks], b[ks][0], b[ks][1]);
        mma16816(s[1], qa[ks], b[ks][2], b[ks][3]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[h][e];
          if (kRagged && key0 + 16 * j + 8 * h + 2 * t + (e & 1) >= N)
            x = -INFINITY;
          mp[e >> 1][h] = fmaxf(mp[e >> 1][h], x);
          sp[e >> 1][h] += ex2(__fmaf_rn(x, c, off1[e >> 1]));
        }
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      sum[rr] = sp[rr][0] + sp[rr][1];
      mx[rr] = quad_max(fmaxf(mp[rr][0], mp[rr][1]));
    }
  };
  auto pass1 = [&](const bf16* Ks, int key0, auto ragged) {
    float sum[2], tmax[2];
    tile_sum(Ks, key0, ragged, sum, tmax);
    bool stale[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mtrue[rr] = fmaxf(mtrue[rr], tmax[rr]);
      stale[rr] = tmax[rr] > mref[rr] + ref_step;  // every tile has a key
    }
    if (__any_sync(0xffffffffu, stale[0] || stale[1])) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
        if (stale[rr]) {
          l[rr] *= ex2(__fmul_rn(mref[rr] - tmax[rr], c));
          mref[rr] = tmax[rr];
          off1[rr] = -__fmul_rn(tmax[rr], c);
        }
      float again[2], unused[2];
      tile_sum(Ks, key0, ragged, again, unused);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
        if (stale[rr]) sum[rr] = again[rr];
    }
    l[0] += sum[0];
    l[1] += sum[1];
  };
  for (int i = 0; i < T; ++i) {
    cp_wait<kStages - 2>();
    __syncthreads();
    stage(i + kStages - 1);
    const bf16* Ks = ring + (i % kStages) * 2 * kTile;
    const int key0 = i * kFwdKeys;
    if (key0 + kFwdKeys > N)
      pass1(Ks, key0, std::true_type());
    else
      pass1(Ks, key0, std::false_type());
  }
  float off[2], inv[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const float sum =
        quad_sum(l[rr]) * ex2(__fmul_rn(mref[rr] - mtrue[rr], c));
    off[rr] = -__fmul_rn(mtrue[rr], c);
    inv[rr] = __frcp_rn(sum);
  }

  // pass 2: P = ex2(fma) * row_inv, rounded to bf16, times V
  float o[D / 8][4], olo[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = olo[nd][e] = 0.0f;
  auto pass2 = [&](const bf16* Ks, int key0, auto ragged) {
    constexpr bool kRagged = decltype(ragged)::value;
    const bf16* Vs = Ks + kTile;
#pragma unroll(kUnroll)
    for (int j = 0; j < kNt / 2; ++j) {
      uint32_t b[D / 16][4], bv[D / 16][4];
      ldm_rows<D>(b, Ks, j);
      ldm_cols<D>(bv, Vs, j);
      float s[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        mma16816(s[0], qa[ks], b[ks][0], b[ks][1]);
        mma16816(s[1], qa[ks], b[ks][2], b[ks][3]);
      }
      float p[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = __fmaf_rn(s[h][e], c, off[e >> 1]);
          if (kRagged && key0 + 16 * j + 8 * h + 2 * t + (e & 1) >= N)
            x = -INFINITY;
          p[h][e] = __fmul_rn(ex2(x), inv[e >> 1]);
        }
      const uint32_t pa[4] = {pack2(p[0][0], p[0][1]), pack2(p[0][2], p[0][3]),
                              pack2(p[1][0], p[1][1]), pack2(p[1][2], p[1][3])};
      mul_cols_acc(o, pa, bv, D / 16);
      if constexpr (kO32) {
        const uint32_t la[4] = {
            pack2(p[0][0] - lo_of(pa[0]), p[0][1] - hi_of(pa[0])),
            pack2(p[0][2] - lo_of(pa[1]), p[0][3] - hi_of(pa[1])),
            pack2(p[1][0] - lo_of(pa[2]), p[1][1] - hi_of(pa[2])),
            pack2(p[1][2] - lo_of(pa[3]), p[1][3] - hi_of(pa[3]))};
        mul_cols_acc(olo, la, bv, D / 16);
      }
    }
  };
  for (int i = T; i < 2 * T; ++i) {
    cp_wait<kStages - 2>();
    __syncthreads();
    stage(i + kStages - 1);
    const bf16* Ks = ring + (i % kStages) * 2 * kTile;
    const int key0 = (i - T) * kFwdKeys;
    if (key0 + kFwdKeys > N)
      pass2(Ks, key0, std::true_type());
    else
      pass2(Ks, key0, std::false_type());
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = r0 + g + 8 * rr;
    if (row >= N) continue;
    const size_t at = base + (size_t)row * D + 2 * t;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      *reinterpret_cast<float2*>(out + at + 8 * nd) =
          make_float2(o[nd][2 * rr], o[nd][2 * rr + 1]);
      if (kO32)
        *reinterpret_cast<float2*>(o32 + at + 8 * nd) =
            make_float2(o[nd][2 * rr] + olo[nd][2 * rr],
                        o[nd][2 * rr + 1] + olo[nd][2 * rr + 1]);
    }
    if (t == 0) {
      row_off[(size_t)bh * N + row] = off[rr];
      row_inv[(size_t)bh * N + row] = inv[rr];
    }
  }
}

// f32 q, k, v -> bf16 copies, 4 elements a thread; blockIdx.y picks the
// matrix
__global__ void mha_cast_bf16_kernel(const float* __restrict__ q,
                                 const float* __restrict__ k,
                                 const float* __restrict__ v,
                                 bf16* __restrict__ dst, size_t n4) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const float* src = blockIdx.y == 0 ? q : blockIdx.y == 1 ? k : v;
  const float4 x = reinterpret_cast<const float4*>(src)[i];
  uint2 y;
  y.x = pack2(x.x, x.y);
  y.y = pack2(x.z, x.w);
  reinterpret_cast<uint2*>(dst + blockIdx.y * n4 * 4)[i] = y;
}

// ------------------------------------------------------ backward pre-pass
// Per row: bf16(do) and {row_off, row_inv, delta (/ scale where scale is a
// power of two), 0}, delta = bf16(do) . o32.
template <int D>
__global__ void mha_bwd_prep_kernel(const float* __restrict__ dout,
                                    const float* __restrict__ o32,
                                    const float* __restrict__ row_off,
                                    const float* __restrict__ row_inv,
                                    size_t rows, float delta_mul,
                                    bf16* __restrict__ dob,
                                    float4* __restrict__ stats) {
  const size_t r = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const float4* d4 = reinterpret_cast<const float4*>(dout + r * D);
  const float4* o4 = reinterpret_cast<const float4*>(o32 + r * D);
  uint2* b2 = reinterpret_cast<uint2*>(dob + r * D);
  float dl = 0.0f;
#pragma unroll
  for (int cc = 0; cc < D / 4; ++cc) {
    const float4 d = d4[cc], o = o4[cc];
    uint2 b;
    b.x = pack2(d.x, d.y);
    b.y = pack2(d.z, d.w);
    b2[cc] = b;
    dl += lo_of(b.x) * o.x + hi_of(b.x) * o.y + lo_of(b.y) * o.z +
          hi_of(b.y) * o.w;
  }
  stats[r] = make_float4(row_off[r], row_inv[r], dl * delta_mul, 0.0f);
}

// --------------------------------------------------------- backward, main
template <int D>
constexpr int bwd_smem_bytes() {
  return bwd_keys(D) * (D + kPad) * 2 +                   // K
         kStages * (2 * kBwdQueries * (D + kPad) * 2 +    // Q, dO
                    kBwdQueries * 16) +                   // row statistics
         kBwdQueries * (bwd_keys(D) + kPad) * 2;          // bf16(dS)
}

template <int D, bool kPow2>
__global__ void __launch_bounds__(kThreads, D == 16 ? 2 : 1)
mha_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dob,
               const float4* __restrict__ stats, int N, int kblocks, float c,
               float inv_scale, float scale, int out_bf16,
               void* __restrict__ dk, void* __restrict__ dv,
               float* __restrict__ ws) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kMi = bwd_mtiles(D);
  constexpr int kKeys = bwd_keys(D);
  constexpr int kRow = D + kPad;
  constexpr int kTile = kBwdQueries * kRow;
  constexpr int kDsRow = kKeys + kPad;
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* ring = Ks + kKeys * kRow;  // stages x {Q, dO}
  float4* sstat = reinterpret_cast<float4*>(ring + kStages * 2 * kTile);
  bf16* dS = reinterpret_cast<bf16*>(sstat + kStages * kBwdQueries);
  const int bh = blockIdx.x / kblocks;
  const int kb = blockIdx.x % kblocks;
  const int key0 = kb * kKeys;
  const size_t base = (size_t)bh * N * D;
  const bf16* Q = q + base;
  const bf16* DO = dob + base;
  const float4* ST = stats + (size_t)bh * N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wkey = warp * 16 * kMi;  // the warp's first key in the block
  const int T = (N + kBwdQueries - 1) / kBwdQueries;

  stage_rows<D, kKeys>(Ks, k + base, key0, N);  // joins group 0
  auto stage = [&](int j) {
    if (j < T) {
      const int slot = j % kStages;
      const int qrow0 = j * kBwdQueries;
      bf16* dst = ring + slot * 2 * kTile;
      stage_rows<D, kBwdQueries>(dst, Q, qrow0, N);
      stage_rows<D, kBwdQueries>(dst + kTile, DO, qrow0, N);
      if (threadIdx.x < kBwdQueries) {
        const bool in = qrow0 + (int)threadIdx.x < N;
        cp_async16(sstat + slot * kBwdQueries + threadIdx.x,
                   ST + (in ? qrow0 + threadIdx.x : 0), in);
      }
    }
    cp_commit();
  };
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) stage(j);

  // V's A fragments (the warp's keys, kMi 16-row tiles), / scale when that
  // is exact
  uint32_t ka[kMi][D / 16][4], va[kMi][D / 16][4];
#pragma unroll
  for (int mi = 0; mi < kMi; ++mi) {
    load_a<D>(v + base, key0 + wkey + 16 * mi, N, va[mi]);
    if (kPow2) {
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          va[mi][ks][r] = pack2(lo_of(va[mi][ks][r]) * inv_scale,
                                hi_of(va[mi][ks][r]) * inv_scale);
    }
  }
  float dk_acc[kMi][D / 8][4], dv_acc[kMi][D / 8][4];
#pragma unroll
  for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk_acc[mi][nd][e] = dv_acc[mi][nd][e] = 0.0f;

  // the dq tile a warp computes: query rows 16 mt .. + 15, columns
  // 8 n0 .. 8 (n0 + D / 16) - 1
  const int mt = warp & 3;
  const int n0 = (warp >> 2) * (D / 16);
  float* wsb = ws + ((size_t)bh * kblocks + kb) * N * D;

  for (int j = 0; j < T; ++j) {
    cp_wait<kStages - 2>();
    __syncthreads();
    if (j == 0) {  // K's A fragments, once the tile has landed
#pragma unroll
      for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks)
          ldm_x4(ka[mi][ks],
                 Ks + (wkey + 16 * mi + (lane & 15)) * kRow + 16 * ks +
                     (lane >> 4) * 8);
    }
    stage(j + kStages - 1);
    const bf16* Qs = ring + (j % kStages) * 2 * kTile;
    const bf16* Ds = Qs + kTile;
    const float4* st = sstat + (j % kStages) * kBwdQueries;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t bq[D / 16][4], bd[D / 16][4], tq[D / 16][4], td[D / 16][4];
      ldm_rows<D>(bq, Qs, kk);
      ldm_rows<D>(bd, Ds, kk);
      ldm_cols<D>(tq, Qs, kk);
      ldm_cols<D>(td, Ds, kk);
      float4 cs[2][2];  // this thread's 4 query columns
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) cs[h][e] = st[16 * kk + 8 * h + 2 * t + e];
#pragma unroll
      for (int mi = 0; mi < kMi; ++mi) {
        float s[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
        float dp[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          mma16816(s[0], ka[mi][ks], bq[ks][0], bq[ks][1]);
          mma16816(s[1], ka[mi][ks], bq[ks][2], bq[ks][3]);
          mma16816(dp[0], va[mi][ks], bd[ks][0], bd[ks][1]);
          mma16816(dp[1], va[mi][ks], bd[ks][2], bd[ks][3]);
        }
        float p[2][4], ds[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float4 r = cs[h][e & 1];
            p[h][e] = __fmul_rn(ex2(__fmaf_rn(s[h][e], c, r.x)), r.y);
            const float x = __fmul_rn(p[h][e], dp[h][e] - r.z);
            ds[h][e] = kPow2 ? x : __fdiv_rn(x, scale);
          }
        const uint32_t pa[4] = {pack2(p[0][0], p[0][1]),
                                pack2(p[0][2], p[0][3]),
                                pack2(p[1][0], p[1][1]),
                                pack2(p[1][2], p[1][3])};
        const uint32_t da[4] = {pack2(ds[0][0], ds[0][1]),
                                pack2(ds[0][2], ds[0][3]),
                                pack2(ds[1][0], ds[1][1]),
                                pack2(ds[1][2], ds[1][3])};
        mul_cols_acc(dv_acc[mi], pa, td, D / 16);
        mul_cols_acc(dk_acc[mi], da, tq, D / 16);
        // bf16(dS) query-major: row = query, column = key in the block
        stm_x4_t(dS + (16 * kk + (lane & 7) + ((lane >> 4) << 3)) * kDsRow +
                     wkey + 16 * mi + ((lane >> 3) & 1) * 8,
                 da);
      }
    }
    __syncthreads();
    // dq's partial over the block's keys: bf16(dS) (64 x kKeys) times K
    // independent sums over alternate key steps, added at the end in a fixed
    // order: short dependency chains
    float acc[4][D / 16][4];
#pragma unroll
    for (int h = 0; h < 4; ++h)
#pragma unroll
      for (int nn = 0; nn < D / 16; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[h][nn][e] = 0.0f;
    const bf16* arow = dS + (16 * mt + (lane & 15)) * kDsRow + (lane >> 4) * 8;
    if constexpr (D == 16) {
      // one column tile: B of two key steps from one ldmatrix
#pragma unroll
      for (int ks = 0; ks < kKeys / 16; ks += 2) {
        uint32_t a0[4], a1[4], b[4];
        ldm_x4(a0, arow + 16 * ks);
        ldm_x4(a1, arow + 16 * ks + 16);
        ldm_x4_t(b, Ks + (16 * ks + (lane & 7) + 8 * (lane >> 3)) * kRow +
                        8 * n0);
        mma16816(acc[ks & 2][0], a0, b[0], b[1]);
        mma16816(acc[(ks & 2) + 1][0], a1, b[2], b[3]);
      }
    } else {
#pragma unroll 4
      for (int ks = 0; ks < kKeys / 16; ++ks) {
        uint32_t a[4];
        ldm_x4(a, arow + 16 * ks);
#pragma unroll
        for (int np = 0; np < D / 32; ++np) {
          uint32_t b[4];
          ldm_x4_t(b, Ks + (16 * ks + (lane & 7) + ((lane >> 3) & 1) * 8) *
                               kRow + 8 * (n0 + 2 * np) + (lane >> 4) * 8);
          mma16816(acc[ks & 3][2 * np], a, b[0], b[1]);
          mma16816(acc[ks & 3][2 * np + 1], a, b[2], b[3]);
        }
      }
    }
#pragma unroll
    for (int nn = 0; nn < D / 16; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[0][nn][e] = (acc[0][nn][e] + acc[1][nn][e]) +
                        (acc[2][nn][e] + acc[3][nn][e]);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = j * kBwdQueries + 16 * mt + g + 8 * rr;
      if (row >= N) continue;
#pragma unroll
      for (int nn = 0; nn < D / 16; ++nn)
        *reinterpret_cast<float2*>(wsb + (size_t)row * D + 8 * (n0 + nn) +
                                   2 * t) =
            make_float2(acc[0][nn][2 * rr], acc[0][nn][2 * rr + 1]);
    }
  }
#pragma unroll
  for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int key = key0 + wkey + 16 * mi + g + 8 * rr;
      if (key >= N) continue;
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        const size_t at = base + (size_t)key * D + 8 * nd + 2 * t;
        store2(dk, out_bf16, at, dk_acc[mi][nd][2 * rr],
               dk_acc[mi][nd][2 * rr + 1]);
        store2(dv, out_bf16, at, dv_acc[mi][nd][2 * rr],
               dv_acc[mi][nd][2 * rr + 1]);
      }
    }
}

// dq = the workspace's slices summed in key-block order, 4 values a thread
__global__ void mha_dq_reduce_kernel(const float* __restrict__ ws,
                                     int kblocks, size_t slice, size_t n4,
                                     int out_bf16, void* __restrict__ dq) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const size_t bh = 4 * i / slice, at = 4 * i % slice;
  const float* src = ws + bh * kblocks * slice + at;
  float4 acc = *reinterpret_cast<const float4*>(src);
  for (int kb = 1; kb < kblocks; ++kb) {
    const float4 x = *reinterpret_cast<const float4*>(src + kb * slice);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  store2(dq, out_bf16, 4 * i, acc.x, acc.y);
  store2(dq, out_bf16, 4 * i + 2, acc.z, acc.w);
}

bool pow2(float scale) {
  int e;
  return fabsf(frexpf(scale, &e)) == 0.5f;
}

constexpr float kLog2e = 1.4426950408889634f;

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  // set at each launch: a smaller shape must not lower another's need
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// The bf16 q, k, v the kernels read: the inputs themselves, or for f32
// inputs their copies in qkv16 after one cast kernel.
cudaError_t bf16_inputs(const void* q, const void* k, const void* v,
                        int in_bf16, void* qkv16, size_t elems,
                        const bf16* (&in)[3], cudaStream_t stream) {
  if (in_bf16) {
    in[0] = static_cast<const bf16*>(q);
    in[1] = static_cast<const bf16*>(k);
    in[2] = static_cast<const bf16*>(v);
    return cudaSuccess;
  }
  bf16* dst = static_cast<bf16*>(qkv16);
  const size_t n4 = elems / 4;
  dim3 grid((unsigned)((n4 + 255) / 256), 3);
  mha_cast_bf16_kernel<<<grid, 256, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), dst, n4);
  for (int i = 0; i < 3; ++i) in[i] = dst + i * elems;
  return cudaGetLastError();
}

template <int D, bool kO32>
cudaError_t fwd_kernel(const bf16* q, const bf16* k, const bf16* v, int BH,
                       int N, float scale, float* out, float* o32,
                       float* row_off, float* row_inv, cudaStream_t stream) {
  const int qblocks = (N + kFwdRows - 1) / kFwdRows;
  auto kernel = mha_fwd_kernel<D, kO32>;
  cudaError_t e = allow_smem(kernel, fwd_smem_bytes<D>());
  if (e != cudaSuccess) return e;
  const float c = kLog2e / scale;
  kernel<<<(unsigned)((long long)BH * qblocks), kThreads, fwd_smem_bytes<D>(),
           stream>>>(q, k, v, N, qblocks, c, kRefStep / c, out, o32, row_off,
                     row_inv);
  return cudaGetLastError();
}

template <int D>
cudaError_t fwd(const bf16* q, const bf16* k, const bf16* v, int BH, int N,
                float scale, float* out, float* o32, float* row_off,
                float* row_inv, cudaStream_t stream) {
  if (o32)
    return fwd_kernel<D, true>(q, k, v, BH, N, scale, out, o32, row_off,
                               row_inv, stream);
  return fwd_kernel<D, false>(q, k, v, BH, N, scale, out, o32, row_off,
                              row_inv, stream);
}

template <int D>
cudaError_t bwd(const bf16* q, const bf16* k, const bf16* v, int out_bf16,
                const float* dout, const float* o32, const float* row_off,
                const float* row_inv, int BH, int N, float scale, void* dq,
                void* dk, void* dv, bf16* dob, float4* stats, float* ws,
                cudaStream_t stream) {
  const bool exact = pow2(scale);
  const size_t rows = (size_t)BH * N;
  mha_bwd_prep_kernel<D><<<(unsigned)((rows + 255) / 256), 256, 0, stream>>>(
      dout, o32, row_off, row_inv, rows, exact ? 1.0f / scale : 1.0f, dob,
      stats);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int kblocks = (N + bwd_keys(D) - 1) / bwd_keys(D);
  auto kernel = exact ? &mha_bwd_kernel<D, true> : &mha_bwd_kernel<D, false>;
  e = allow_smem(kernel, bwd_smem_bytes<D>());
  if (e != cudaSuccess) return e;
  kernel<<<(unsigned)((long long)BH * kblocks), kThreads, bwd_smem_bytes<D>(),
           stream>>>(q, k, v, dob, stats, N, kblocks, kLog2e / scale,
                     1.0f / scale, scale, out_bf16, dk, dv, ws);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t n4 = rows * D / 4;
  mha_dq_reduce_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, stream>>>(
      ws, kblocks, (size_t)N * D, n4, out_bf16, dq);
  return cudaGetLastError();
}

bool bad_shape(int BH, int N, int D, float scale) {
  return BH <= 0 || N <= 0 || (D != 16 && D != 32 && D != 64) ||
         !(scale > 0.0f) ||
         (long long)BH * ((N + kFwdRows - 1) / kFwdRows) > 2147483647LL;
}

}  // namespace

extern "C" {

// Key blocks of the backward: the dq workspace is (BH, blocks, N, D) f32.
int mha_bwd_key_blocks(int N, int D) {
  return (N + bwd_keys(D) - 1) / bwd_keys(D);
}

// q, k, v (BH, N, D) contiguous, 16-byte aligned, f32 or bf16 (in_bf16);
// qkv16 (3, BH, N, D) bf16 scratch for f32 inputs (null for bf16) -> out
// (BH, N, D) f32, row_off, row_inv (BH, N) f32 and, when o32 is not null,
// o32 (BH, N, D) f32 for the backward. Returns cudaError_t.
int mha_fwd_launch(const void* q, const void* k, const void* v, int in_bf16,
                   void* qkv16, int BH, int N, int D, float scale,
                   float* out, float* o32, float* row_off, float* row_inv,
                   cudaStream_t stream) {
  if (bad_shape(BH, N, D, scale)) return cudaErrorInvalidValue;
  const bf16* in[3];
  cudaError_t e = bf16_inputs(q, k, v, in_bf16, qkv16, (size_t)BH * N * D,
                              in, stream);
  if (e != cudaSuccess) return e;
  if (D == 16)
    return fwd<16>(in[0], in[1], in[2], BH, N, scale, out, o32,
                   row_off, row_inv, stream);
  if (D == 32)
    return fwd<32>(in[0], in[1], in[2], BH, N, scale, out, o32,
                   row_off, row_inv, stream);
  return fwd<64>(in[0], in[1], in[2], BH, N, scale, out, o32,
                 row_off, row_inv, stream);
}

// dout (BH, N, D) f32 and the forward's o32, row_off, row_inv -> dq, dk, dv
// (BH, N, D) in the inputs' type. Scratch: qkv16 as for the forward, dob
// (BH, N, D) bf16, stats (BH, N, 4) f32, ws (BH, mha_bwd_key_blocks(N, D),
// N, D) f32.
int mha_bwd_launch(const void* q, const void* k, const void* v, int in_bf16,
                   void* qkv16, const float* dout, const float* o32,
                   const float* row_off, const float* row_inv, int BH, int N,
                   int D, float scale, void* dq, void* dk, void* dv,
                   void* dob, void* stats, float* ws, cudaStream_t stream) {
  if (bad_shape(BH, N, D, scale)) return cudaErrorInvalidValue;
  const bf16* in[3];
  cudaError_t e = bf16_inputs(q, k, v, in_bf16, qkv16, (size_t)BH * N * D,
                              in, stream);
  if (e != cudaSuccess) return e;
  bf16* d16 = static_cast<bf16*>(dob);
  float4* st = static_cast<float4*>(stats);
  if (D == 16)
    return bwd<16>(in[0], in[1], in[2], in_bf16, dout, o32, row_off, row_inv,
                   BH, N, scale, dq, dk, dv, d16, st, ws, stream);
  if (D == 32)
    return bwd<32>(in[0], in[1], in[2], in_bf16, dout, o32, row_off, row_inv,
                   BH, N, scale, dq, dk, dv, d16, st, ws, stream);
  return bwd<64>(in[0], in[1], in[2], in_bf16, dout, o32, row_off, row_inv, BH,
                 N, scale, dq, dk, dv, d16, st, ws, stream);
}

const char* apt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
