// Pieces shared by the fused SetAbstraction kernels (saeval.cu, the forward,
// and sa_train_bwd.cu, its recompute backward) for Hopper (sm_90a): the
// block size, cp.async, ldmatrix and the mma.sync m16n8k16 product over warp
// tiles of 32 x 32, the wmma fragment types of the backward's weight-gradient
// path, and the weight ring's sizes.
//
// A block owns a tile of TM query centers of one cloud; each center owns
// Kp = round16(K) rows, so every 16-row tile belongs to one center. Row r is
// slot r % Kp of center r / Kp; slots past K and columns past 3 + C are zero.
//
// Both kernels run conv1 (the gathered rows times w1) with tiles_mma over
// the k16 steps of Wp in ascending order from a zero accumulator and add b1
// with one f32 add afterwards: the backward's mask h_pre > 0 is then the
// forward's ReLU bit for bit.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

namespace apt_sa {

using namespace nvcuda;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr size_t kSmemLimit = 232448;  // bytes a block may use on sm_90

constexpr int kKc = 64;        // k rows a weight ring stage holds
constexpr int kStages = 2;     // ring depth: a double buffer (3 stages
                               // measured no faster on the H100)
constexpr int kPad = 8;        // bf16 of padding per staged row
constexpr int kPassTiles = 2 * kWarps;  // 32 x 32 tiles a pass: 2 a warp

typedef __nv_bfloat16 bf16;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
    FragA;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>
    FragAt;  // a transposed operand read from a row-major matrix
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
    FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

__host__ __device__ inline int round16(int x) { return (x + 15) / 16 * 16; }
__host__ __device__ inline size_t align128(size_t x) {
  return (x + 127) / 128 * 128;
}
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

// Output columns one pass covers with R rows (a multiple of 32): 16 warp
// tiles, at most 256 columns (the ring's stages grow with them).
__host__ __device__ inline int pass_cols(int R) {
  const int n = (kPassTiles / (R / 32)) * 32;
  return n < 256 ? n : 256;
}

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// acc[t] = sum_kt A(rt0 + t, kt) . B(kt), t < NT, KT steps of 16 (wmma): the
// A tile (rt, kt) starts at A + rt * a_rt + kt * a_kt, the B tile kt at
// B + kt * b_kt (B already offset to its column tile). Each B fragment is
// loaded once and used for all NT row tiles.
template <int NT, typename FA, typename FB>
__device__ inline void mma_tiles(FragC (&acc)[NT], const bf16* A, int lda,
                                 size_t a_rt, size_t a_kt, int rt0,
                                 const bf16* B, int ldb, size_t b_kt, int KT) {
#pragma unroll
  for (int t = 0; t < NT; ++t) wmma::fill_fragment(acc[t], 0.0f);
  for (int kt = 0; kt < KT; ++kt) {
    FB fb;
    wmma::load_matrix_sync(fb, B + kt * b_kt, ldb);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      FA fa;
      wmma::load_matrix_sync(fa, A + (rt0 + t) * a_rt + kt * a_kt, lda);
      wmma::mma_sync(acc[t], fa, fb, acc[t]);
    }
  }
}

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

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The accumulators of one warp: up to two 32 x 32 tiles, each 2 row tiles
// of 16 by 4 column tiles of 8 in the m16n8 fragment layout (c[0], c[1] at
// row g = lane / 4, columns 2q, 2q + 1, q = lane % 4; c[2], c[3] at row
// g + 8).
typedef float Acc[2][2][4][4];

// The tiles of a pass: rows R, columns nw; tile t of the warp's two is
// number warp + 8 t, at row group t % (R / 32) and column group t / (R / 32).
struct Tiles {
  int rg[2], cg[2], pairs[2];  // pairs: valid 16-column halves (0, 1, 2)
};

__device__ __forceinline__ Tiles tiles_of(int warp, int R, int nw) {
  const int tr = R / 32;
  const int total = tr * ((nw + 31) / 32);
  Tiles t;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int id = warp + kWarps * u;
    t.rg[u] = id % tr;
    t.cg[u] = id / tr;
    t.pairs[u] = id < total ? imin(2, (nw - t.cg[u] * 32) / 16) : 0;
  }
  return t;
}

// The backward's g_h A operand without a dense GO: the compact bf16(g_out)
// (gc) and winning slots (ac) of the block's centers, coutp a center
struct GoSrc {
  const bf16* gc;
  const unsigned char* ac;
  int coutp, Kp, Rv;
};

// The m16n8k16 A fragment of GO for rows slot .. slot + 8 (this lane's row
// g and g + 8) of center c, columns k, k + 1, k + 8, k + 9 (k = k0 + 2q):
// bf16(g_out) where the column's winning slot is the row's, else 0.
__device__ __forceinline__ void go_frag(uint32_t (&a)[4], const GoSrc& go,
                                        int c, int slot, int k) {
  const bf16* g = go.gc + (size_t)c * go.coutp + k;
  const unsigned char* w = go.ac + (size_t)c * go.coutp + k;
  const uint32_t gA = *reinterpret_cast<const uint32_t*>(g);
  const uint32_t gB = *reinterpret_cast<const uint32_t*>(g + 8);
  const uint32_t slots =
      (uint32_t)*reinterpret_cast<const unsigned short*>(w) |
      ((uint32_t)*reinterpret_cast<const unsigned short*>(w + 8) << 16);
  const uint32_t lo = __vcmpeq4(slots, (uint32_t)slot * 0x01010101u);
  const uint32_t hi = __vcmpeq4(slots, (uint32_t)(slot + 8) * 0x01010101u);
  a[0] = gA & __byte_perm(lo, 0, 0x1100);
  a[1] = gA & __byte_perm(hi, 0, 0x1100);
  a[2] = gB & __byte_perm(lo, 0, 0x3322);
  a[3] = gB & __byte_perm(hi, 0, 0x3322);
}

// acc[u] += A(rows of tile u, k0 .. k0 + 16 ksteps) . B for the warp's
// tiles. A is row-major in shared memory (lda), its k0-th column at A + k0;
// with kClamp its rows past last_row read row last_row (rows the block holds
// no slot in, whose results are dropped). B is the ring stage: trans, [k][n]
// with n contiguous (ldb), else [n][k] with k contiguous (ldb); its k origin
// is the stage's row or column 0 and its n origin the pass's first column.
// With kBuiltA, A is GO built from go.
template <bool kTrans, bool kBuiltA, bool kClamp = false>
__device__ __forceinline__ void tiles_mma(Acc& acc, const Tiles& t,
                                          const bf16* A, int lda, int k0,
                                          const bf16* Bs, int ldb, int ksteps,
                                          int lane, GoSrc go = {},
                                          int last_row = 0) {
  const bool shared_rows = t.rg[1] == t.rg[0];
  // with kBuiltA: each 16-row tile's center and its row g's slot (0xf0 for
  // padding rows: no slot matches)
  int gcen[2][2], gslot[2][2];
  if (kBuiltA) {
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int row0 = t.rg[u] * 32 + mi * 16;
        const int c = row0 / go.Kp;
        gcen[u][mi] = row0 < go.Rv ? c : 0;
        gslot[u][mi] = row0 < go.Rv ? row0 - c * go.Kp + (lane >> 2) : 0xf0;
      }
  }
  for (int s = 0; s < ksteps; ++s) {
    uint32_t a[2][4];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (t.pairs[u] == 0) continue;
      if (u == 0 || !shared_rows) {
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          if (kBuiltA) {
            go_frag(a[mi], go, gcen[u][mi], gslot[u][mi],
                    k0 + s * 16 + 2 * (lane & 3));
          } else {
            int row = t.rg[u] * 32 + mi * 16 + (lane & 15);
            if (kClamp) row = imin(row, last_row);
            ldm_x4(a[mi], A + (size_t)row * lda + k0 + s * 16 +
                              (lane >> 4) * 8);
          }
        }
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        if (np >= t.pairs[u]) continue;
        const int n0 = t.cg[u] * 32 + np * 16;
        uint32_t b[4];
        if (kTrans)
          ldm_x4_t(b, Bs + (size_t)(s * 16 + (lane & 7) +
                                    ((lane >> 3) & 1) * 8) * ldb +
                          n0 + (lane >> 4) * 8);
        else
          ldm_x4(b, Bs + (size_t)(n0 + (lane & 7) + (lane >> 4) * 8) * ldb +
                        s * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma16816(acc[u][mi][np * 2], a[mi], b[0], b[1]);
          mma16816(acc[u][mi][np * 2 + 1], a[mi], b[2], b[3]);
        }
      }
    }
  }
}

__device__ __forceinline__ void zero_acc(Acc& acc) {
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[u][mi][ni][e] = 0.0f;
}

}  // namespace apt_sa
