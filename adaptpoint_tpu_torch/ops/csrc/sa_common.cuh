// Pieces shared by the fused SetAbstraction kernels (saeval.cu, the forward,
// and sa_train_bwd.cu, its recompute backward) for Hopper (sm_90a): the
// tile sizes, the wmma fragment types, the tensor-core tile product and the
// staging of the gathered [dp || fj] rows as bf16.
//
// A block owns a tile of TM query centers of one cloud; each center owns
// Kp = round16(K) rows, so every 16-row tile belongs to one center. Row r is
// slot r % Kp of center r / Kp; slots past K and columns past 3 + C are zero.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

namespace apt_sa {

using namespace nvcuda;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr size_t kSmemLimit = 232448;  // bytes a block may use on sm_90

typedef __nv_bfloat16 bf16;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
    FragA;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>
    FragAt;  // a transposed operand read from a row-major matrix
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
    FragB;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
    FragBt;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

__host__ __device__ inline int round16(int x) { return (x + 15) / 16 * 16; }
__host__ __device__ inline size_t align128(size_t x) {
  return (x + 127) / 128 * 128;
}

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// acc[t] = sum_kt A(rt0 + t, kt) . B(kt), t < NT, KT steps of 16: the A tile
// (rt, kt) starts at A + rt * a_rt + kt * a_kt, the B tile kt at
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

// The R x Wp gathered rows as bf16: slot k of center c is neighbour
// j = nbr[c * K + k]; columns 0..2 the two-split coordinates
// bf16(x) + bf16(x - bf16(x)), minus the center's (qs[c * 4 + col]) and
// times dp_scale when relative; columns 3.. the features. Every thread of
// the block takes part.
__device__ inline void stage_rows(bf16* A, const int* nbr, const float* qs,
                                  const float* X, const float* F, int R,
                                  int Wp, int K, int C, int relative,
                                  float dp_scale) {
  const int Kp = round16(K);
  const int W = C + 3;
  for (int e = threadIdx.x; e < R * Wp; e += blockDim.x) {
    const int r = e / Wp;
    const int col = e - r * Wp;
    const int c = r / Kp;
    const int k = r - c * Kp;
    float v = 0.0f;
    if (k < K && col < W) {
      const int j = nbr[c * K + k];
      if (col < 3) {
        const float x = X[3 * j + col];
        const float hf = bf16r(x);
        v = __fadd_rn(hf, bf16r(__fsub_rn(x, hf)));
        if (relative) v = __fmul_rn(__fsub_rn(v, qs[c * 4 + col]), dp_scale);
      } else {
        v = F[(size_t)j * C + (col - 3)];
      }
    }
    A[e] = __float2bfloat16_rn(v);
  }
}

// The first conv for NT row tiles of one 16-column tile ct:
// H = bf16(relu(A . w1 + b1)), through the warp's 16 x 16 f32 scratch sc.
template <int NT>
__device__ void conv1_tiles(const bf16* A, int Wp, const bf16* w1,
                            const float* b1, bf16* H, int midp, float* sc,
                            int rt0, int ct, int lane) {
  FragC acc[NT];
  mma_tiles<NT, FragA, FragB>(acc, A, Wp, (size_t)16 * Wp, 16, rt0,
                              w1 + ct * 16, midp, (size_t)16 * midp, Wp / 16);
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    wmma::store_matrix_sync(sc, acc[t], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int rr = e >> 4;
      const int cc = e & 15;
      const float v = fmaxf(__fadd_rn(sc[e], b1[ct * 16 + cc]), 0.0f);
      H[(size_t)((rt0 + t) * 16 + rr) * midp + ct * 16 + cc] =
          __float2bfloat16_rn(v);
    }
    __syncwarp();
  }
}

// conv1_tiles with NT a run-time value of 1..8.
__device__ inline void conv1_unit(int nt, const bf16* A, int Wp,
                                  const bf16* w1, const float* b1, bf16* H,
                                  int midp, float* sc, int rt0, int ct,
                                  int lane) {
  switch (nt) {
    case 1: conv1_tiles<1>(A, Wp, w1, b1, H, midp, sc, rt0, ct, lane); break;
    case 2: conv1_tiles<2>(A, Wp, w1, b1, H, midp, sc, rt0, ct, lane); break;
    case 3: conv1_tiles<3>(A, Wp, w1, b1, H, midp, sc, rt0, ct, lane); break;
    case 4: conv1_tiles<4>(A, Wp, w1, b1, H, midp, sc, rt0, ct, lane); break;
    case 5: conv1_tiles<5>(A, Wp, w1, b1, H, midp, sc, rt0, ct, lane); break;
    case 6: conv1_tiles<6>(A, Wp, w1, b1, H, midp, sc, rt0, ct, lane); break;
    case 7: conv1_tiles<7>(A, Wp, w1, b1, H, midp, sc, rt0, ct, lane); break;
    default: conv1_tiles<8>(A, Wp, w1, b1, H, midp, sc, rt0, ct, lane); break;
  }
}

// Largest number of whole centers per unit of work that still gives every
// warp a unit: units = col_tiles * (TM / group).
__device__ inline int center_group(int TM, int col_tiles) {
  for (int g = TM; g > 1; --g)
    if (TM % g == 0 && col_tiles * (TM / g) >= kWarps) return g;
  return 1;
}

}  // namespace apt_sa
