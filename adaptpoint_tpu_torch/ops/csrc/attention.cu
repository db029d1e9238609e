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
// Which softmax form: the plain version normalises P and THEN rounds it to
// bf16. The forward therefore makes two passes over the key tiles: the first
// finds each row's max and sum with the usual online rescaling, the second
// recomputes S, forms P = exp(S - max) * (1 / sum), rounds that, and
// multiplies by v. A one-pass online softmax would round unnormalised exp values and
// divide at the end, which differs from the plain version by a bf16 rounding
// (2^-9 relative) of every element of P; the two-pass form differs only by
// the order of f32 sums, the last bits of exp (__expf here) and the
// reciprocal in place of a division, which flip the bf16 rounding of an
// occasional element: one flip moves an output by
// 2^-8 * p * |v|, which for the largest p of a row is a few 1e-4. The stated
// tolerance is 2e-3 * (1 + |plain|), the bf16 bound that two correct
// implementations of this function can be held to.
//
// The backward needs what the TPU kernel gets from holding a whole (TM, N)
// tile: each row's max and sum (saved by the forward) and
// delta = rowsum(dP * P) = bf16(do) . (P bf16(v)) with P unrounded. The
// forward gives the last factor as o32 = (P_hi + P_lo) bf16(v), P_hi =
// bf16(P), P_lo = bf16(P - P_hi): one more product on the tensor cores, and
// P_hi + P_lo carries 16 bits of P. Two backward kernels, no atomics, so the
// result is bit-reproducible: dq per tile of 64 queries walking the key
// tiles, and dk, dv per tile of 64 keys walking the query tiles with the
// transposed products (S^T = k q^T). The TPU kernel's accumulation of dk, dv
// over revisited output blocks is a Pallas idiom and is not carried over.
//
// Design: a block of 4 warps owns 64 rows, 16 a warp, whose operand
// fragments stay in registers; the other side streams through shared memory
// in tiles of 64 rows, stored as bf16 row-major (padded by 8, conflict-free
// for the B fragments of S) and, where it is the second factor of a product
// over rows, also transposed. The accumulator layout of S is the A-fragment
// layout of the next product, so P and dS never leave registers.
//
// What bounds it at (128, 2048, 16): the special-function unit and the f32
// pipe, not bytes (25 MB) and not the tensor cores (4 BH N^2 d = 34 GFLOP
// forward): 2 * BH * N^2 = 1.07e9 exp forward, as many again backward, each
// with some ten f32 operations of softmax bookkeeping around it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 64;  // rows a block owns, and rows of a streamed tile
constexpr int kPad = 8;    // bf16 elements of padding per shared-memory row

struct Scale {
  float scale, inv;
  int use_div;  // 0 when scale is a power of two: x * inv is then exact
};

__device__ __forceinline__ float scaled(float x, const Scale& sc) {
  return sc.use_div ? x / sc.scale : x * sc.inv;
}

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// exp as one multiply and the special-function unit's ex2: about 2 ulp, and
// 0 for -inf. The forward and both backward kernels use the same one, so the
// P they form is the same P.
__device__ __forceinline__ float fast_exp(float x) { return __expf(x); }

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Elements off, off + 1 (off even) of a matrix of f32 or bf16 values.
__device__ __forceinline__ float2 load2(const void* base, int bf16,
                                        size_t off) {
  if (bf16) {
    const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(
        static_cast<const __nv_bfloat16*>(base) + off);
    return __bfloat1622float2(v);
  }
  return *reinterpret_cast<const float2*>(static_cast<const float*>(base) +
                                          off);
}

__device__ __forceinline__ void store2(void* base, int bf16, size_t off,
                                       float a, float b) {
  if (bf16) {
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(base) +
                                       off) = __floats2bfloat162_rn(a, b);
  } else {
    *reinterpret_cast<float2*>(static_cast<float*>(base) + off) =
        make_float2(a, b);
  }
}

// Rows row0 .. row0+63 of an (N, D) matrix `src` (rows >= N as zeros) into
// shared memory as bf16: row-major rm[64][D + kPad] and/or transposed
// tr[D][64 + kPad]. Either destination may be null.
template <int D>
__device__ __forceinline__ void stage_tile(const void* src, int bf16,
                                           int row0, int N,
                                           __nv_bfloat16* rm,
                                           __nv_bfloat16* tr) {
  constexpr int kHalf = D / 2;
  for (int e = threadIdx.x; e < kTile * kHalf; e += kThreads) {
    const int r = e / kHalf;
    const int c = (e % kHalf) * 2;
    float2 v = make_float2(0.0f, 0.0f);
    if (row0 + r < N) v = load2(src, bf16, (size_t)(row0 + r) * D + c);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v.x, v.y);
    if (rm) *reinterpret_cast<__nv_bfloat162*>(rm + r * (D + kPad) + c) = b;
    if (tr) {
      tr[c * (kTile + kPad) + r] = b.x;
      tr[(c + 1) * (kTile + kPad) + r] = b.y;
    }
  }
}

// A fragments of rows row0 .. row0+15 of an (N, D) matrix, rounded to bf16.
template <int D>
__device__ __forceinline__ void load_a(const void* src, int bf16, int row0,
                                       int N, uint32_t (&a)[D / 16][4]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = row0 + g + 8 * rr;
        const int col = 16 * ks + 8 * h + 2 * t;
        float2 v = make_float2(0.0f, 0.0f);
        if (row < N) v = load2(src, bf16, (size_t)row * D + col);
        a[ks][2 * h + rr] = pack2(v.x, v.y);
      }
    }
  }
}

// acc[nt] (16 x 8, nt = 0..7) = A (16 x D) times rm^T: rm is a staged
// row-major tile, its rows 8 nt .. 8 nt + 7 are the columns of acc[nt].
template <int D>
__device__ __forceinline__ void mul_rows(const uint32_t (&a)[D / 16][4],
                                         const __nv_bfloat16* rm,
                                         float (&acc)[8][4]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t* p = reinterpret_cast<const uint32_t*>(
          rm + (8 * nt + g) * (D + kPad) + 16 * ks + 2 * t);
      mma16816(acc[nt], a[ks], p[0], p[4]);
    }
  }
}

// acc[nd] (16 x 8, nd = 0..D/8-1) += A (16 x 64, four k-steps of fragments)
// times the tile whose transpose tr[D][64 + kPad] is staged.
template <int D>
__device__ __forceinline__ void mul_cols(const uint32_t (&a)[4][4],
                                         const __nv_bfloat16* tr,
                                         float (&acc)[D / 8][4]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t* p = reinterpret_cast<const uint32_t*>(
          tr + (8 * nd + g) * (kTile + kPad) + 16 * kk + 2 * t);
      mma16816(acc[nd], a[kk], p[0], p[4]);
    }
  }
}

// The (16 x 64) accumulator tiles as A fragments of a product over the 64.
__device__ __forceinline__ void as_a(const float (&s)[8][4],
                                     uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack2(s[2 * kk][0], s[2 * kk][1]);
    a[kk][1] = pack2(s[2 * kk][2], s[2 * kk][3]);
    a[kk][2] = pack2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    a[kk][3] = pack2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ const void* matrix(const void* p, int bf16,
                                              size_t elems) {
  return bf16 ? static_cast<const void*>(
                    static_cast<const __nv_bfloat16*>(p) + elems)
              : static_cast<const void*>(static_cast<const float*>(p) + elems);
}

// Rows of an accumulator [D/8][4] to an (N, D) matrix of f32 or bf16.
template <int D>
__device__ __forceinline__ void store_rows(void* dst, int bf16, int row0,
                                           int N, const float (&acc)[D / 8][4]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = row0 + g + 8 * rr;
      if (row < N)
        store2(dst, bf16, (size_t)row * D + 8 * nd + 2 * t, acc[nd][2 * rr],
               acc[nd][2 * rr + 1]);
    }
  }
}

// ---------------------------------------------------------------- forward
template <int D>
__global__ void __launch_bounds__(kThreads)
mha_fwd_kernel(const void* __restrict__ q, const void* __restrict__ k,
               const void* __restrict__ v, int in_bf16, int N, int tiles,
               Scale sc, float* __restrict__ out, float* __restrict__ o32,
               float* __restrict__ row_max, float* __restrict__ row_sum) {
  __shared__ __align__(16) __nv_bfloat16 k_rm[kTile * (D + kPad)];
  __shared__ __align__(16) __nv_bfloat16 v_tr[D * (kTile + kPad)];
  const int bh = blockIdx.x / tiles;
  const int q0 = (blockIdx.x % tiles) * kTile;
  const size_t base = (size_t)bh * N * D;
  const void* Q = matrix(q, in_bf16, base);
  const void* Km = matrix(k, in_bf16, base);
  const void* Vm = matrix(v, in_bf16, base);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + warp * 16;

  uint32_t qa[D / 16][4];
  load_a<D>(Q, in_bf16, r0, N, qa);

  // pass 1: each row's max and sum, rescaled online. A thread holds rows
  // g and g + 8; the sums stay per-thread partials until the end.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float s[8][4];
  for (int k0 = 0; k0 < N; k0 += kTile) {
    __syncthreads();
    stage_tile<D>(Km, in_bf16, k0, N, k_rm, nullptr);
    __syncthreads();
    mul_rows<D>(qa, k_rm, s);
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * nt + 2 * t + (e & 1);
        const float val = key < N ? scaled(s[nt][e], sc) : -INFINITY;
        s[nt][e] = val;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], val);
      }
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      // every tile holds a real key, so the new max is finite
      const float m_new = fmaxf(m[rr], quad_max(tmax[rr]));
      float part = 0.0f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        part += fast_exp(s[nt][2 * rr] - m_new) +
                fast_exp(s[nt][2 * rr + 1] - m_new);
      l[rr] = l[rr] * fast_exp(m[rr] - m_new) + part;
      m[rr] = m_new;
    }
  }
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
  const float inv_l[2] = {1.0f / l[0], 1.0f / l[1]};

  // pass 2: P = exp(S - max) / sum, rounded to bf16, times v
  float o[D / 8][4], olo[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = olo[nd][e] = 0.0f;
  for (int k0 = 0; k0 < N; k0 += kTile) {
    __syncthreads();
    stage_tile<D>(Km, in_bf16, k0, N, k_rm, nullptr);
    stage_tile<D>(Vm, in_bf16, k0, N, nullptr, v_tr);
    __syncthreads();
    mul_rows<D>(qa, k_rm, s);
    float lo[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * nt + 2 * t + (e & 1);
        const float val = key < N ? scaled(s[nt][e], sc) : -INFINITY;
        const float p = fast_exp(val - m[e >> 1]) * inv_l[e >> 1];
        const float hi = round_bf16(p);
        s[nt][e] = hi;
        lo[nt][e] = p - hi;
      }
    }
    uint32_t pa[4][4];
    as_a(s, pa);
    mul_cols<D>(pa, v_tr, o);
    if (o32) {
      as_a(lo, pa);
      mul_cols<D>(pa, v_tr, olo);
    }
  }
  store_rows<D>(out + base, 0, r0, N, o);
  if (o32) {
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) olo[nd][e] += o[nd][e];
    store_rows<D>(o32 + base, 0, r0, N, olo);
  }
  if (t == 0) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = r0 + g + 8 * rr;
      if (row < N) {
        row_max[(size_t)bh * N + row] = m[rr];
        row_sum[(size_t)bh * N + row] = l[rr];
      }
    }
  }
}

// ------------------------------------------------------------ backward, dq
// Also writes delta = bf16(do) . o32 for the dk, dv kernel.
template <int D>
__global__ void __launch_bounds__(kThreads)
mha_bwd_dq_kernel(const void* __restrict__ q, const void* __restrict__ k,
                  const void* __restrict__ v, int in_bf16,
                  const float* __restrict__ dout, const float* __restrict__ o32,
                  const float* __restrict__ row_max,
                  const float* __restrict__ row_sum, int N, int tiles, Scale sc,
                  void* __restrict__ dq, float* __restrict__ delta) {
  __shared__ __align__(16) __nv_bfloat16 k_rm[kTile * (D + kPad)];
  __shared__ __align__(16) __nv_bfloat16 k_tr[D * (kTile + kPad)];
  __shared__ __align__(16) __nv_bfloat16 v_rm[kTile * (D + kPad)];
  const int bh = blockIdx.x / tiles;
  const int q0 = (blockIdx.x % tiles) * kTile;
  const size_t base = (size_t)bh * N * D;
  const void* Q = matrix(q, in_bf16, base);
  const void* Km = matrix(k, in_bf16, base);
  const void* Vm = matrix(v, in_bf16, base);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + warp * 16;

  uint32_t qa[D / 16][4], doa[D / 16][4];
  load_a<D>(Q, in_bf16, r0, N, qa);
  load_a<D>(dout + base, 0, r0, N, doa);

  float m[2], inv_l[2], dl[2] = {0.0f, 0.0f};
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = r0 + g + 8 * rr;
    m[rr] = row < N ? row_max[(size_t)bh * N + row] : 0.0f;
    inv_l[rr] = row < N ? 1.0f / row_sum[(size_t)bh * N + row] : 1.0f;
  }
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = r0 + g + 8 * rr;
        if (row < N) {
          const float2 o = load2(o32 + base, 0,
                                 (size_t)row * D + 16 * ks + 8 * h + 2 * t);
          const float2 d = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&doa[ks][2 * h + rr]));
          dl[rr] += d.x * o.x + d.y * o.y;
        }
      }
    }
  }
  dl[0] = quad_sum(dl[0]);
  dl[1] = quad_sum(dl[1]);
  if (t == 0) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = r0 + g + 8 * rr;
      if (row < N) delta[(size_t)bh * N + row] = dl[rr];
    }
  }

  float acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.0f;
  float s[8][4], dp[8][4];
  for (int k0 = 0; k0 < N; k0 += kTile) {
    __syncthreads();
    stage_tile<D>(Km, in_bf16, k0, N, k_rm, k_tr);
    stage_tile<D>(Vm, in_bf16, k0, N, v_rm, nullptr);
    __syncthreads();
    mul_rows<D>(qa, k_rm, s);
    mul_rows<D>(doa, v_rm, dp);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * nt + 2 * t + (e & 1);
        const float val = key < N ? scaled(s[nt][e], sc) : -INFINITY;
        const float p = fast_exp(val - m[e >> 1]) * inv_l[e >> 1];
        s[nt][e] = scaled(p * (dp[nt][e] - dl[e >> 1]), sc);
      }
    }
    uint32_t dsa[4][4];
    as_a(s, dsa);
    mul_cols<D>(dsa, k_tr, acc);
  }
  store_rows<D>(const_cast<void*>(matrix(dq, in_bf16, base)), in_bf16, r0, N,
                acc);
}

// -------------------------------------------------------- backward, dk, dv
template <int D>
__global__ void __launch_bounds__(kThreads)
mha_bwd_dkv_kernel(const void* __restrict__ q, const void* __restrict__ k,
                   const void* __restrict__ v, int in_bf16,
                   const float* __restrict__ dout,
                   const float* __restrict__ row_max,
                   const float* __restrict__ row_sum,
                   const float* __restrict__ delta, int N, int tiles, Scale sc,
                   void* __restrict__ dk, void* __restrict__ dv) {
  __shared__ __align__(16) __nv_bfloat16 q_rm[kTile * (D + kPad)];
  __shared__ __align__(16) __nv_bfloat16 q_tr[D * (kTile + kPad)];
  __shared__ __align__(16) __nv_bfloat16 do_rm[kTile * (D + kPad)];
  __shared__ __align__(16) __nv_bfloat16 do_tr[D * (kTile + kPad)];
  __shared__ float sm[kTile], sil[kTile], sd[kTile];  // max, 1 / sum, delta
  const int bh = blockIdx.x / tiles;
  const int key0 = (blockIdx.x % tiles) * kTile;
  const size_t base = (size_t)bh * N * D;
  const void* Q = matrix(q, in_bf16, base);
  const void* Km = matrix(k, in_bf16, base);
  const void* Vm = matrix(v, in_bf16, base);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int r0 = key0 + warp * 16;

  uint32_t ka[D / 16][4], va[D / 16][4];
  load_a<D>(Km, in_bf16, r0, N, ka);
  load_a<D>(Vm, in_bf16, r0, N, va);

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[nd][e] = dv_acc[nd][e] = 0.0f;
  float st[8][4], dpt[8][4];
  for (int q0 = 0; q0 < N; q0 += kTile) {
    __syncthreads();
    stage_tile<D>(Q, in_bf16, q0, N, q_rm, q_tr);
    stage_tile<D>(dout + base, 0, q0, N, do_rm, do_tr);
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      const bool in = row < N;
      sm[threadIdx.x] = in ? row_max[(size_t)bh * N + row] : 0.0f;
      sil[threadIdx.x] = in ? 1.0f / row_sum[(size_t)bh * N + row] : 1.0f;
      sd[threadIdx.x] = in ? delta[(size_t)bh * N + row] : 0.0f;
    }
    __syncthreads();
    mul_rows<D>(ka, q_rm, st);    // S^T: keys by queries
    mul_rows<D>(va, do_rm, dpt);  // dP^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = 8 * nt + 2 * t + (e & 1);
        float p = 0.0f;  // a query row past N adds nothing
        if (q0 + qi < N)
          p = fast_exp(scaled(st[nt][e], sc) - sm[qi]) * sil[qi];
        st[nt][e] = p;
        dpt[nt][e] = scaled(p * (dpt[nt][e] - sd[qi]), sc);
      }
    }
    uint32_t pa[4][4];
    as_a(st, pa);
    mul_cols<D>(pa, do_tr, dv_acc);
    as_a(dpt, pa);
    mul_cols<D>(pa, q_tr, dk_acc);
  }
  store_rows<D>(const_cast<void*>(matrix(dk, in_bf16, base)), in_bf16, r0, N,
                dk_acc);
  store_rows<D>(const_cast<void*>(matrix(dv, in_bf16, base)), in_bf16, r0, N,
                dv_acc);
}

Scale make_scale(float scale) {
  int e;
  Scale sc;
  sc.scale = scale;
  sc.inv = 1.0f / scale;
  sc.use_div = fabsf(frexpf(scale, &e)) == 0.5f ? 0 : 1;
  return sc;
}

template <int D>
cudaError_t fwd(const void* q, const void* k, const void* v, int in_bf16,
                int BH, int N, float scale, float* out, float* o32,
                float* row_max, float* row_sum, cudaStream_t stream) {
  const int tiles = (N + kTile - 1) / kTile;
  mha_fwd_kernel<D><<<(unsigned)((long long)BH * tiles), kThreads, 0, stream>>>(
      q, k, v, in_bf16, N, tiles, make_scale(scale), out, o32, row_max,
      row_sum);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd(const void* q, const void* k, const void* v, int in_bf16,
                const float* dout, const float* o32, const float* row_max,
                const float* row_sum, int BH, int N, float scale, void* dq,
                void* dk, void* dv, float* delta, cudaStream_t stream) {
  const int tiles = (N + kTile - 1) / kTile;
  const unsigned blocks = (unsigned)((long long)BH * tiles);
  const Scale sc = make_scale(scale);
  mha_bwd_dq_kernel<D><<<blocks, kThreads, 0, stream>>>(
      q, k, v, in_bf16, dout, o32, row_max, row_sum, N, tiles, sc, dq, delta);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  mha_bwd_dkv_kernel<D><<<blocks, kThreads, 0, stream>>>(
      q, k, v, in_bf16, dout, row_max, row_sum, delta, N, tiles, sc, dk, dv);
  return cudaGetLastError();
}

bool bad_shape(int BH, int N, int D, float scale) {
  return BH <= 0 || N <= 0 || (D != 16 && D != 32 && D != 64) ||
         !(scale > 0.0f) ||
         (long long)BH * ((N + kTile - 1) / kTile) > 2147483647LL;
}

}  // namespace

extern "C" {

// q, k, v (BH, N, D) contiguous, f32 or bf16 (in_bf16) -> out (BH, N, D)
// f32, row_max, row_sum (BH, N) f32 and, when o32 is not null, o32
// (BH, N, D) f32 for the backward. Returns cudaError_t.
int mha_fwd_launch(const void* q, const void* k, const void* v, int in_bf16,
                   int BH, int N, int D, float scale, float* out, float* o32,
                   float* row_max, float* row_sum, cudaStream_t stream) {
  if (bad_shape(BH, N, D, scale)) return cudaErrorInvalidValue;
  if (D == 16)
    return fwd<16>(q, k, v, in_bf16, BH, N, scale, out, o32, row_max, row_sum,
                   stream);
  if (D == 32)
    return fwd<32>(q, k, v, in_bf16, BH, N, scale, out, o32, row_max, row_sum,
                   stream);
  return fwd<64>(q, k, v, in_bf16, BH, N, scale, out, o32, row_max, row_sum,
                 stream);
}

// dout (BH, N, D) f32 and the forward's o32, row_max, row_sum -> dq, dk, dv
// (BH, N, D) in the inputs' type; delta (BH, N) f32 is scratch.
int mha_bwd_launch(const void* q, const void* k, const void* v, int in_bf16,
                   const float* dout, const float* o32, const float* row_max,
                   const float* row_sum, int BH, int N, int D, float scale,
                   void* dq, void* dk, void* dv, float* delta,
                   cudaStream_t stream) {
  if (bad_shape(BH, N, D, scale)) return cudaErrorInvalidValue;
  if (D == 16)
    return bwd<16>(q, k, v, in_bf16, dout, o32, row_max, row_sum, BH, N, scale,
                   dq, dk, dv, delta, stream);
  if (D == 32)
    return bwd<32>(q, k, v, in_bf16, dout, o32, row_max, row_sum, BH, N, scale,
                   dq, dk, dv, delta, stream);
  return bwd<64>(q, k, v, in_bf16, dout, o32, row_max, row_sum, BH, N, scale,
                 dq, dk, dv, delta, stream);
}

const char* apt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
