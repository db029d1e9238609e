// Backward of the differentiable fused SetAbstraction stage for Hopper
// (sm_90a): recompute the grouped rows and the first conv, route each
// output's cotangent to its winning slot, and scatter the input gradients.
//
// Replaces the TPU kernel adaptpoint_tpu/ops/pallas/saeval.py _sa_train_bwd
// (_sa_bwd_kernel), the VJP of sa_train_pallas. Same function as the plain
// version ops/saeval.py sa_train_bwd_plain. With the forward's neighbours
// idx, its winning slots arg (the first slot holding each output's maximum,
// saeval.cu writes both) and its rounding (gg = bf16 gathered rows, h_pre =
// gg . bf16(w1) + b1):
//   g_o   = g_out at the winning slot of each (center, channel), else 0
//   g_h   = (bf16(g_o) . bf16(w2)^T) where h_pre > 0, else 0
//   g_v   = bf16(g_h) . bf16(w1)^T * scale_row   (dp columns times dp_scale)
//   bf16(g_v) is scattered onto each slot's neighbour row: columns 0..2 to
//   g_xyz, 3.. to g_feats (an empty ball's slot 0 is point 0);
//   the center's row gets g_new - sum_k g_v[:3] (when relative) and g_fi,
//   unrounded.
// With param_grads also gw2 = hb^T bf16(g_o), gb2 = sum g_o, gw1 = gg^T
// bf16(g_h), gb1 = sum g_h, hb = bf16(relu(h_pre)) (padded (Wp, midp),
// (midp), (midp, coutp), (coutp); summed over all centers with atomics). The
// frozen classifier of the GAN step asks for none of them.
//
// What bounds it: operations. Three bf16 products over the B*M*K rows: the
// recomputed conv1 (Wp x mid), g_h (cout x mid) and g_v (mid x C), 137
// GFLOP at the GAN step's four stages (B = 32, K = 32), 0.14 ms at the
// H100's dense bf16 rate; the bytes (the clouds, features, cotangents and
// gradients once) weigh less.
//
// Design. A block owns TM whole centers, round16(K) rows each, padded to R
// rows, a multiple of 32 of at most 256, and 8 warps; the wrapper picks TM so
// that two blocks fit on an SM where they can (all four GAN stages: 256, 256,
// 128 and 64 rows). The block stages the gathered rows A (R x Wp bf16, flat
// over rows and 16-byte pieces, eight loads in flight a thread) in shared
// memory, rows padded by 16 bytes so that ldmatrix is free of bank conflicts,
// and of the cotangents only bf16(g_out) and the winning slot of each (center,
// channel): one read of g_out and arg each. The weights stream through a
// double buffer of 64 k-rows a stage, the next stage filled by cp.async while
// one is multiplied; one ring runs through the block's whole schedule: for
// each pass over the hidden columns, conv1's chunks of w1 then g_h's chunks of
// w2; then for each pass over the feature columns g_v's chunks of w1. A pass
// covers the columns of 16 warp tiles of 32 x 32 (two a warp, sharing their
// rows and A fragments), at most 256. Products are mma.sync m16n8k16 (bf16 in,
// f32 accumulators in registers): A and B fragments by ldmatrix, except g_h's
// A, GO, which is built in registers from the compact cotangents (bf16(g_out)
// where the column's winning slot is the row's, a byte compare and a mask a
// pair), so GO (R x cout) never exists. The epilogues work on the accumulators
// in the fragment layout: conv1's gives a bit mask (h_pre > 0), g_h's applies
// it, rounds to bf16 and stores GH (R x mid; over A's space when one pass
// covers the hidden columns), g_v's rounds and scatters. g_v's columns are the
// features only: column n multiplies w1's row 3 + n, so a lane pair swaps
// halves of its fragment and each lane adds 4 consecutive features of one row
// with one vector reduction (REDG.F32x4, float4 atomicAdd) where C % 4 == 0.
// The three dp columns are dot products of GH's rows with w1's rows 0..2 on
// the CUDA cores, each row's value then summed per center in slot order (no
// shared-memory atomics, which would all hit one address). Rows past K and
// centers past M are never scattered; a slot that wins no output scatters
// zeros, which are skipped. With param_grads GO is staged dense (for gw2 =
// hb^T GO, by wmma from shared memory, with hb recomputed over the ring's
// space); that path is not the GAN step's.
//
// The mask equals the forward's ReLU: conv1 is recomputed from the same
// bf16 rows and weights with the same instruction (saeval.cu's wmma 16x16x16
// lowers to HMMA.16816.F32.BF16) over the same k16 steps in the same order
// from zero, and b1 is added the same way, so h_pre is the forward's bit for
// bit.
//
// Determinism: the scatter's atomic adds land in no fixed order (the usual
// f32 reordering error); everything before them is fixed.
#include "sa_common.cuh"

#include <cstdint>

namespace {

using namespace apt_sa;

constexpr int kKc = 64;        // k rows a ring stage holds
constexpr int kStages = 2;     // ring depth: a double buffer (3 stages
                               // measured no faster on the H100)
constexpr int kPad = 8;        // bf16 of padding per staged row
constexpr int kPassTiles = 2 * kWarps;  // 32 x 32 tiles a pass: 2 a warp

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

// Output columns one pass covers with R rows: 16 warp tiles, at most 256
// columns (the double buffer's stages grow with them).
__host__ __device__ inline int pass_cols(int R) {
  const int n = (kPassTiles / (R / 32)) * 32;
  return n < 256 ? n : 256;
}

// Rows of a block: its TM centers' round16(K) rows each, padded to a
// multiple of 32 with rows that hold nothing.
__host__ __device__ inline int block_rows(int TM, int K) {
  return (TM * round16(K) + 31) / 32 * 32;
}

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
  int relative, vec;
  float* g_xyz;    // (B, N, 3) or null
  float* g_feats;  // (B, N, C) or null
  float* gw1;      // (Wp, midp), gb1 (midp), gw2 (midp, coutp), gb2
  float* gb1;      // (coutp): all null without param_grads
  float* gw2;
  float* gb2;
};

struct Layout {
  size_t a, gh, go, gc, ac, h, sc, slot, ring, rowj, dpv, qs, dps, w1dp,
      total;
};

__host__ __device__ inline Layout layout(int TM, int K, int Wp, int midp,
                                         int coutp, int C, int pg) {
  const int R = block_rows(TM, K);
  const int np = pass_cols(R);
  const int np1 = imin(np, midp), np3 = imin(np, round16(C));
  const size_t a = (size_t)R * (Wp + kPad) * 2;
  const size_t gh = (size_t)R * (midp + kPad) * 2;
  const bool alias = !pg && midp <= np;  // GH over A: A is dead by then
  Layout L;
  size_t o = 0;
  L.a = o;
  o += align128(alias && gh > a ? gh : a);
  L.gh = alias ? L.a : o;
  if (!alias) o += align128(gh);
  // GO dense (R x coutp) only with param_grads, for gw2; else the compact
  // bf16(g_out) and winning slots of the TM centers, from which g_h's A
  // fragments are built in registers
  L.go = o;
  if (pg) o += align128((size_t)R * (coutp + kPad) * 2);
  L.gc = o;
  o += align128((size_t)TM * coutp * 2);
  L.ac = o;
  o += align128((size_t)TM * coutp);
  L.slot = align128((size_t)2 * imax(imax(kKc * (np1 + kPad),
                                          np1 * (kKc + kPad)),
                                     np3 * (kKc + kPad)));
  // after the schedule the ring's space holds w1's dp rows and the rows' dp
  // values, then with param_grads hb and the wmma scratch
  L.ring = o;
  L.w1dp = o;
  L.dpv = o + align128((size_t)3 * midp * 4);
  L.h = o;
  L.sc = o + align128(gh);
  size_t need = (size_t)kStages * L.slot;
  const size_t dp_end = L.dpv + align128((size_t)R * 16) - o;
  const size_t pg_end = L.sc + (size_t)kWarps * 256 * 4 - o;
  if (dp_end > need) need = dp_end;
  if (pg && pg_end > need) need = pg_end;
  o += need;
  L.rowj = o;
  o += align128((size_t)R * 4);
  L.qs = o;
  o += align128((size_t)TM * 16);
  L.dps = o;
  o += align128((size_t)TM * 16);
  L.total = o;
  return L;
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

// g_h's A operand without a dense GO: the compact bf16(g_out) (gc) and
// winning slots (ac) of the block's centers, coutp a center
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
// tiles. A is row-major in shared memory (lda), its k0-th column at A + k0.
// B is the ring stage: trans, [k][n] with n contiguous (ldb), else [n][k]
// with k contiguous (ldb); its k origin is the stage's row or column 0 and
// its n origin the pass's first column.
template <bool kTrans, bool kBuiltA>
__device__ __forceinline__ void tiles_mma(Acc& acc, const Tiles& t,
                                          const bf16* A, int lda, int k0,
                                          const bf16* Bs, int ldb, int ksteps,
                                          int lane, GoSrc go = {}) {
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
          if (kBuiltA)
            go_frag(a[mi], go, gcen[u][mi], gslot[u][mi],
                    k0 + s * 16 + 2 * (lane & 3));
          else
            ldm_x4(a[mi], A + (size_t)(t.rg[u] * 32 + mi * 16 +
                                       (lane & 15)) * lda +
                              k0 + s * 16 + (lane >> 4) * 8);
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

// One 16 x 16 tile of hb = bf16(relu(A . w1 + b1)), rows rt, columns ct,
// as saeval.cu's conv1 computes it (the same wmma steps from zero, then
// the bias), into H (ldh).
__device__ void hb_tile(const bf16* A, int lda, int KT, const bf16* w1,
                        int midp, const float* b1, bf16* H, int ldh, float* sc,
                        int rt, int ct, int lane) {
  FragC acc[1];
  mma_tiles<1, FragA, FragB>(acc, A, lda, (size_t)16 * lda, 16, rt,
                             w1 + ct * 16, midp, (size_t)16 * midp, KT);
  wmma::store_matrix_sync(sc, acc[0], 16, wmma::mem_row_major);
  __syncwarp();
  for (int e = lane; e < 256; e += 32) {
    const float v = fmaxf(__fadd_rn(sc[e], b1[ct * 16 + (e & 15)]), 0.0f);
    H[(size_t)(rt * 16 + (e >> 4)) * ldh + ct * 16 + (e & 15)] =
        __float2bfloat16_rn(v);
  }
  __syncwarp();
}

template <bool kPG>
__global__ void __launch_bounds__(kThreads, 2)
    sa_train_bwd_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(p.TM, p.K, p.Wp, p.midp, p.coutp, p.C, kPG);
  bf16* As = reinterpret_cast<bf16*>(smem + L.a);
  bf16* GH = reinterpret_cast<bf16*>(smem + L.gh);
  bf16* GO = reinterpret_cast<bf16*>(smem + L.go);
  bf16* gc = reinterpret_cast<bf16*>(smem + L.gc);
  unsigned char* ac = smem + L.ac;
  bf16* Hs = reinterpret_cast<bf16*>(smem + L.h);
  float* scratch = reinterpret_cast<float*>(smem + L.sc);
  unsigned char* ring = smem + L.ring;
  int* rowj = reinterpret_cast<int*>(smem + L.rowj);
  float* qs = reinterpret_cast<float*>(smem + L.qs);
  float* dps = reinterpret_cast<float*>(smem + L.dps);
  float* dpv = reinterpret_cast<float*>(smem + L.dpv);
  float* w1dp = reinterpret_cast<float*>(smem + L.w1dp);

  const int b = blockIdx.y;
  const int m0 = blockIdx.x * p.TM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int q = lane & 3;
  const float* X = p.xyz + (size_t)b * p.N * 3;
  const int K = p.K;
  const int Kp = round16(K);
  const int Rv = p.TM * Kp;  // rows of centers; R - Rv padding rows
  const int R = block_rows(p.TM, K);
  const int lda = p.Wp + kPad;
  const int ldgo = p.coutp + kPad;
  const int ldgh = p.midp + kPad;
  const int np = pass_cols(R);
  const int C16 = round16(p.C);

  // the ring's schedule: for each pass over the hidden columns, conv1's
  // chunks of w1 (n1) then g_h's chunks of w2 (n2); then for each pass over
  // the feature columns g_v's chunks of w1 (n3)
  const int n1 = (p.Wp + kKc - 1) / kKc;
  const int n2 = (p.coutp + kKc - 1) / kKc;
  const int n3 = (p.midp + kKc - 1) / kKc;
  const int passes1 = (p.midp + np - 1) / np;
  const int passes3 = p.g_feats ? (C16 + np - 1) / np : 0;
  const int items = passes1 * (n1 + n2) + passes3 * n3;

  // item i -> kind (0 conv1, 1 g_h, 2 g_v), pass, chunk
  auto decode = [&](int i, int& kind, int& pass, int& chunk) {
    if (i < passes1 * (n1 + n2)) {
      pass = i / (n1 + n2);
      chunk = i - pass * (n1 + n2);
      kind = chunk < n1 ? 0 : 1;
      if (kind) chunk -= n1;
    } else {
      i -= passes1 * (n1 + n2);
      pass = i / n3;
      chunk = i - pass * n3;
      kind = 2;
    }
  };

  // one ring stage: rows x vr pieces of 16 bytes, (row, piece) without a
  // division where vr is a power of two
  auto load_item = [&](int i) {
    bf16* dst = reinterpret_cast<bf16*>(ring + (size_t)(i % kStages) * L.slot);
    int kind, pass, chunk;
    decode(i, kind, pass, chunk);
    const int n0 = pass * np;
    const int k0 = chunk * kKc;
    // kind 0: w1[k0 .. k0 + kk][n0 .. n0 + nw] as [k][n]; kind 1:
    // w2[n0 .. n0 + nw][k0 .. k0 + kk] as [n][k]; kind 2: w1[3 + n0 ..
    // 3 + n0 + nw][k0 .. k0 + kk] as [n][k]
    const int nw = imin(np, (kind == 2 ? C16 : p.midp) - n0);
    const int kk = imin(kKc, (kind == 0 ? p.Wp : kind == 1 ? p.coutp
                                                           : p.midp) - k0);
    const int rows = kind == 0 ? kk : nw;
    const int vr = (kind == 0 ? nw : kk) / 8;
    const int ld = kind == 0 ? nw + kPad : kKc + kPad;
    const bool pow2 = (vr & (vr - 1)) == 0;
    const int sh = __ffs(vr) - 1;
    for (int e = tid; e < rows * vr; e += kThreads) {
      const int r = pow2 ? e >> sh : e / vr;
      const int v = e - r * vr;
      const bf16* src;
      bool ok = true;
      if (kind == 0) {
        src = p.w1 + (size_t)(k0 + r) * p.midp + n0 + v * 8;
      } else if (kind == 1) {
        src = p.w2 + (size_t)(n0 + r) * p.coutp + k0 + v * 8;
      } else {
        const int w = 3 + n0 + r;
        ok = w < p.Wp;
        src = p.w1 + (size_t)(ok ? w : 0) * p.midp + k0 + v * 8;
      }
      cp_async16(dst + r * ld + v * 8, src, ok);
    }
  };

  // the first weight chunks are on their way while the rows are staged
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < items) load_item(s);
    cp_commit();
  }

  // 1. each row's neighbour, b * N + j, or -1 for a slot past K or a center
  //    past M (its rows stay zero and contribute nothing); the centers; GO
  //    zeroed with param_grads, else the compact cotangents
  for (int c = warp; c < p.TM; c += kWarps) {
    const int m = m0 + c;
    const bool valid = m < p.M;
    const size_t bm = (size_t)b * p.M + m;
    const int qi = valid ? p.qidx[bm] : 0;
    for (int k = lane; k < Kp; k += 32)
      rowj[c * Kp + k] = valid && k < K ? b * p.N + p.idx[bm * K + k] : -1;
    if (lane < 4) {
      qs[c * 4 + lane] = lane < 3 ? X[3 * qi + lane] : 0.0f;
      dps[c * 4 + lane] = 0.0f;
    }
  }
  for (int r = Rv + tid; r < R; r += kThreads) rowj[r] = -1;
  if (kPG) {
    uint4* go4 = reinterpret_cast<uint4*>(GO);
    const int n16 = R * ldgo / 8;
    for (int e = tid; e < n16; e += kThreads) go4[e] = make_uint4(0, 0, 0, 0);
  } else {
    // compact: bf16(g_out) and the winning slot of each (center, channel);
    // slot 0xff for a channel past cout or a center past M
    const int tmv = imin(p.TM, p.M - m0);
    for (int e = tid; e < p.TM * p.coutp; e += kThreads) {
      const int c = e / p.coutp;
      const int col = e - c * p.coutp;
      const bool ok = c < tmv && col < p.cout;
      const size_t o = ((size_t)b * p.M + m0 + c) * p.cout + col;
      gc[e] = __float2bfloat16_rn(ok ? p.g_out[o] : 0.0f);
      ac[e] = ok ? p.arg[o] : 0xff;
    }
  }
  __syncthreads();

  // 2. the gathered rows [dp || fj] as bf16, exactly as the forward stages
  //    them (sa_common.cuh stage_rows); rows that hold no slot are zero.
  //    Flat over (row, piece of 4 features or 1), eight loads in flight a
  //    thread; with param_grads GO's winners, four a thread.
  if (tid < R) {
    const int r = tid;
    const int j = rowj[r];
    float v[3] = {0.0f, 0.0f, 0.0f};
    if (j >= 0) {
      const float* qc = qs + (r / Kp) * 4;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const float x = p.xyz[(size_t)j * 3 + d];
        const float hf = bf16r(x);
        v[d] = __fadd_rn(hf, bf16r(__fsub_rn(x, hf)));
        if (p.relative) v[d] = __fmul_rn(__fsub_rn(v[d], qc[d]), p.dp_scale);
      }
    }
#pragma unroll
    for (int d = 0; d < 3; ++d)
      As[(size_t)r * lda + d] = __float2bfloat16_rn(v[d]);
  }
  {
    const int pw = p.vec ? 4 : 1;  // features a piece
    const int P = p.C / pw;
    const int total = R * P;
    for (int e0 = tid; e0 < total; e0 += 8 * kThreads) {
      float4 v[8];
      int at[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + u * kThreads;
        v[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        at[u] = -1;
        if (e < total) {
          const int r = e / P;
          const int f = (e - r * P) * pw;
          const int j = rowj[r];
          at[u] = r * lda + 3 + f;
          if (j >= 0) {
            const float* src = p.feats + (size_t)j * p.C + f;
            if (p.vec)
              v[u] = *reinterpret_cast<const float4*>(src);
            else
              v[u].x = *src;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (at[u] < 0) continue;
        As[at[u]] = __float2bfloat16_rn(v[u].x);
        if (p.vec) {
          As[at[u] + 1] = __float2bfloat16_rn(v[u].y);
          As[at[u] + 2] = __float2bfloat16_rn(v[u].z);
          As[at[u] + 3] = __float2bfloat16_rn(v[u].w);
        }
      }
    }
    const int padc = p.Wp - p.C - 3;  // zero columns past the features
    for (int e = tid; e < R * padc; e += kThreads) {
      const int r = e / padc;
      As[(size_t)r * lda + p.C + 3 + (e - r * padc)] =
          __float2bfloat16_rn(0.0f);
    }
  }
  if (kPG) {  // GO dense: bf16(g_out) at each output's winning row
    const int tmv = imin(p.TM, p.M - m0);  // centers that exist
    const int total = tmv * p.cout;
    const size_t o0 = ((size_t)b * p.M + m0) * p.cout;
    for (int e0 = tid; e0 < total; e0 += 4 * kThreads) {
      float v[4];
      int k[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * kThreads;
        k[u] = K;
        if (e < total) {
          k[u] = p.arg[o0 + e];
          v[u] = p.g_out[o0 + e];
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * kThreads;
        if (e >= total) continue;
        const int c = e / p.cout;
        const int col = e - c * p.cout;
        if (k[u] < K)
          GO[(size_t)(c * Kp + k[u]) * ldgo + col] = __float2bfloat16_rn(v[u]);
        atomicAdd(p.gb2 + col, v[u]);
      }
    }
  }

  // 3. the schedule, one ring stage an iteration
  Acc acc;
  uint32_t mask[2] = {0u, 0u};
  for (int i = 0; i < items; ++i) {
    cp_wait<kStages - 2>();
    __syncthreads();
    if (i + kStages - 1 < items) load_item(i + kStages - 1);
    cp_commit();
    const bf16* Bs =
        reinterpret_cast<const bf16*>(ring + (size_t)(i % kStages) * L.slot);
    int kind, pass, chunk;
    decode(i, kind, pass, chunk);
    const int n0 = pass * np;
    const int nw = imin(np, (kind == 2 ? C16 : p.midp) - n0);
    const Tiles t = tiles_of(warp, R, nw);
    if (chunk == 0) zero_acc(acc);
    const int k0 = chunk * kKc;
    if (kind == 0) {
      tiles_mma<true, false>(acc, t, As, lda, k0, Bs, nw + kPad,
                      imin(kKc, p.Wp - k0) / 16, lane);
      if (chunk == n1 - 1) {
        // conv1's epilogue: the mask h_pre = acc + b1 > 0, as the forward
        // adds the bias
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          uint32_t bits = 0u;
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            if (ni >= 2 * t.pairs[u]) continue;
            const int col = n0 + t.cg[u] * 32 + ni * 8 + 2 * q;
            const float bb0 = p.b1[col], bb1 = p.b1[col + 1];
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              const float* c = acc[u][mi][ni];
              const float h0 = __fadd_rn(c[0], bb0), h1 = __fadd_rn(c[1], bb1);
              const float h2 = __fadd_rn(c[2], bb0), h3 = __fadd_rn(c[3], bb1);
              const int bit = (mi * 4 + ni) * 4;
              bits |= (h0 > 0.0f ? 1u : 0u) << bit;
              bits |= (h1 > 0.0f ? 1u : 0u) << (bit + 1);
              bits |= (h2 > 0.0f ? 1u : 0u) << (bit + 2);
              bits |= (h3 > 0.0f ? 1u : 0u) << (bit + 3);
            }
          }
          mask[u] = bits;
        }
      }
    } else if (kind == 1) {
      if (kPG)
        tiles_mma<false, false>(acc, t, GO, ldgo, k0, Bs, kKc + kPad,
                                imin(kKc, p.coutp - k0) / 16, lane);
      else
        tiles_mma<false, true>(acc, t, nullptr, 0, k0, Bs, kKc + kPad,
                               imin(kKc, p.coutp - k0) / 16, lane,
                               {gc, ac, p.coutp, Kp, Rv});
      if (chunk == n2 - 1) {
        // g_h's epilogue: masked, rounded to bf16 into GH; with param_grads
        // the column sums of the unrounded masked g_h go to gb1
#pragma unroll
        for (int u = 0; u < 2; ++u) {
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            if (ni >= 2 * t.pairs[u]) continue;
            const int col = n0 + t.cg[u] * 32 + ni * 8 + 2 * q;
            float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              const float* c = acc[u][mi][ni];
              const int bit = (mi * 4 + ni) * 4;
              const float v0 = (mask[u] >> bit) & 1u ? c[0] : 0.0f;
              const float v1 = (mask[u] >> (bit + 1)) & 1u ? c[1] : 0.0f;
              const float v2 = (mask[u] >> (bit + 2)) & 1u ? c[2] : 0.0f;
              const float v3 = (mask[u] >> (bit + 3)) & 1u ? c[3] : 0.0f;
              const int row = t.rg[u] * 32 + mi * 16 + g;
              *reinterpret_cast<__nv_bfloat162*>(GH + (size_t)row * ldgh +
                                                 col) =
                  __floats2bfloat162_rn(v0, v1);
              *reinterpret_cast<__nv_bfloat162*>(GH + (size_t)(row + 8) *
                                                          ldgh + col) =
                  __floats2bfloat162_rn(v2, v3);
              if (kPG) {
                s0 = __fadd_rn(s0, __fadd_rn(v0, v2));
                s1 = __fadd_rn(s1, __fadd_rn(v1, v3));
              }
            }
            if (kPG) {
#pragma unroll
              for (int o = 4; o < 32; o <<= 1) {
                s0 = __fadd_rn(s0, __shfl_xor_sync(0xffffffffu, s0, o));
                s1 = __fadd_rn(s1, __shfl_xor_sync(0xffffffffu, s1, o));
              }
              if (g == 0) {
                if (s0 != 0.0f) atomicAdd(p.gb1 + col, s0);
                if (s1 != 0.0f) atomicAdd(p.gb1 + col + 1, s1);
              }
            }
          }
        }
      }
    } else {
      tiles_mma<false, false>(acc, t, GH, ldgh, k0, Bs, kKc + kPad,
                       imin(kKc, p.midp - k0) / 16, lane);
      if (chunk == n3 - 1) {
        // g_v's epilogue: features n0 + column, rounded to bf16, onto the
        // neighbour rows; lanes 2i and 2i + 1 swap halves so that each
        // holds 4 consecutive columns of one row
        const bool odd = q & 1;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            if (ni >= 2 * t.pairs[u]) continue;
            const int col = n0 + t.cg[u] * 32 + ni * 8 + (q >> 1) * 4;
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              const float* c = acc[u][mi][ni];
              const float r0 = __shfl_xor_sync(0xffffffffu,
                                               odd ? c[0] : c[2], 1);
              const float r1 = __shfl_xor_sync(0xffffffffu,
                                               odd ? c[1] : c[3], 1);
              const int row = t.rg[u] * 32 + mi * 16 + g + (odd ? 8 : 0);
              const int j = rowj[row];
              if (j < 0 || col >= p.C) continue;
              const float v0 = bf16r(odd ? r0 : c[0]);
              const float v1 = bf16r(odd ? r1 : c[1]);
              const float v2 = bf16r(odd ? c[2] : r0);
              const float v3 = bf16r(odd ? c[3] : r1);
              if (v0 == 0.0f && v1 == 0.0f && v2 == 0.0f && v3 == 0.0f)
                continue;
              float* dst = p.g_feats + (size_t)j * p.C + col;
              if (p.vec) {
                atomicAdd(reinterpret_cast<float4*>(dst),
                          make_float4(v0, v1, v2, v3));
              } else {
                const float v[4] = {v0, v1, v2, v3};
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  if (col + e < p.C && v[e] != 0.0f) atomicAdd(dst + e, v[e]);
              }
            }
          }
        }
      }
    }
  }
  cp_wait<0>();
  __syncthreads();

  // 4. the dp columns: GH's rows . w1's rows 0..2, times dp_scale; bf16 of
  //    each onto the neighbour's xyz; the unrounded values to dpv, summed
  //    per center (no shared-memory atomics: a center's rows would all add
  //    to one address)
  if (p.g_xyz) {
    for (int e = tid; e < 3 * p.midp; e += kThreads)
      w1dp[e] = __bfloat162float(p.w1[e]);
    __syncthreads();
    const int tpr = kThreads / R;  // threads a row, a power of two
    const int sub = tid % tpr;
    for (int r0 = 0; r0 < R; r0 += kThreads / tpr) {
      const int r = r0 + tid / tpr;
      const bool valid = r < R && rowj[r] >= 0;
      float s[3] = {0.0f, 0.0f, 0.0f};
      if (valid) {
        const bf16* hr = GH + (size_t)r * ldgh;
        for (int m = 2 * sub; m < p.midp; m += 2 * tpr) {
          const __nv_bfloat162 h2 =
              *reinterpret_cast<const __nv_bfloat162*>(hr + m);
          const float h0 = __low2float(h2), h1 = __high2float(h2);
#pragma unroll
          for (int d = 0; d < 3; ++d)
            s[d] = __fadd_rn(s[d],
                             __fadd_rn(__fmul_rn(h0, w1dp[d * p.midp + m]),
                                       __fmul_rn(h1, w1dp[d * p.midp + m + 1])));
        }
      }
      for (int o = 1; o < tpr; o <<= 1)
#pragma unroll
        for (int d = 0; d < 3; ++d)
          s[d] = __fadd_rn(s[d], __shfl_xor_sync(0xffffffffu, s[d], o));
      if (r < R && sub == 0) {
        const int j = rowj[r];
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          const float v = valid ? __fmul_rn(s[d], p.dp_scale) : 0.0f;
          dpv[r * 4 + d] = v;
          const float vb = bf16r(v);
          if (vb != 0.0f) atomicAdd(p.g_xyz + (size_t)j * 3 + d, vb);
        }
      }
    }
    __syncthreads();
    // each center's sum over its slots, in slot order
    if (p.relative)
      for (int e = tid; e < p.TM * 3; e += kThreads) {
        const int c = e / 3;
        const int d = e - c * 3;
        float sum = 0.0f;
        for (int k = 0; k < K; ++k)
          sum = __fadd_rn(sum, dpv[(c * Kp + k) * 4 + d]);
        dps[c * 4 + d] = sum;
      }
    __syncthreads();
  }

  // 5. the centers' own rows: g_new - sum_k g_dp, and g_fi
  for (int c = warp; c < p.TM; c += kWarps) {
    const int m = m0 + c;
    if (m >= p.M) continue;
    const size_t bm = (size_t)b * p.M + m;
    const int qi = p.qidx[bm];
    if (p.g_xyz && lane < 3) {
      float v = p.g_new ? p.g_new[bm * 3 + lane] : 0.0f;
      if (p.relative) v = __fsub_rn(v, dps[c * 4 + lane]);
      atomicAdd(p.g_xyz + ((size_t)b * p.N + qi) * 3 + lane, v);
    }
    if (p.g_feats && p.g_fi)
      for (int cc = lane; cc < p.C; cc += 32)
        atomicAdd(p.g_feats + ((size_t)b * p.N + qi) * p.C + cc,
                  p.g_fi[bm * p.C + cc]);
  }

  // 6. with param_grads: hb = bf16(relu(h_pre)) as the forward computes it,
  //    over the ring; gw2 += hb^T . GO, gw1 += A^T . GH (wmma from shared
  //    memory and w1 from L2; not on the GAN step's path)
  if (kPG) {
    float* sc = scratch + warp * 256;
    const int MT = p.midp / 16, CT = p.coutp / 16, WT = p.Wp / 16;
    for (int u = warp; u < (R / 16) * MT; u += kWarps)
      hb_tile(As, lda, WT, p.w1, p.midp, p.b1, Hs, ldgh, sc, u / MT, u % MT,
              lane);
    __syncthreads();
    for (int u = warp; u < MT * CT; u += kWarps)
      weight_grad_tile(Hs, ldgh, GO, ldgo, R, p.gw2, p.coutp, sc, u / CT,
                       u % CT, lane);
    for (int u = warp; u < WT * MT; u += kWarps)
      weight_grad_tile(As, lda, GH, ldgh, R, p.gw1, p.midp, sc, u / MT,
                       u % MT, lane);
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs at these sizes (bytes), with (pg = 1) or
// without the weight gradients; TM * round16(K) rounded up to a multiple of
// 32 must be at most 256 rows.
long long sa_train_bwd_smem_bytes(int TM, int K, int Wp, int midp, int coutp,
                                  int C, int pg) {
  return (long long)layout(TM, K, Wp, midp, coutp, C, pg).total;
}

// xyz (B,N,3), feats (B,N,C) f32, qidx (B,M) i32, idx (B,M,K) i32 and arg
// (B,M,cout) u8 of the forward; w1 (Wp,midp) bf16, b1 (midp) f32, w2
// (midp,coutp) bf16 as the forward took them; g_out (B,M,cout) f32, g_new
// (B,M,3) and g_fi (B,M,C) f32 or null -> g_xyz (B,N,3), g_feats (B,N,C)
// f32 (either null to skip it) and, when gw1 is not null, gw1 (Wp,midp),
// gb1 (midp), gw2 (midp,coutp), gb2 (coutp) f32. TM centers a block. Every
// output is zeroed here on the stream. Returns cudaError_t.
int sa_train_bwd_launch(const float* xyz, const int* qidx, const float* feats,
                        const int* idx, const unsigned char* arg,
                        const void* w1, const float* b1, const void* w2,
                        const float* g_out, const float* g_new,
                        const float* g_fi, int B, int N, int M, int C, int K,
                        int TM, int Wp, int midp, int coutp, int cout,
                        float dp_scale, int relative, float* g_xyz,
                        float* g_feats, float* gw1, float* gb1, float* gw2,
                        float* gb2, cudaStream_t stream) {
  const bool pg = gw1 != nullptr;
  if (B <= 0 || N <= 0 || M <= 0 || K <= 0 || TM <= 0 ||
      block_rows(TM, K) > 256 || Wp % 16 || midp % 16 || coutp % 16 || Wp < C + 3 ||
      cout > coutp || (pg && !(gb1 && gw2 && gb2)))
    return cudaErrorInvalidValue;
  const size_t smem = layout(TM, K, Wp, midp, coutp, C, pg).total;
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
  // 16-byte feature reads and vector reductions where rows and pointers
  // allow them
  p.vec = C % 4 == 0 && (reinterpret_cast<uintptr_t>(feats) & 15) == 0 &&
          (reinterpret_cast<uintptr_t>(g_feats) & 15) == 0;
  p.g_xyz = g_xyz;
  p.g_feats = g_feats;
  p.gw1 = gw1;
  p.gb1 = pg ? gb1 : nullptr;
  p.gw2 = pg ? gw2 : nullptr;
  p.gb2 = pg ? gb2 : nullptr;
  void (*kernel)(Params) =
      pg ? sa_train_bwd_kernel<true> : sa_train_bwd_kernel<false>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((M + TM - 1) / TM, B);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

const char* apt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
