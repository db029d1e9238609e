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
// each center and, for each output, the first slot that holds the maximum
// (b2 added before a strict compare: torch.argmax's rule): the backward
// then routes the cotangent to that slot without comparing a recomputed
// value with the saved maximum.
//
// What bounds it: operations. The two convs over the B*M*K rows, about 97
// GFLOP at the GAN step's four stages (B = 32, K = 32), 0.099 ms at the
// H100's dense bf16 rate, and the ball query's distances (f32, ~0.01 ms);
// the bytes (the clouds, features and outputs once) weigh less.
//
// Design. A block of 8 warps owns TM whole centers of one cloud, Kp =
// round16(K) rows each (Rv = TM * Kp rows, at most 256; the tiles run over R
// = Rv rounded up to 32, rows past Rv reading row Rv - 1 and dropped), and
// walks `tiles` consecutive tiles of centers of its cloud; the host picks TM
// so that two blocks fit on an SM where they can (ops/saeval.py
// _fwd_tiling: 256, 256, 128 and 64 rows at PointNeXt-S's four stages). Per
// block the cloud's xyz is staged in shared memory once, with 16-byte
// loads, a point to 16 bytes, where it fits. Per tile:
//   1. the ball query, one warp a center, 128 points an iteration (four
//      loads, distances and ballots in flight, then the ranks), into a row
//      table (each row's neighbour, -1 for slots past K);
//   2. the rows A = gg (Rv x Wp bf16) in shared memory, flat over (row,
//      piece of 4 features), eight 16-byte loads in flight a thread, rows
//      padded by 16 bytes so that ldmatrix is free of bank conflicts;
//   3. conv1 then conv2 as passes of 16 warp tiles of 32 x 32 (two a warp,
//      sharing their rows and A fragments), mma.sync m16n8k16 with ldmatrix
//      fragments (sa_common.cuh tiles_mma, the backward's product), the
//      weights streaming through a cp.async double buffer of kc k-rows a
//      stage that runs on across the tiles (the next tile's first w1 chunk
//      loads during this tile's last stage, ball query and staging);
//      conv1's epilogue adds b1 (two a lane, in registers), applies the ReLU
//      and rounds to bf16 on the accumulator fragments and stores H (Rv x
//      mid) in shared memory, over A when one pass covers the hidden
//      columns (after a barrier);
//      conv2's epilogue adds b2 and takes each column's max over a 16- or
//      32-row strip of one center: in the lane's own rows, then over the 8
//      lanes of equal lane % 4 (which hold a column of the m16n8 layout) by
//      halving xor-shuffles, 7 for a lane's 8 columns; with the slots (the
//      call under autograd, a template flag) the least slot holding the
//      max, ties to the lower slot as torch.argmax. Where a strip is a
//      whole center (K <= 32) the lanes write out and arg directly,
//      coalesced; else a partial a strip and column of the pass (over A
//      when H is apart), and
//   4. after a barrier, the pass's columns of out and arg from each
//      center's strips in slot order.
// H stays in shared memory: a warp that owned whole row strips would hold
// mid / 2 registers of bf16 H for 32 rows (128 at stage 4) beside conv2's
// accumulators, more than two blocks of 8 warps an SM allow.
//
// Arithmetic: the distance is rounded step by step (__fmul_rn/__fadd_rn,
// -fmad=false) so the selection equals the plain version's. Conv1 runs the
// same code as the backward's recompute (HMMA.16816.F32.BF16 over Wp's k16
// steps in ascending order from zero, then one f32 add of b1), so the
// backward's mask h_pre > 0 is this ReLU bit for bit; conv2's sums run in
// another order than the plain f32 matmul, which can flip one bf16 rounding
// (the tolerance in chip_smoke.py and the tests says so).
#include "sa_common.cuh"
#include "ball_query.cuh"

namespace {

using namespace apt_sa;
using apt_bq::ball_scan;
using apt_bq::stage_points;

struct Params {
  const float* xyz;
  const int* qidx;
  const float* feats;
  const bf16* w1;    // (Wp, midp) row-major, zero padded
  const float* b1;   // (midp)
  const bf16* w2;    // (midp, coutp) row-major, zero padded
  const float* b2;   // (coutp)
  int N, M, C, K, TM, Wp, midp, coutp, cout;
  int np, kc, tiles;  // columns a pass, k rows a ring stage, tiles a block
  float r2, dp_scale;
  int relative, use_xs, vec;
  float* new_xyz;
  float* fi;
  float* out;
  int* idx_out;             // (B, M, K) neighbour indices, or null
  unsigned char* arg_out;   // (B, M, cout) winning slots, or null
};

struct Layout {
  size_t a, h, pv, ps, ring, slot, rowj, qs, xs, total;
};

// Rows of a strip whose max one partial holds: 32 where a center's rows
// fill whole 32-row groups, else 16.
__host__ __device__ inline int strip_rows(int K) {
  return round16(K) % 32 == 0 ? 32 : 16;
}

__host__ __device__ inline Layout layout(int TM, int K, int Wp, int midp,
                                         int coutp, int np, int kc, int N,
                                         int use_xs) {
  const int Rv = TM * round16(K);
  const bool alias = midp <= np;  // one conv1 pass: H over A
  const size_t a = (size_t)Rv * (Wp + kPad) * 2;
  const size_t h = (size_t)Rv * (midp + kPad) * 2;
  // a pass's partials: a strip's max (and slot) a column
  const size_t parts = (size_t)(Rv / strip_rows(K)) * imin(np, coutp);
  const size_t pv = align128(parts * 4);
  const size_t part = pv + align128(parts);
  Layout L;
  size_t o = align128(alias && h > a ? h : a);
  L.a = 0;
  L.h = alias ? 0 : o;
  if (!alias) o += align128(h);
  // the partials over A, dead after conv1, where H is apart and they fit
  if (!alias && part <= align128(a)) {
    L.pv = 0;
  } else {
    L.pv = o;
    o += part;
  }
  L.ps = L.pv + pv;
  L.slot = align128((size_t)kc *
                    (imax(imin(np, midp), imin(np, coutp)) + kPad) * 2);
  L.ring = o;
  o += kStages * L.slot;
  L.rowj = o;
  o += align128((size_t)Rv * 4);
  L.qs = o;
  o += align128((size_t)TM * 16);
  L.xs = o;
  if (use_xs) o += align128((size_t)N * 16);
  L.total = o;
  return L;
}

__device__ __forceinline__ void take_better(float& v, int& s, float ov,
                                            int os) {
  if (ov > v || (ov == v && os < s)) {
    v = ov;
    s = os;
  }
}

// The 8 columns k = 2 ni + e this lane holds of a 32 x 32 warp tile (the
// best value of its rows and, with kArg, the least slot holding it),
// reduced over the 8 lanes of equal lane % 4 by halving: at level l each
// lane keeps half of its columns, chosen by bit l of g = lane / 4, and
// merges its xor-(4 << l) partner's values of them. Lane g ends with column
// k = 4 (g & 1) + (g & 2) + (g >> 2 & 1) in v[0], s[0]; 7 shuffles for 8
// columns (14 with the slots).
template <bool kArg>
__device__ __forceinline__ void reduce_columns(float (&v)[8], int (&s)[8],
                                               int g) {
#pragma unroll
  for (int l = 0; l < 3; ++l) {
    const int n = 4 >> l;
    const bool upper = (g >> l) & 1;
#pragma unroll
    for (int i = 0; i < n; ++i) {
      float keep = upper ? v[i + n] : v[i];
      const float got = __shfl_xor_sync(0xffffffffu, upper ? v[i] : v[i + n],
                                        4 << l);
      if (kArg) {
        int slot = upper ? s[i + n] : s[i];
        const int got_s = __shfl_xor_sync(0xffffffffu,
                                          upper ? s[i] : s[i + n], 4 << l);
        take_better(keep, slot, got, got_s);
        s[i] = slot;
      } else {
        keep = fmaxf(keep, got);
      }
      v[i] = keep;
    }
  }
}

// kArg: also each output's first winning slot (the call under autograd);
// the eval call keeps only the max.
template <bool kArg>
__global__ void __launch_bounds__(kThreads, 2) sa_eval_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(p.TM, p.K, p.Wp, p.midp, p.coutp, p.np, p.kc, p.N,
                          p.use_xs);
  bf16* As = reinterpret_cast<bf16*>(smem + L.a);
  bf16* Hs = reinterpret_cast<bf16*>(smem + L.h);
  float* pv = reinterpret_cast<float*>(smem + L.pv);
  unsigned char* ps = smem + L.ps;
  unsigned char* ring = smem + L.ring;
  int* rowj = reinterpret_cast<int*>(smem + L.rowj);
  float* qs = reinterpret_cast<float*>(smem + L.qs);

  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int K = p.K;
  const int Kp = round16(K);
  const int Rv = p.TM * Kp;
  const int R = (Rv + 31) / 32 * 32;
  const int lda = p.Wp + kPad;
  const int ldh = p.midp + kPad;
  const int pt = strip_rows(K);
  const bool whole = Kp == pt;  // a strip a center: no partials
  const int pc = imin(p.np, p.coutp);  // partials a strip
  const bool alias = p.midp <= p.np;
  const float ninf = __int_as_float((int)0xff800000u);
  const float* Xg = p.xyz + (size_t)b * p.N * 3;
  const float* F = p.feats + (size_t)b * p.N * p.C;

  const int cloud_tiles = (p.M + p.TM - 1) / p.TM;
  const int t0 = blockIdx.x * p.tiles;
  const int t1 = imin(t0 + p.tiles, cloud_tiles);

  // a tile's ring schedule: conv1's chunks of w1 for each pass over the
  // hidden columns, then conv2's chunks of w2 for each pass over cout
  const int n1 = (p.Wp + p.kc - 1) / p.kc;
  const int n2 = (p.midp + p.kc - 1) / p.kc;
  const int items1 = ((p.midp + p.np - 1) / p.np) * n1;
  const int per_tile = items1 + ((p.coutp + p.np - 1) / p.np) * n2;
  const int items = (t1 - t0) * per_tile;

  // a tile's item -> kind (0 conv1, 1 conv2), pass, chunk
  auto decode = [&](int i, int& kind, int& pass, int& chunk) {
    kind = i >= items1;
    if (kind) i -= items1;
    const int n = kind ? n2 : n1;
    pass = i / n;
    chunk = i - pass * n;
  };

  // one ring stage: [k][n], kk rows of nw / 8 pieces of 16 bytes
  auto load_item = [&](int i) {
    bf16* dst = reinterpret_cast<bf16*>(ring + (size_t)(i % kStages) * L.slot);
    int kind, pass, chunk;
    decode(i % per_tile, kind, pass, chunk);
    const int cols = kind ? p.coutp : p.midp;
    const int n0 = pass * p.np;
    const int nw = imin(p.np, cols - n0);
    const int k0 = chunk * p.kc;
    const int kk = imin(p.kc, (kind ? p.midp : p.Wp) - k0);
    const bf16* src = (kind ? p.w2 : p.w1) + (size_t)k0 * cols + n0;
    const int vr = nw / 8;
    const int ld = nw + kPad;
    if ((vr & (vr - 1)) == 0) {  // a fixed piece a thread, rows in steps
      const int sh = __ffs(vr) - 1;
      const int step = kThreads >> sh;
      const int v = (tid & (vr - 1)) * 8;
      for (int r = tid >> sh; r < kk; r += step)
        cp_async16(dst + r * ld + v, src + (size_t)r * cols + v, true);
    } else {
      for (int e = tid; e < kk * vr; e += kThreads) {
        const int r = e / vr;
        const int v = (e - r * vr) * 8;
        cp_async16(dst + r * ld + v, src + (size_t)r * cols + v, true);
      }
    }
  };

  // the first weight chunk is on its way while the cloud is staged
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < items) load_item(s);
    cp_commit();
  }

  // 0. the cloud's xyz, once a block, in shared memory where it fits, a
  //    point to 16 bytes
  float4* xs = nullptr;
  if (p.use_xs) {
    xs = reinterpret_cast<float4*>(smem + L.xs);
    stage_points(xs, Xg, p.N, tid, kThreads);
  }
  auto staged = [&](int j) {
    const float4 v = xs[j];
    return make_float3(v.x, v.y, v.z);
  };
  auto global = [&](int j) {
    return make_float3(Xg[3 * j], Xg[3 * j + 1], Xg[3 * j + 2]);
  };
  auto point = [&](int j) { return xs ? staged(j) : global(j); };

  Acc acc;
  int i = 0;  // the ring's item
  for (int tile = t0; tile < t1; ++tile) {
    const int m0 = tile * p.TM;
    __syncthreads();  // the cloud staged; the last tile's outputs written

    // 1. ball query, one warp a center, into the row table; a center past
    //    M gets rows of zeros and is never written
    for (int c = warp; c < p.TM; c += kWarps) {
      const int m = m0 + c;
      int* rj = rowj + c * Kp;
      if (m >= p.M) {
        for (int k = lane; k < Kp; k += 32) rj[k] = -1;
        if (lane < 4) qs[c * 4 + lane] = 0.0f;
        continue;
      }
      const size_t bm = (size_t)b * p.M + m;
      const int qi = p.qidx[bm];
      const float3 qc = point(qi);
      const int cnt = xs ? ball_scan(staged, qc, p.r2, p.N, K, rj, lane)
                         : ball_scan(global, qc, p.r2, p.N, K, rj, lane);
      __syncwarp();
      const int found = cnt < K ? cnt : K;
      const int first = found > 0 ? rj[0] : 0;
      for (int k = found + lane; k < Kp; k += 32) rj[k] = k < K ? first : -1;
      __syncwarp();
      const float qd = lane == 0 ? qc.x : lane == 1 ? qc.y : qc.z;
      if (lane < 4) qs[c * 4 + lane] = lane < 3 ? qd : 0.0f;
      if (lane < 3) p.new_xyz[bm * 3 + lane] = qd;
      for (int cc = lane; cc < p.C; cc += 32)
        p.fi[bm * p.C + cc] = bf16r(F[(size_t)qi * p.C + cc]);
      if (p.idx_out)
        for (int k = lane; k < K; k += 32) p.idx_out[bm * K + k] = rj[k];
    }
    __syncthreads();

    // 2. the rows [dp || fj] as bf16 (zeros for slots past K and columns
    //    past the features); the first item's barrier publishes them
    for (int r = tid; r < Rv; r += kThreads) {
      const int j = rowj[r];
      float v[3] = {0.0f, 0.0f, 0.0f};
      if (j >= 0) {
        const float* qc = qs + (r / Kp) * 4;
        const float3 x3 = point(j);
        const float x[3] = {x3.x, x3.y, x3.z};
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          const float hf = bf16r(x[d]);
          v[d] = __fadd_rn(hf, bf16r(__fsub_rn(x[d], hf)));
          if (p.relative)
            v[d] = __fmul_rn(__fsub_rn(v[d], qc[d]), p.dp_scale);
        }
      }
      bf16* row = As + (size_t)r * lda;
#pragma unroll
      for (int d = 0; d < 3; ++d) row[d] = __float2bfloat16_rn(v[d]);
      for (int col = p.C + 3; col < p.Wp; ++col)
        row[col] = __float2bfloat16_rn(0.0f);
    }
    {
      const int pw = p.vec ? 4 : 1;  // features a piece
      const int P = p.C / pw;
      const bool pow2 = (P & (P - 1)) == 0;
      const int sh = __ffs(P) - 1;
      const int total = Rv * P;
      for (int e0 = tid; e0 < total; e0 += 8 * kThreads) {
        float4 v[8];
        int at[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int e = e0 + u * kThreads;
          v[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          at[u] = -1;
          if (e < total) {
            const int r = pow2 ? e >> sh : e / P;
            const int f = (e - r * P) * pw;
            const int j = rowj[r];
            at[u] = r * lda + 3 + f;
            if (j >= 0) {
              const float* src = F + (size_t)j * p.C + f;
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
    }

    // 3. the tile's schedule, one ring stage an iteration
    for (int it = 0; it < per_tile; ++it, ++i) {
      cp_wait<kStages - 2>();
      __syncthreads();
      if (i + kStages - 1 < items) load_item(i + kStages - 1);
      cp_commit();
      const bf16* Bs =
          reinterpret_cast<const bf16*>(ring + (size_t)(i % kStages) * L.slot);
      int kind, pass, chunk;
      decode(it, kind, pass, chunk);
      const int n0 = pass * p.np;
      const int nw = imin(p.np, (kind ? p.coutp : p.midp) - n0);
      const int k0 = chunk * p.kc;
      const int kk = imin(p.kc, (kind ? p.midp : p.Wp) - k0);
      const Tiles t = tiles_of(warp, R, nw);
      if (chunk == 0) zero_acc(acc);
      if (kind == 0) {
        tiles_mma<true, false, true>(acc, t, As, lda, k0, Bs, nw + kPad,
                                     kk / 16, lane, {}, Rv - 1);
        if (chunk != n1 - 1) continue;
        // conv1's epilogue: h = bf16(relu(acc + b1)) into H; over A only
        // once every warp is done reading A
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            if (ni >= 2 * t.pairs[u]) continue;
            const int col = n0 + t.cg[u] * 32 + ni * 8 + 2 * q;
            const float2 bb = *reinterpret_cast<const float2*>(p.b1 + col);
            const float bb0 = bb.x, bb1 = bb.y;
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              float* c = acc[u][mi][ni];
              c[0] = fmaxf(__fadd_rn(c[0], bb0), 0.0f);
              c[1] = fmaxf(__fadd_rn(c[1], bb1), 0.0f);
              c[2] = fmaxf(__fadd_rn(c[2], bb0), 0.0f);
              c[3] = fmaxf(__fadd_rn(c[3], bb1), 0.0f);
            }
          }
        if (alias) __syncthreads();
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            const int row = t.rg[u] * 32 + mi * 16 + g;
            if (row - g >= Rv) continue;
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) {
              if (ni >= 2 * t.pairs[u]) continue;
              const int col = n0 + t.cg[u] * 32 + ni * 8 + 2 * q;
              const float* c = acc[u][mi][ni];
              *reinterpret_cast<__nv_bfloat162*>(Hs + (size_t)row * ldh +
                                                 col) =
                  __floats2bfloat162_rn(c[0], c[1]);
              *reinterpret_cast<__nv_bfloat162*>(Hs + (size_t)(row + 8) *
                                                          ldh + col) =
                  __floats2bfloat162_rn(c[2], c[3]);
            }
          }
      } else {
        tiles_mma<true, false, true>(acc, t, Hs, ldh, k0, Bs, nw + kPad,
                                     kk / 16, lane, {}, Rv - 1);
        if (chunk != n2 - 1) continue;
        // conv2's epilogue: v = acc + b2; each column's max over a strip
        // of one center (the two 16-row tiles of a 32-row group together
        // where they are one center's) and with kArg the least slot
        // holding it: in the lane's rows in slot order, then over the
        // lanes by reduce_columns; a partial a strip and column
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (t.pairs[u] == 0) continue;
          const int row0 = t.rg[u] * 32;
          const int c0 = n0 + t.cg[u] * 32 + 2 * q;
          // this lane's slots: rows g and g + 8 of each 16-row tile
          int sl[2];
          bool ok[2][2], live[2];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            const int r0 = row0 + mi * 16;
            live[mi] = r0 < Rv;
            sl[mi] = r0 - (r0 / Kp) * Kp + g;
            ok[mi][0] = live[mi] && sl[mi] < K;
            ok[mi][1] = live[mi] && sl[mi] + 8 < K;
          }
          float2 bias[4];
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            bias[ni] = ni < 2 * t.pairs[u]
                           ? *reinterpret_cast<const float2*>(p.b2 + c0 +
                                                              ni * 8)
                           : make_float2(0.0f, 0.0f);
          const int k = 4 * (g & 1) + (g & 2) + (g >> 2 & 1);
#pragma unroll
          for (int st = 0; st < 2; ++st) {
            if (pt == 32 ? st == 1 : !live[st]) continue;
            float v[8];
            int s[8];
#pragma unroll
            for (int ni = 0; ni < 4; ++ni)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                float best = ninf;
                int slot = 0xff;
#pragma unroll
                for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                  for (int h = 0; h < 2; ++h) {
                    if (pt != 32 && mi != st) continue;
                    const float x =
                        ok[mi][h] ? __fadd_rn(acc[u][mi][ni][e + 2 * h],
                                              e ? bias[ni].y : bias[ni].x)
                                  : ninf;
                    if (x > best) {
                      best = x;
                      slot = sl[mi] + 8 * h;
                    }
                  }
                v[2 * ni + e] = best;
                s[2 * ni + e] = slot;
              }
            reduce_columns<kArg>(v, s, g);
            const int col = c0 + (k >> 1) * 8 + (k & 1);
            const int strip = (row0 + 16 * st) / pt;
            if (k >= 4 * t.pairs[u]) continue;
            if (whole) {  // the strip is the center: out directly
              if (m0 + strip < p.M && col < p.cout) {
                const size_t o = ((size_t)b * p.M + m0 + strip) * p.cout +
                                 col;
                p.out[o] = v[0];
                if (kArg) p.arg_out[o] = (unsigned char)s[0];
              }
            } else {
              const size_t o = (size_t)strip * pc + col - n0;
              pv[o] = v[0];
              if (kArg) ps[o] = (unsigned char)s[0];
            }
          }
        }
        if (whole) continue;
        // 4. where a center spans several strips: the pass's columns of out
        //    (and the winning slots) of the tile's centers that exist, from
        //    their strips' partials in slot order
        __syncthreads();
        const int tmv = imin(p.TM, p.M - m0);
        const int per = Kp / pt;
        const int ncol = imin(nw, p.cout - n0);
        for (int e = tid; e < tmv * ncol; e += kThreads) {
          const int c = e / ncol;
          const int cl = e - c * ncol;
          const size_t o0 = (size_t)c * per * pc + cl;
          float best = pv[o0];
          int slot = kArg ? ps[o0] : 0;
          for (int s = 1; s < per; ++s) {
            const float v = pv[o0 + (size_t)s * pc];
            if (v > best) {
              best = v;
              if (kArg) slot = ps[o0 + (size_t)s * pc];
            }
          }
          const size_t o = ((size_t)b * p.M + m0 + c) * p.cout + n0 + cl;
          p.out[o] = best;
          if (kArg) p.arg_out[o] = (unsigned char)slot;
        }
      }
    }
  }
  cp_wait<0>();
}

}  // namespace

extern "C" {

// Shared memory one block needs (bytes): TM centers of round16(K) rows, at
// most 256 rows; np columns a pass and kc k-rows a weight stage; the cloud
// staged (use_xs, N points) or not.
long long sa_eval_smem_bytes(int TM, int K, int Wp, int midp, int coutp,
                             int np, int kc, int N, int use_xs) {
  return (long long)layout(TM, K, Wp, midp, coutp, np, kc, N, use_xs).total;
}

// xyz (B,N,3) f32, qidx (B,M) i32, feats (B,N,C) f32; w1 (Wp,midp) bf16,
// b1 (midp) f32, w2 (midp,coutp) bf16, b2 (coutp) f32 -- Wp, midp, coutp
// multiples of 16 and zero padded -> new_xyz (B,M,3), fi (B,M,C),
// out (B,M,cout) f32, and when not null the neighbour indices idx_out
// (B,M,K) i32 and each output's first winning slot arg_out (B,M,cout) u8
// (the fused SA under autograd keeps both for its backward). K <= 128; TM,
// np, kc, tiles and use_xs as ops/saeval.py _fwd_tiling picks them.
// Returns cudaError_t.
int sa_eval_launch(const float* xyz, const int* qidx, const float* feats,
                   const void* w1, const float* b1, const void* w2,
                   const float* b2, int B, int N, int M, int C, int K, int TM,
                   int np, int kc, int tiles, int use_xs, int Wp, int midp,
                   int coutp, int cout, float r2, float dp_scale, int relative,
                   float* new_xyz, float* fi, float* out, int* idx_out,
                   unsigned char* arg_out, cudaStream_t stream) {
  if (B <= 0 || N <= 0 || M <= 0 || K <= 0 || K > 128 || TM <= 0 ||
      TM * round16(K) > 256 || np <= 0 || np % 16 || kc <= 0 || kc % 16 ||
      tiles <= 0 || Wp % 16 || midp % 16 || coutp % 16 || Wp < C + 3 ||
      cout > coutp)
    return cudaErrorInvalidValue;
  Params p;
  p.xyz = xyz;
  p.qidx = qidx;
  p.feats = feats;
  p.w1 = static_cast<const bf16*>(w1);
  p.b1 = b1;
  p.w2 = static_cast<const bf16*>(w2);
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
  p.np = np;
  p.kc = kc;
  p.tiles = tiles;
  p.r2 = r2;
  p.dp_scale = dp_scale;
  p.relative = relative;
  p.use_xs = use_xs;
  // 16-byte feature reads where rows and the pointer allow them
  p.vec = C % 4 == 0 && (reinterpret_cast<uintptr_t>(feats) & 15) == 0;
  p.new_xyz = new_xyz;
  p.fi = fi;
  p.out = out;
  p.idx_out = idx_out;
  p.arg_out = arg_out;
  const size_t smem = layout(TM, K, Wp, midp, coutp, np, kc, N, use_xs).total;
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  void (*kernel)(Params) =
      arg_out ? sa_eval_kernel<true> : sa_eval_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int cloud_tiles = (M + TM - 1) / TM;
  dim3 grid((cloud_tiles + tiles - 1) / tiles, B);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

const char* apt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
