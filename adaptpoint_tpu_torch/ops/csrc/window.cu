// Windowed max-pooled ball group for Hopper (sm_90a), forward and backward.
//
// Replaces the TPU kernels adaptpoint_tpu/ops/pallas/window.py
// _wfwd_max_kernel (the pallas_call in _wbg_max_call) and _wbwd_max_kernel
// (the one in _wbg_max_bwd), the two halves of ball_group_maxpool_windowed.
// Same function as the plain versions in ops/window.py:
//   each tile of tm key-sorted centers scans only its window, the w sorted
//   positions from win[b, t] * 128 below N; a center's ball is the window's
//   points with d2 < f32(r)^2, the first K in ORIGINAL index order, empty
//   slots repeating the first. The center's coordinates and fi come from
//   the window as well: a center outside it reads zeros (only where
//   window_prep's ok is False).
//   values = the splits-part bf16 rounding of feats (parts summed in f32 in
//   part order); fmax, fmin the max and min over the slots, amax, amin the
//   first slot that holds them; an empty ball gives feats[b, 0] unrounded.
// Backward, per (center, channel): slot amax gets the grad_splits rounding
//   of g_fmax + [amin == amax] g_fmin, slot amin (when it differs) that of
//   g_fmin; g_fi and g_new go to the center's row unrounded when it lay in
//   its window; empty balls add nothing here (their row-0 term is added by
//   the wrapper, as the JAX package adds it outside its kernel).
//
// What bounds it: bytes, as for the full-N kernels (ballgroup_max.cu). The
// forward reads feats once (the slot reads repeat rows out of L2) and
// writes three (B, M, C) f32 and two (B, M, C) u8 tensors; the backward
// reads the three (B, M, C) cotangents and the slots and writes (B, N, C).
//
// Forward design: a block of 8 warps owns TM consecutive key-sorted centers
// of one tile (ops/window.py fwd_tiling picks TM, the design and the
// vector), so all of them scan one window.
// 0. The block stages its window once in shared memory, four points a
//    thread at once (their indices, then their coordinates: 12-byte rows
//    at the original indices order names, which no 16-byte global piece
//    covers; the scan then reads each point as one 16-byte float4).
// 1. A warp a center selects its ball, the first K in-ball points by
//    original index, without sorting the window in every block:
//    "bitmap" (the rule) stages the window as float4 (x, y, z, original
//    index) in sorted-position order, which is sorted along the key's axis
//    (the block finds an axis the window is sorted along). The warp
//    binary-searches the positions whose key lies within the radius of its
//    center's (no point outside them can be in the ball: key_range), scans
//    only those, 128 points an iteration, and sets bit o of its own N-bit
//    map (shared memory, atomicOr) for each in-ball point o; then it reads
//    the map in index order, 32 words at a time, and ranks the set bits
//    with __popc and a warp prefix sum: the first K are the slots. No
//    sort, no barrier.
//    "sorted" (the first draft's selection, kept where the N-bit maps do
//    not fit shared memory) sorts the window's original indices in the
//    block (bitonic), gathers their coordinates and scans in index order
//    up to the K-th hit. Its shared memory never exceeds the first draft's,
//    so every shape that took is still taken.
//    d2 rounds step by step (__fmul_rn / __fadd_rn, -fmad=false), so the
//    selection equals the plain version's.
// 2. The max and min (bgmax_walk.cuh, row 7's walk): threads take (center,
//    16 bytes of channels) pieces, each walking the found slots four row
//    loads at a time, the values rounded to `splits` parts (a template
//    parameter); fi, fmax, fmin 16-byte stores, the slots 4 bytes. Channels
//    that are not a multiple of 4 (or a misaligned pointer) take the
//    one-channel instance. Outputs go to the center's query position
//    (cperm), so no un-permute follows, and rows are read at their original
//    index (the rounding is per element: no sorted copy of the features).
//
// Backward design (row 8's, ballgroup_max.cu): a block owns one cloud, a
// slice of S channels and R of its rows, and sums that slice of g_feats in
// shared memory (R x (S + 1) f32) with shared-memory atomics; a group of S
// threads takes one center at a time, four centers' loads in flight a
// thread. After a barrier it writes each element of the slice once: no
// memset, no global atomics. One more slice of blocks writes g_xyz whole
// (zeros, plus g_new at the rows of centers that lay in their windows). S
// and R come from ops/ballgroup_max.py bwd_tiling. A ball with cnt == 0 adds
// nothing; a center with qrow < 0 adds no g_fi and no g_new.
//
// Arithmetic: forward outputs, slots and counts exact against the plain
// version, the same bits launch to launch; the backward's shared atomics
// land in no fixed order (the f32 reordering bound).
#include "bgmax_walk.cuh"

#include <cuda_runtime.h>
#include <climits>

namespace {

using apt_bgm::bf16r;
using apt_bgm::max_min_walk;
using apt_bgm::store;
using apt_bgm::store_slots;
using apt_bgm::Vec;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kThreadsB = 512;  // threads of a backward block
constexpr int kUnrollB = 4;     // centers a backward thread loads at once
constexpr size_t kSmemLimit = 232448;  // bytes a block may use on sm_90
constexpr int kMaxCenters = 32;        // TM: the sorted layout's center
                                       // table fits its 512 dead bytes
enum Design { kBitmap = 0, kSorted = 1 };

// the first S parts of the exact three-way bf16 split of x, summed in f32
// in part order
template <int S>
__device__ __forceinline__ float split_round(float x) {
  const float p0 = bf16r(x);
  if constexpr (S == 1) {
    return p0;
  } else {
    const float r1 = __fsub_rn(x, p0);
    const float p1 = bf16r(r1);
    if constexpr (S == 2) return __fadd_rn(p0, p1);
    return __fadd_rn(__fadd_rn(p0, p1), bf16r(__fsub_rn(r1, p1)));
  }
}

__host__ __device__ inline int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

__host__ __device__ inline size_t a128(size_t x) {
  return (x + 127) / 128 * 128;
}

__host__ __device__ inline int map_words(int N) { return (N + 31) / 32; }

// ------------------------------------------------------------- forward

struct FwdLayout {
  size_t win, bits, nb, cen, total;
};

// Shared memory of a forward block. bitmap: the window as float4, each
// warp's N-bit map, the slot table (TM x K), a table of (query position,
// row, found) a center and the window's sorted axes. sorted: the first draft's layout, unpadded:
// next_pow2(w) original indices, w x, y, z each, then the slot table; the
// center table overwrites the window's first bytes after the selection.
__host__ __device__ inline FwdLayout fwd_layout(int design, int TM, int N,
                                                int K, int w) {
  FwdLayout L;
  L.win = 0;
  if (design == kBitmap) {
    L.bits = a128((size_t)w * 16);
    L.nb = L.bits + a128((size_t)kWarps * map_words(N) * 4);
    L.cen = L.nb + a128((size_t)TM * K * 4);
    L.total = L.cen + a128((size_t)TM * 12 + 4);
  } else {
    L.bits = L.cen = 0;
    L.nb = (size_t)next_pow2(w) * 4 + (size_t)w * 12;
    L.total = L.nb + (size_t)TM * K * 4;
  }
  return L;
}

struct FwdParams {
  const float* xyz;
  const float* feats;
  const int* order;
  const int* win;
  const int* qpos;
  const int* cperm;
  int N, M, C, K, tm, w, TM;
  float r2;
  float* new_xyz;
  float* fi;
  float* fmax;
  float* fmin;
  unsigned char* amax;
  unsigned char* amin;
  int* cnt;
  int* idx;
  int* qrow;
};

__device__ __forceinline__ float dist2(float3 q, float x, float y, float z) {
  const float dx = __fsub_rn(q.x, x);
  const float dy = __fsub_rn(q.y, y);
  const float dz = __fsub_rn(q.z, z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__device__ __forceinline__ float coord(float4 v, int axis) {
  return axis == 0 ? v.x : axis == 1 ? v.y : v.z;
}

// The positions [lo, hi) of the staged window sw[0, nvalid), sorted along
// `axis`, whose coordinate qk - x rounds to a square below r2: outside it
// d2 >= fl(fl(qk - x)^2) >= r2 (every rounding is monotone and the other
// terms are >= 0), so no point there is in the ball. Two binary searches.
__device__ __forceinline__ int2 key_range(const float4* sw, int nvalid,
                                          int axis, float qk, float r2) {
  int a = 0, b = nvalid;
  while (a < b) {  // the first position with x >= qk or (qk - x)^2 < r2
    const int mid = (a + b) >> 1;
    const float x = coord(sw[mid], axis);
    const float d = __fsub_rn(qk, x);
    if (x >= qk || __fmul_rn(d, d) < r2)
      b = mid;
    else
      a = mid + 1;
  }
  const int lo = a;
  b = nvalid;
  while (a < b) {  // the first position with x > qk and (qk - x)^2 >= r2
    const int mid = (a + b) >> 1;
    const float x = coord(sw[mid], axis);
    const float d = __fsub_rn(qk, x);
    if (x > qk && __fmul_rn(d, d) >= r2)
      b = mid;
    else
      a = mid + 1;
  }
  return make_int2(lo, a);
}

// bitmap: the ball of qc over the staged window positions [lo, hi) by one
// warp, through the warp's map `bits` (words words); the first K by
// original index into nbc. Returns the in-ball count.
__device__ __forceinline__ int select_bitmap(const float4* sw, int lo, int hi,
                                             float3 qc, float r2, int K,
                                             unsigned* bits, int words,
                                             int* nbc, int lane) {
  const unsigned all = 0xffffffffu;
  for (int i = lane; i < words; i += 32) bits[i] = 0u;
  __syncwarp();
  int cnt = 0;
  for (int base = lo; base < hi; base += 128) {
    float4 x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      x[u] = sw[min(base + 32 * u + lane, hi - 1)];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const bool in = base + 32 * u + lane < hi &&
                      dist2(qc, x[u].x, x[u].y, x[u].z) < r2;
      if (in) {
        const unsigned o = (unsigned)__float_as_int(x[u].w);
        atomicOr(bits + (o >> 5), 1u << (o & 31u));
      }
      cnt += __popc(__ballot_sync(all, in));
    }
  }
  __syncwarp();
  // the set bits in index order: 32 words a round, ranked by a prefix sum
  int taken = 0;
  for (int w0 = 0; w0 < words && taken < K; w0 += 32) {
    const int wi = w0 + lane;
    unsigned word = wi < words ? bits[wi] : 0u;
    const int c = __popc(word);
    int incl = c;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(all, incl, d);
      if (lane >= d) incl += t;
    }
    for (int rank = taken + incl - c; word && rank < K; ++rank) {
      nbc[rank] = wi * 32 + __ffs(word) - 1;
      word &= word - 1u;
    }
    taken += __shfl_sync(all, incl, 31);
  }
  return cnt;
}

// sorted: the ball of qc over the window sorted by original index (sidx,
// coordinates sx, sy, sz) by one warp, in index order up to its K-th hit.
// Returns the in-ball count, or at least K where it stopped there.
__device__ __forceinline__ int select_sorted(const int* sidx, const float* sx,
                                             const float* sy, const float* sz,
                                             int nvalid, float3 qc, float r2,
                                             int K, int* nbc, int lane) {
  int cnt = 0;
  for (int base = 0; base < nvalid && cnt < K; base += 32) {
    const int j = base + lane;
    const bool in = j < nvalid && dist2(qc, sx[j], sy[j], sz[j]) < r2;
    const unsigned mask = __ballot_sync(0xffffffffu, in);
    const int rank = cnt + __popc(mask & ((1u << lane) - 1u));
    if (in && rank < K) nbc[rank] = sidx[j];
    cnt += __popc(mask);
  }
  return cnt;
}

template <int V, int SPLITS, int DESIGN>
__global__ void __launch_bounds__(kThreads)
window_max_kernel(FwdParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const FwdLayout L = fwd_layout(DESIGN, p.TM, p.N, p.K, p.w);
  int* nb = reinterpret_cast<int*>(smem + L.nb);
  int* cen = reinterpret_cast<int*>(smem + L.cen);  // (m, row, found)
  int& sorted_axes = cen[3 * p.TM];  // bitmap: bit a, sorted along axis a
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int K = p.K, C = p.C;
  const int s0 = blockIdx.x * p.TM;  // the block's first key-sorted center
  const int ws = p.win[b * (p.M / p.tm) + s0 / p.tm] * 128;
  const int nvalid = min(p.w, p.N - ws);
  const int* ord = p.order + (size_t)b * p.N;
  const float* X = p.xyz + (size_t)b * p.N * 3;
  const float* F = p.feats + (size_t)b * p.N * C;

  // 0. the window
  float4* sw = reinterpret_cast<float4*>(smem + L.win);
  int* sidx = reinterpret_cast<int*>(smem + L.win);
  float* sx = reinterpret_cast<float*>(sidx + next_pow2(p.w));
  float* sy = sx + p.w;
  float* sz = sy + p.w;
  int axis = -1;  // an axis the staged window is sorted along (bitmap)
  if constexpr (DESIGN == kBitmap) {
    if (tid == 0) sorted_axes = 7;
    // kStage points a thread at once: their indices, then their
    // coordinates, so each thread waits out two round trips a batch
    constexpr int kStage = 4;
    for (int i0 = tid; i0 < nvalid; i0 += kStage * kThreads) {
      int o[kStage];
#pragma unroll
      for (int u = 0; u < kStage; ++u)
        o[u] = ord[ws + min(i0 + u * kThreads, nvalid - 1)];
      float4 v[kStage];
#pragma unroll
      for (int u = 0; u < kStage; ++u)
        v[u] = make_float4(X[3 * o[u]], X[3 * o[u] + 1], X[3 * o[u] + 2],
                           __int_as_float(o[u]));
#pragma unroll
      for (int u = 0; u < kStage; ++u)
        if (i0 + u * kThreads < nvalid) sw[i0 + u * kThreads] = v[u];
    }
    __syncthreads();
    // the sort key's axis is one (window_prep does not pass it on); any
    // axis the window is sorted along bounds the scan as well, and NaNs
    // leave none (the whole window is scanned)
    int down = 0;  // bit a: a pair out of order along a
    for (int i = tid; i + 1 < nvalid; i += kThreads) {
      const float4 u = sw[i], v = sw[i + 1];
      down |= (u.x <= v.x ? 0 : 1) | (u.y <= v.y ? 0 : 2) |
              (u.z <= v.z ? 0 : 4);
    }
    down = __reduce_or_sync(0xffffffffu, down);
    if (lane == 0 && down) atomicAnd(&sorted_axes, ~down);
    __syncthreads();
    axis = sorted_axes ? __ffs(sorted_axes) - 1 : -1;
  } else {
    const int w2 = next_pow2(p.w);
    for (int i = tid; i < w2; i += kThreads)
      sidx[i] = i < nvalid ? ord[ws + i] : INT_MAX;
    __syncthreads();
    for (int k = 2; k <= w2; k <<= 1) {  // bitonic, ascending
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int i = tid; i < w2; i += kThreads) {
          const int ixj = i ^ j;
          if (ixj > i) {
            const int a = sidx[i], c = sidx[ixj];
            if ((a > c) == ((i & k) == 0)) {
              sidx[i] = c;
              sidx[ixj] = a;
            }
          }
        }
        __syncthreads();
      }
    }
    for (int i = tid; i < nvalid; i += kThreads) {
      const int o = sidx[i];
      sx[i] = X[3 * o];
      sy[i] = X[3 * o + 1];
      sz[i] = X[3 * o + 2];
    }
    __syncthreads();
  }

  // 1. each center's ball, a warp a center
  unsigned* bits = reinterpret_cast<unsigned*>(smem + L.bits) +
                   (size_t)warp * map_words(p.N);
  for (int c = warp; c < p.TM; c += kWarps) {
    const size_t s = (size_t)b * p.M + s0 + c;
    const int qp = p.qpos[s];
    const int m = p.cperm[s];
    const bool inwin = qp >= ws && qp < ws + p.w;  // then qp - ws < nvalid
    int* nbc = nb + c * K;
    int qo, cnt;
    float3 qc = make_float3(0.0f, 0.0f, 0.0f);
    if constexpr (DESIGN == kBitmap) {
      const float4 e = inwin ? sw[qp - ws] : make_float4(0.0f, 0.0f, 0.0f,
                                                         0.0f);
      qo = inwin ? __float_as_int(e.w) : -1;
      qc = make_float3(e.x, e.y, e.z);
      const int2 range = axis < 0 ? make_int2(0, nvalid)
                                  : key_range(sw, nvalid, axis,
                                              coord(e, axis), p.r2);
      cnt = select_bitmap(sw, range.x, range.y, qc, p.r2, K, bits,
                          map_words(p.N), nbc, lane);
    } else {
      qo = inwin ? ord[qp] : -1;
      if (inwin) qc = make_float3(X[3 * qo], X[3 * qo + 1], X[3 * qo + 2]);
      cnt = select_sorted(sidx, sx, sy, sz, nvalid, qc, p.r2, K, nbc, lane);
    }
    __syncwarp();
    const int found = cnt < K ? cnt : K;
    const int first = found > 0 ? nbc[0] : 0;
    for (int k = found + lane; k < K; k += 32) nbc[k] = first;
    __syncwarp();
    const size_t bm = (size_t)b * p.M + m;
    for (int k = lane; k < K; k += 32) p.idx[bm * K + k] = nbc[k];
    if (lane < 3)
      p.new_xyz[bm * 3 + lane] = lane == 0 ? qc.x : lane == 1 ? qc.y : qc.z;
    if (lane == 0) {
      p.cnt[bm] = found;
      p.qrow[bm] = qo;
      if constexpr (DESIGN == kBitmap) {
        cen[3 * c] = m;
        cen[3 * c + 1] = qo;
        cen[3 * c + 2] = found;
      }
    }
  }
  __syncthreads();
  if constexpr (DESIGN == kSorted) {
    // the center table lies over the dead window here: read back this
    // block's own writes above (visible after the barrier)
    if (tid < p.TM) {
      const int m = p.cperm[(size_t)b * p.M + s0 + tid];
      const size_t bm = (size_t)b * p.M + m;
      cen[3 * tid] = m;
      cen[3 * tid + 1] = p.qrow[bm];
      cen[3 * tid + 2] = p.cnt[bm];
    }
    __syncthreads();
  }

  // 2. the max and min over the found slots, (center, V channels) a piece
  const int P = C / V;
  for (int e = tid; e < p.TM * P; e += kThreads) {
    const int c = e / P;
    const int col = (e - c * P) * V;
    const int qo = cen[3 * c + 1];
    const int found = cen[3 * c + 2];
    float vmax[V], vmin[V], vq[V];
    int kmax[V], kmin[V];
    if (found > 0) {
      max_min_walk<float, V>(
          F, C, col, nb + c * K, found,
          [](const Vec<float, V>& v, int i) {
            return split_round<SPLITS>(v.raw(i));
          },
          vmax, vmin, kmax, kmin);
    } else {  // an empty ball: the original row 0, unrounded
      Vec<float, V> z;
      z.load(F + col);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        vmax[i] = vmin[i] = z.raw(i);
        kmax[i] = kmin[i] = 0;
      }
    }
    if (qo >= 0) {
      Vec<float, V> q;
      q.load(F + (size_t)qo * C + col);
#pragma unroll
      for (int i = 0; i < V; ++i) vq[i] = split_round<SPLITS>(q.raw(i));
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) vq[i] = 0.0f;
    }
    const size_t o = ((size_t)b * p.M + cen[3 * c]) * C + col;
    store<V>(p.fi + o, vq);
    store<V>(p.fmax + o, vmax);
    store<V>(p.fmin + o, vmin);
    store_slots<V>(p.amax + o, kmax);
    store_slots<V>(p.amin + o, kmin);
  }
}

// ------------------------------------------------------------ backward

// Shared memory of a backward block: R rows of an S-channel slice, a row
// padded to S + 1 floats (ballgroup_max.cu bwd_smem).
__host__ __device__ inline size_t bwd_smem(int S, int R) {
  return a128((size_t)R * (S + 1) * 4);
}

struct BwdParams {
  const int* idx;
  const int* cnt;
  const int* qrow;
  const float* g_new;
  const float* g_fi;
  const float* g_fmax;
  const float* g_fmin;
  const unsigned char* amax;
  const unsigned char* amin;
  int N, M, C, K, S, R, feat_slices;
  float* g_xyz;
  float* g_feats;
};

// A block owns cloud blockIdx.x, rows blockIdx.z * R .. of it and channel
// slice blockIdx.y (S channels; the slice after the last is g_xyz).
template <int GS>
__global__ void __launch_bounds__(kThreadsB)
window_max_bwd_kernel(BwdParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);
  const int b = blockIdx.x;
  const int slice = blockIdx.y;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.z * p.R;
  const int rows = min(p.R, p.N - n0);
  const int* Q = p.qrow + (size_t)b * p.M;
  const int* CNT = p.cnt + (size_t)b * p.M;

  if (slice == p.feat_slices) {  // g_xyz: zeros, plus g_new at the centers
    for (int e = tid; e < rows * 3; e += kThreadsB) acc[e] = 0.0f;
    __syncthreads();
    if (p.g_new)
      for (int e = tid; e < p.M * 3; e += kThreadsB) {
        const int m = e / 3;
        const int r = Q[m] - n0;  // Q < 0: the center added nothing
        if (Q[m] >= 0 && r >= 0 && r < rows)
          atomicAdd(acc + 3 * r + e - 3 * m,
                    p.g_new[(size_t)b * p.M * 3 + e]);
      }
    __syncthreads();
    float* G = p.g_xyz + ((size_t)b * p.N + n0) * 3;
    for (int e = tid; e < rows * 3; e += kThreadsB) G[e] = acc[e];
    return;
  }

  const int S = p.S;  // a power of two
  const int sh = __ffs(S) - 1;
  const int ld = S + 1;  // the row stride of acc
  const int c = tid & (S - 1);
  const int groups = kThreadsB >> sh;
  const int col = slice * S + c;  // the thread's channel
  const bool live = col < p.C;
  for (int e = tid; e < rows * ld; e += kThreadsB) acc[e] = 0.0f;
  __syncthreads();

  auto add = [&](int row, float v) {
    const int r = row - n0;
    if (v != 0.0f && r >= 0 && r < rows) atomicAdd(acc + r * ld + c, v);
  };
  const size_t bm0 = (size_t)b * p.M;
  for (int m0 = tid >> sh; m0 < p.M; m0 += kUnrollB * groups) {
    // the loads of kUnrollB centers, then their neighbour rows, then the adds
    float ga[kUnrollB], gn[kUnrollB], gf[kUnrollB];
    int ka[kUnrollB], ki[kUnrollB], q[kUnrollB];
    bool empty[kUnrollB];
#pragma unroll
    for (int u = 0; u < kUnrollB; ++u) {
      const int m = m0 + u * groups;
      ka[u] = -1;
      q[u] = -1;
      empty[u] = true;
      if (!live || m >= p.M) continue;
      const size_t o = (bm0 + m) * p.C + col;
      q[u] = Q[m];
      empty[u] = CNT[m] == 0;
      ga[u] = p.g_fmax ? p.g_fmax[o] : 0.0f;
      gn[u] = p.g_fmin ? p.g_fmin[o] : 0.0f;
      gf[u] = p.g_fi ? p.g_fi[o] : 0.0f;
      ka[u] = p.amax[o];
      ki[u] = p.amin[o];
    }
    // an empty ball adds nothing here (zeroed after the loads, which need
    // not wait for the counts)
#pragma unroll
    for (int u = 0; u < kUnrollB; ++u)
      if (empty[u]) ga[u] = gn[u] = 0.0f;
    int ra[kUnrollB] = {}, ri[kUnrollB] = {};
#pragma unroll
    for (int u = 0; u < kUnrollB; ++u) {
      // no row to look up where both slot cotangents are zero
      if (ka[u] < 0 || (ga[u] == 0.0f && gn[u] == 0.0f)) continue;
      const int* nbr = p.idx + (bm0 + m0 + u * groups) * p.K;
      ra[u] = nbr[ka[u]];
      ri[u] = nbr[ki[u]];
    }
#pragma unroll
    for (int u = 0; u < kUnrollB; ++u) {
      if (ka[u] < 0) continue;
      if (ka[u] == ki[u]) {
        add(ra[u], split_round<GS>(__fadd_rn(ga[u], gn[u])));
      } else {
        add(ra[u], split_round<GS>(ga[u]));
        add(ri[u], split_round<GS>(gn[u]));
      }
      if (q[u] >= 0) add(q[u], gf[u]);
    }
  }
  __syncthreads();

  // each element of the slice once, a row's channels on neighbouring threads
  float* G = p.g_feats + ((size_t)b * p.N + n0) * p.C + slice * S;
  if (live)
    for (int r = tid >> sh; r < rows; r += groups)
      G[(size_t)r * p.C + c] = acc[r * ld + c];
}

// ------------------------------------------------------------- launches

template <int V, int SPLITS, int DESIGN>
int launch_fwd(const FwdParams& p, int B, cudaStream_t stream) {
  const size_t smem = fwd_layout(DESIGN, p.TM, p.N, p.K, p.w).total;
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  auto kernel = window_max_kernel<V, SPLITS, DESIGN>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(p.M / p.TM, B), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int V, int SPLITS>
int fwd_design(const FwdParams& p, int B, int design, cudaStream_t stream) {
  return design == kBitmap ? launch_fwd<V, SPLITS, kBitmap>(p, B, stream)
                           : launch_fwd<V, SPLITS, kSorted>(p, B, stream);
}

template <int V>
int fwd_splits(const FwdParams& p, int B, int splits, int design,
               cudaStream_t stream) {
  return splits == 1   ? fwd_design<V, 1>(p, B, design, stream)
         : splits == 2 ? fwd_design<V, 2>(p, B, design, stream)
                       : fwd_design<V, 3>(p, B, design, stream);
}

template <int GS>
int launch_bwd(const BwdParams& p, int B, int xyz_slice,
               cudaStream_t stream) {
  const size_t smem = bwd_smem(p.S, p.R);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      window_max_bwd_kernel<GS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid(B, p.feat_slices + xyz_slice, (p.N + p.R - 1) / p.R);
  window_max_bwd_kernel<GS><<<grid, kThreadsB, smem, stream>>>(p);
  return cudaGetLastError();
}

bool misaligned(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) != 0;
}

}  // namespace

extern "C" {

// Shared memory of one forward block (bytes): design 0 bitmap, 1 sorted;
// TM centers; N points; K slots; window width w.
long long window_max_smem_bytes(int design, int TM, int N, int K, int w) {
  return (long long)fwd_layout(design, TM, N, K, w).total;
}

// Shared memory of one backward block (bytes): R rows of S channels.
long long window_max_bwd_smem_bytes(int S, int R) {
  return (long long)bwd_smem(S, R);
}

// xyz (B,N,3) f32, feats (B,N,C) f32, order (B,N) i32, win (B,M/tm) i32,
// qpos, cperm (B,M) i32 (window_prep's), all contiguous -> in query order
// new_xyz (B,M,3), fi, fmax, fmin (B,M,C) f32, amax, amin (B,M,C) u8,
// cnt (B,M) i32 (in-ball count capped at K), idx (B,M,K) i32 original
// indices, qrow (B,M) i32 (the center's row, -1 outside its window).
// r2 = f32(r)*f32(r); K <= 255; M a multiple of tm; w a multiple of 128 no
// larger than N rounded up to 128; design (0 bitmap, 1 sorted), TM centers
// a block (dividing tm, at most 32) and vec (1, or 4 channels) as
// ops/window.py fwd_tiling picks them. Returns cudaError_t.
int window_max_launch(const float* xyz, const float* feats, const int* order,
                      const int* win, const int* qpos, const int* cperm, int B,
                      int N, int M, int C, int K, int tm, int w, int splits,
                      float r2, int design, int TM, int vec, float* new_xyz,
                      float* fi, float* fmax, float* fmin,
                      unsigned char* amax, unsigned char* amin, int* cnt,
                      int* idx, int* qrow, cudaStream_t stream) {
  if (B <= 0 || N <= 0 || M <= 0 || C <= 0 || K <= 0 || K > 255 || tm <= 0 ||
      M % tm || w < 128 || w % 128 || w > (N + 127) / 128 * 128 ||
      splits < 1 || splits > 3 || (design != kBitmap && design != kSorted) ||
      TM <= 0 || TM > kMaxCenters || tm % TM ||
      (vec != 1 && (vec != 4 || C % 4 || misaligned(feats))))
    return cudaErrorInvalidValue;
  const FwdParams p{xyz, feats, order, win, qpos, cperm, N, M, C, K, tm, w,
                    TM, r2, new_xyz, fi, fmax, fmin, amax, amin, cnt, idx,
                    qrow};
  return vec == 1 ? fwd_splits<1>(p, B, splits, design, stream)
                  : fwd_splits<4>(p, B, splits, design, stream);
}

// The forward's idx, cnt, qrow, amax, amin; cotangents g_new (B,M,3), g_fi,
// g_fmax, g_fmin (B,M,C) f32 contiguous or null (zero) -> g_xyz (B,N,3),
// g_feats (B,N,C) f32, either null to skip it, each written whole (no
// memset needed). S channels (a power of two, 4 .. 256) and R rows a block
// as ops/ballgroup_max.py bwd_tiling picks them. Returns cudaError_t.
int window_max_bwd_launch(const int* idx, const int* cnt, const int* qrow,
                          const float* g_new, const float* g_fi,
                          const float* g_fmax, const float* g_fmin,
                          const unsigned char* amax, const unsigned char* amin,
                          int B, int N, int M, int C, int K, int grad_splits,
                          int S, int R, float* g_xyz, float* g_feats,
                          cudaStream_t stream) {
  if (B <= 0 || N <= 0 || M <= 0 || C <= 0 || K <= 0 || K > 255 ||
      grad_splits < 1 || grad_splits > 3 || S < 4 || S > kThreadsB ||
      (S & (S - 1)) || R <= 0)
    return cudaErrorInvalidValue;
  const BwdParams p{idx, cnt, qrow, g_new, g_fi, g_fmax, g_fmin, amax, amin,
                    N, M, C, K, S, R, g_feats ? (C + S - 1) / S : 0, g_xyz,
                    g_feats};
  const int xyz_slice = g_xyz ? 1 : 0;
  if (p.feat_slices + xyz_slice == 0) return cudaSuccess;
  return grad_splits == 1   ? launch_bwd<1>(p, B, xyz_slice, stream)
         : grad_splits == 2 ? launch_bwd<2>(p, B, xyz_slice, stream)
                            : launch_bwd<3>(p, B, xyz_slice, stream);
}

const char* apt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
