// Scatter-adds of rows for Hopper (sm_90a): the block templates behind the
// 3-NN weighted gather's d_feat backward (fpinterp.cu, kernel row 13) and
// the row gather's backward (gather.cu, row 15).
//
// The function: out[b, r, c] = the f32 sum, from 0 in ascending slot order,
// of addend(src[b, s][c]) over the slots s of cloud b that name row r (and
// that the op keeps), written once: bf16 rounded once where the output is
// bf16, zeros for a row no slot names. An op (fpinterp.cu FpOp, gather.cu
// RowsOp) stages a round of slots in shared memory (the tile row each
// names, or -1, and for FpOp a word of weights beside it), and says where a
// slot's source row starts and what it adds.
//
// "ordered" (the rule): a block owns one cloud's tile of `rows` destination
// rows and a slice of lanes * vec channels. In rounds of `chunk` slots (one
// round where the cloud's slots fit shared memory) it
// 0. stages the round's slots in shared memory, eight loads in flight a
//    thread;
// 1. compacts the slots that name a tile row, in order (a ballot a 32
//    slots);
// 2. counts them per row, warp by warp over contiguous ranges (same_row
//    merges the lanes that name one row, so the counts are plain stores);
// 3. scans the counts to each row's list start and each warp's offset in it;
// 4. places each slot at its warp's offset plus its rank among the lanes
//    naming its row: every list holds its slots in ascending order, with no
//    sort and no atomics, as the slot's source row and, for FpOp, its word;
// 5. gives each group of lanes (a power of two, at most 32) consecutive
//    rows, whose lists lie end to end: the group streams them kUnroll
//    entries at a time, every 16-byte source load of a batch issued before
//    the adds, sums each row in f32 registers and stores it where its list
//    ends (between rounds the sums wait in shared memory).
// "staged" (FpOp where it fits): one round and a tile of the whole cloud;
// the block also stages a 128-channel slice of the cloud's source rows in
// shared memory as bf16 (FpOp rounds its sources to bf16 anyway), so each
// source element is read once, not once for each of the up to three rows
// that name it, and step 5 reads shared memory.
// Both are one launch with no memset and no scratch, and give the same bits
// from run to run: the ordered plain function of ops/scatter_rows.py.
// "l2red", kept for small scatters (ops/scatter_rows.py choose), is the
// first drafts' layout with 16-byte L2 reductions: a thread a slot and 4
// channels, atomicAdd on float4 into an f32 buffer zeroed first, then a
// rounding pass for a bf16 output; its sums land in no fixed order.
//
// What bounds them: bytes (each source row read once, each output row
// written once). Each block re-stages its cloud's slots; `choose` takes the
// tallest tile that still gives the card about two blocks an SM.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace apt_scatter {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kSmemLimit = 232448;  // bytes a block may use on sm_90

enum Design { kOrdered = 0, kL2Red = 1, kStaged = 2 };

// The launch shape, chosen on the host (ops/scatter_rows.py choose).
struct Tiling {
  int design;
  int vec;     // channels a lane moves at once: 1, 4 or 8 (bf16 only)
  int lshift;  // log2 of the lanes a row group ("ordered", "staged")
  int rows;    // destination rows a block ("ordered", "staged")
  int chunk;   // slots a round, the lists' capacity ("ordered", "staged")
};

__host__ __device__ inline size_t a16(size_t x) { return (x + 15) / 16 * 16; }

// Shared memory of one block; ops/scatter_rows.py smem_bytes is its host
// copy: each warp's counts per row (16 bits), the rows' list starts, the
// scan's 32 segment totals and 8 warp totals; for each slot of a round its
// tile row, its place among the compacted slots and its list entry (16
// bits each) and, where the op has a word, the word by slot and by list
// entry; "ordered", when the slots take more than one round, the rows'
// partial sums; "staged", the cloud's src_rows source rows of the block's
// channel slice in bf16. "l2red" uses none.
__host__ __device__ inline size_t smem_bytes(const Tiling& t, int S, bool aux,
                                             int src_rows) {
  if (t.design != kOrdered && t.design != kStaged) return 0;
  const size_t cs = (size_t)(1 << t.lshift) * t.vec;
  const size_t lists = a16((size_t)kWarps * t.rows * 2) +
                       a16((size_t)(t.rows + 41) * 4) +
                       3 * a16((size_t)t.chunk * 2) +
                       (aux ? 2 * a16((size_t)t.chunk * 4) : 0);
  if (t.design == kStaged) return lists + a16((size_t)src_rows * cs * 2);
  return lists + (S > t.chunk ? (size_t)t.rows * cs * 4 : 0);
}

// The tile row of destination row r, or -1 outside [r0, r0 + rows).
__device__ __forceinline__ short tile_row(int r, int r0, int rows) {
  return (unsigned)(r - r0) < (unsigned)rows ? (short)(r - r0) : (short)-1;
}

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// ---- vector loads and stores: V channels of T as one access
template <typename T, int V> struct Vec;
template <> struct Vec<float, 1> { typedef float type; };
template <> struct Vec<float, 4> { typedef float4 type; };
template <> struct Vec<__nv_bfloat16, 1> { typedef unsigned short type; };
template <> struct Vec<__nv_bfloat16, 4> { typedef uint2 type; };
template <> struct Vec<__nv_bfloat16, 8> { typedef uint4 type; };

__device__ __forceinline__ float lo16(unsigned u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float hi16(unsigned u) {
  return __uint_as_float(u & 0xffff0000u);
}
__device__ __forceinline__ void unpack(float v, float (&x)[1]) { x[0] = v; }
__device__ __forceinline__ void unpack(float4 v, float (&x)[4]) {
  x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
}
__device__ __forceinline__ void unpack(unsigned short v, float (&x)[1]) {
  x[0] = lo16(v);
}
__device__ __forceinline__ void unpack(uint2 v, float (&x)[4]) {
  x[0] = lo16(v.x), x[1] = hi16(v.x), x[2] = lo16(v.y), x[3] = hi16(v.y);
}
__device__ __forceinline__ void unpack(uint4 v, float (&x)[8]) {
  x[0] = lo16(v.x), x[1] = hi16(v.x), x[2] = lo16(v.y), x[3] = hi16(v.y);
  x[4] = lo16(v.z), x[5] = hi16(v.z), x[6] = lo16(v.w), x[7] = hi16(v.w);
}

__device__ __forceinline__ unsigned pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}
__device__ __forceinline__ void store(float* p, const float (&a)[1]) {
  *p = a[0];
}
__device__ __forceinline__ void store(float* p, const float (&a)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
}
__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&a)[1]) {
  *p = __float2bfloat16_rn(a[0]);
}
__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&a)[4]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack2(a[0], a[1]),
                                            pack2(a[2], a[3]));
}
__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&a)[8]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack2(a[0], a[1]), pack2(a[2], a[3]), pack2(a[4], a[5]),
                 pack2(a[6], a[7]));
}

// The tile rows of n destination rows src into dst (shared), eight loads
// in flight a thread.
__device__ __forceinline__ void stage_rows(const int* __restrict__ src, int n,
                                           int r0, int rows, short* dst) {
  for (int i0 = threadIdx.x; i0 < n; i0 += 8 * kThreads) {
    int v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (i0 + u * kThreads < n) v[u] = __ldg(src + i0 + u * kThreads);
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (i0 + u * kThreads < n) dst[i0 + u * kThreads] = tile_row(v[u], r0,
                                                                    rows);
  }
}

// cnt[w][d] (warp w's slots naming tile row d) -> warp w's first position
// in row d's list; start[d] -> row d's list start, start[rows] the total.
// The warps scan 32-row segments, warp 0 the segments' totals (tot, at
// most 32 of them).
__device__ inline void scan_counts(unsigned short* cnt, int* start, int* tot,
                                   int rows) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int d = threadIdx.x; d < rows; d += kThreads) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int x = cnt[w * rows + d];
      cnt[w * rows + d] = s;
      s += x;
    }
    start[d] = s;
  }
  __syncthreads();
  const int segs = (rows + 31) / 32;
  for (int sg = warp; sg < segs; sg += kWarps) {
    const int d = sg * 32 + lane;
    const int x = d < rows ? start[d] : 0;
    int incl = x;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    if (d < rows) start[d] = incl - x;
    if (lane == 31) tot[sg] = incl;
  }
  __syncthreads();
  if (warp == 0) {
    const int x = lane < segs ? tot[lane] : 0;
    int incl = x;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane < segs) tot[lane] = incl - x;
    if (lane == 31) start[rows] = incl;
  }
  __syncthreads();
  for (int d = threadIdx.x; d < rows; d += kThreads) {
    const int base = start[d] + tot[d >> 5];
    start[d] = base;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) cnt[w * rows + d] += base;
  }
  __syncthreads();
}

// The lanes of the warp whose d (a tile row below 2^bits) equals this
// lane's, or 0 where d < 0: __match_any_sync's answer from one ballot a bit
// of d, cheaper than MATCH.ANY where the 32 values mostly differ (PERF.md,
// PR 14). Every lane must call it.
__device__ __forceinline__ unsigned same_row(int d, int bits) {
  unsigned eq = __ballot_sync(0xffffffffu, d >= 0);
  for (int k = 0; k < bits; ++k) {
    const bool bit = (d >> k) & 1;
    const unsigned m = __ballot_sync(0xffffffffu, bit);
    eq &= bit ? m : ~m;
  }
  return d >= 0 ? eq : 0u;
}

// A round's lists in shared memory (the layout of smem_bytes).
struct Lists {
  unsigned short* cnt;   // [kWarps][rows]
  int* start;            // [rows + 1], the scan's 32 totals, 8 warp totals
  short* dest;           // [chunk] each slot's tile row, or -1
  unsigned short* comp;  // [chunk] the slots naming a tile row, ascending
  unsigned short* list;  // [chunk] the rows' source rows, end to end
  unsigned* aux;         // [chunk] the op's word of each slot
  unsigned* word;        // [chunk] the same words in list order
  unsigned char* next;   // the first byte after them
  __device__ Lists(unsigned char* smem, int rows, int chunk, bool has_aux) {
    size_t off = 0;
    cnt = reinterpret_cast<unsigned short*>(smem);
    off += a16((size_t)kWarps * rows * 2);
    start = reinterpret_cast<int*>(smem + off);
    off += a16((size_t)(rows + 41) * 4);
    dest = reinterpret_cast<short*>(smem + off);
    off += a16((size_t)chunk * 2);
    comp = reinterpret_cast<unsigned short*>(smem + off);
    off += a16((size_t)chunk * 2);
    list = reinterpret_cast<unsigned short*>(smem + off);
    off += a16((size_t)chunk * 2);
    aux = reinterpret_cast<unsigned*>(smem + off);
    if (has_aux) off += a16((size_t)chunk * 4);
    word = reinterpret_cast<unsigned*>(smem + off);
    if (has_aux) off += a16((size_t)chunk * 4);
    next = smem + off;
  }
};

// Steps 0-4 for the n slots of a round from slot k0. On return (after a
// barrier) row d's slots, ascending, are list[start[d] .. start[d + 1])
// (each slot's source row relative to the round's first, Op::src_rel),
// with their words beside them in word.
template <class Op>
__device__ __forceinline__ void build_lists(const Op& op, const Lists& L,
                                            int b, int k0, int n, int r0,
                                            int rows) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1;
  const int bits = 32 - __clz(rows - 1);  // of a tile row
  int* wtot = L.start + rows + 33;
  int per = ((n + kWarps - 1) / kWarps + 31) & ~31;
  int w0 = warp * per, w1 = min(n, w0 + per);  // this warp's slots
  unsigned short* cnt = L.cnt + warp * rows;
  for (int i = threadIdx.x; i < kWarps * rows; i += kThreads) L.cnt[i] = 0;
  op.stage(b, k0, n, r0, rows, L.dest, L.aux);  // 0.
  __syncthreads();
  // 1. compact
  int mine = 0;
  for (int s0 = w0; s0 < w1; s0 += 32) {
    const bool in = s0 + lane < w1 && L.dest[s0 + lane] >= 0;
    mine += __popc(__ballot_sync(0xffffffffu, in));
  }
  if (lane == 0) wtot[warp] = mine;
  __syncthreads();
  int at = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int x = wtot[w];
    at += w < warp ? x : 0;
    total += x;
  }
  for (int s0 = w0; s0 < w1; s0 += 32) {
    const bool in = s0 + lane < w1 && L.dest[s0 + lane] >= 0;
    const unsigned m = __ballot_sync(0xffffffffu, in);
    if (in) L.comp[at + __popc(m & below)] = s0 + lane;
    at += __popc(m);
  }
  __syncthreads();
  // 2. count the compacted slots a row, warp by warp over contiguous
  // ranges (warp-uniform loops: every lane reaches the ballots)
  per = ((total + kWarps - 1) / kWarps + 31) & ~31;
  w0 = warp * per, w1 = min(total, w0 + per);
  for (int k = w0; k < w1; k += 32) {
    const int d = k + lane < w1 ? L.dest[L.comp[k + lane]] : -1;
    const unsigned same = same_row(d, bits);
    if (d >= 0 && (same & below) == 0) cnt[d] += __popc(same);
  }
  __syncthreads();
  scan_counts(L.cnt, L.start, L.start + rows + 1, rows);  // 3.
  // 4. place, in slot order within each warp's range
  for (int k = w0; k < w1; k += 32) {
    const int s = k + lane < w1 ? L.comp[k + lane] : 0;
    const int d = k + lane < w1 ? L.dest[s] : -1;
    const unsigned same = same_row(d, bits);
    if (d >= 0) {
      const int at = cnt[d] + __popc(same & below);
      L.list[at] = Op::src_rel(s);
      if (Op::kAux) L.word[at] = L.aux[s];
    }
    __syncwarp();
    if (d >= 0 && (same & below) == 0) cnt[d] += __popc(same);
    __syncwarp();
  }
  __syncthreads();
}

// "ordered": the block's part of the grid (B * tiles, slices); S slots and
// M destination rows a cloud, C channels.
template <class Op, typename Out, int V>
__device__ __forceinline__ void ordered_block(const Op& op,
                                              Out* __restrict__ out, int S,
                                              int M, int C, const Tiling& t,
                                              unsigned char* smem) {
  typedef typename Vec<typename Op::In, V>::type L;
  constexpr int U = Op::kUnroll;
  const int rows = t.rows;
  const Lists lists(smem, rows, t.chunk, Op::kAux);
  float* part = reinterpret_cast<float*>(lists.next);
  const int tiles = (M + rows - 1) / rows;
  const int b = blockIdx.x / tiles;
  const int r0 = (blockIdx.x - b * tiles) * rows;
  const int G = 1 << t.lshift, cs = G * V;
  const int sub = threadIdx.x & (G - 1), grp = threadIdx.x >> t.lshift;
  const int R = rows >> (8 - t.lshift);  // rows a group: rows / groups
  const int d0 = grp * R, dn = min(R, M - r0 - d0);  // this group's rows
  const int c = blockIdx.y * cs + sub * V;
  const bool live = c < C;
  Out* orow = out + ((size_t)b * M + r0) * C + c;
  float* prow = part + sub * V;
  const int rounds = (S + t.chunk - 1) / t.chunk;

  for (int round = 0; round < rounds; ++round) {
    const int k0 = round * t.chunk;
    build_lists(op, lists, b, k0, min(S - k0, t.chunk), r0, rows);
    // 5. stream this group's lists in order
    if (dn > 0) {
      const bool last = round == rounds - 1;
      float acc[V];
      int d = d0, end = lists.start[d0 + 1];
      auto open = [&](int row) {
        if (round == 0) {
#pragma unroll
          for (int i = 0; i < V; ++i) acc[i] = 0.0f;
        } else {
#pragma unroll
          for (int i = 0; i < V; ++i) acc[i] = prow[(size_t)row * cs + i];
        }
      };
      auto close = [&](int row) {
        if (!last) {
#pragma unroll
          for (int i = 0; i < V; ++i) prow[(size_t)row * cs + i] = acc[i];
        } else if (live) {
          store(orow + (size_t)row * C, acc);
        }
      };
      open(d);
      const int e_end = lists.start[d0 + dn];
      for (int e = lists.start[d0]; e < e_end; e += U) {
        L v[U];
        int en[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (e + u < e_end) {
            en[u] = lists.list[e + u];
            if (live)
              v[u] = __ldg(reinterpret_cast<const L*>(op.row(b, k0, en[u]) +
                                                      c));
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (e + u < e_end) {
            while (e + u >= end) {  // row d's list ends before this entry
              close(d);
              end = lists.start[++d + 1];
              open(d);
            }
            if (live) {
              const unsigned a = Op::kAux ? lists.word[e + u] : 0u;
              float x[V];
              unpack(v[u], x);
#pragma unroll
              for (int i = 0; i < V; ++i)
                acc[i] = __fadd_rn(acc[i], op.addend(x[i], a));
            }
          }
        }
      }
      for (;;) {  // the last rows, and rows no slot of the round names
        close(d);
        if (++d == d0 + dn) break;
        open(d);
      }
    }
    __syncthreads();  // the next round restages the slots and lists
  }
}

// "staged": grid (B, slices); one round, a tile of all M rows; 8 channels
// a lane, the sources already rounded (Op::addend_bf16), otherwise the
// order and arithmetic of "ordered".
template <class Op>
__device__ __forceinline__ void staged_block(const Op& op,
                                             __nv_bfloat16* __restrict__ out,
                                             int S, int M, int C,
                                             const Tiling& t,
                                             unsigned char* smem) {
  const int rows = t.rows;
  const Lists lists(smem, rows, t.chunk, Op::kAux);
  const int G = 1 << t.lshift, cs = G * 8;
  uint4* src = reinterpret_cast<uint4*>(lists.next);  // [src rows][cs / 8]
  const int b = blockIdx.x, c0 = blockIdx.y * cs;
  op.stage_src(b, c0, cs, src);
  build_lists(op, lists, b, 0, S, 0, rows);  // its barriers cover src
  const int sub = threadIdx.x & (G - 1), grp = threadIdx.x >> t.lshift;
  const int R = rows >> (8 - t.lshift);
  const int d0 = grp * R, dn = min(R, M - d0);
  const int c = c0 + sub * 8;
  if (c >= C || dn <= 0) return;
  __nv_bfloat16* orow = out + (size_t)b * M * C + c;
  const int e_end = lists.start[d0 + dn];
  int d = d0, end = lists.start[d0 + 1];
  float acc[8] = {};
  for (int e = lists.start[d0]; e < e_end; e += 4) {  // four entries' reads
    uint4 v[4];                                        // before their adds
    unsigned a[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (e + u < e_end) {
        a[u] = lists.word[e + u];
        v[u] = src[lists.list[e + u] * G + sub];
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (e + u < e_end) {
        while (e + u >= end) {  // row d's list ends before this entry
          store(orow + (size_t)d * C, acc);
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[i] = 0.0f;
          end = lists.start[++d + 1];
        }
        float x[8];
        unpack(v[u], x);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          acc[i] = __fadd_rn(acc[i], op.addend_bf16(x[i], a[u]));
      }
    }
  }
  for (;;) {  // the last rows, and rows no slot names
    store(orow + (size_t)d * C, acc);
    if (++d == d0 + dn) break;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.0f;
  }
}

// "l2red": a thread a (slot, V channels) of the grid's flat items, adding
// into acc (B, M, C) f32, zeroed before the launch.
template <class Op, int V>
__device__ __forceinline__ void l2red_thread(const Op& op,
                                             float* __restrict__ acc, int S,
                                             int M, int C, long long items) {
  typedef typename Vec<typename Op::In, V>::type L;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= items) return;
  const int vpr = C / V;
  const long long bs = i / vpr;
  const int c = (int)(i - bs * vpr) * V;
  const int b = (int)(bs / S), s = (int)(bs - (long long)b * S);
  int r;
  unsigned a;
  if (!op.slot(b, s, r, a)) return;
  float x[V];
  unpack(__ldg(reinterpret_cast<const L*>(op.row(b, 0, Op::src_rel(s)) + c)),
         x);
  float* dst = acc + ((size_t)b * M + r) * C + c;
  if constexpr (V == 4) {
    atomicAdd(reinterpret_cast<float4*>(dst),
              make_float4(op.addend(x[0], a), op.addend(x[1], a),
                          op.addend(x[2], a), op.addend(x[3], a)));
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) atomicAdd(dst + k, op.addend(x[k], a));
  }
}

__global__ void __launch_bounds__(kThreads)
round_to_bf16_kernel(const float* __restrict__ acc, long long total,
                     __nv_bfloat16* __restrict__ out) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e < total) out[e] = __float2bfloat16_rn(acc[e]);
}

// Raise the kernel's dynamic shared memory limit where a launch needs more
// than the default 48 KB.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem > (size_t)kSmemLimit) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// One launch of a scatter kernel with its shared memory; cudaGetLastError.
template <typename K, typename... A>
inline cudaError_t launch(K kernel, dim3 grid, size_t smem,
                          cudaStream_t stream, A... args) {
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// The grid of "ordered" and "staged": (B * row tiles, channel slices).
inline dim3 block_grid(const Tiling& t, int B, int M, int C) {
  const int cs = (1 << t.lshift) * t.vec;
  return dim3((unsigned)((long long)B * ((M + t.rows - 1) / t.rows)),
              (unsigned)((C + cs - 1) / cs));
}

// Checks a tiling against the shape before a launch.
inline bool valid(const Tiling& t, int C) {
  if (t.design == kOrdered || t.design == kStaged)
    return (t.vec == 1 || t.vec == 4 || t.vec == 8) && t.lshift >= 0 &&
           t.lshift <= 5 && t.rows >= 1 && t.rows <= 1024 &&
           t.rows % (kThreads >> t.lshift) == 0 && t.chunk >= 1 &&
           t.chunk <= 65535 && C % t.vec == 0 &&
           (t.design == kOrdered || t.vec == 8);
  return t.design == kL2Red && (t.vec == 1 || t.vec == 4) && C % t.vec == 0;
}

}  // namespace apt_scatter
