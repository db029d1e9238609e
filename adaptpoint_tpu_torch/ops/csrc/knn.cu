// Exact k nearest neighbours for Hopper (sm_90a): indices only.
//
// Replaces the TPU kernel adaptpoint_tpu/ops/pallas/knn.py knn_pallas
// (_knn_kernel). Same function as the plain version ops/knn.py
// knn_idx_plain: for each query the k_eff = min(k, N) support points of
// smallest squared distance, nearest first, ties to the lowest index; when
// k > N the remaining slots repeat the nearest. Only the indices are
// produced: the caller recomputes the distances differentiably from the
// gathered rows (ops.knn_point), as the JAX package does around its kernel.
//
// Distance: the expanded form (|q|^2 + |x|^2) - 2 q.x, every product and sum
// rounded on its own and added in channel order (__fmul_rn / __fadd_rn, and
// the file builds with -fmad=false), which is the arithmetic the plain
// version writes out op by op. Distances are therefore equal bit for bit and
// near-ties resolve alike: the indices are compared exactly on the card. The
// TPU kernel's 6-term bf16 split of the cross product is the TPU's way to
// an f32 matmul and is not carried over. A distance that is NaN or +inf is
// never selected; a query left without candidates repeats its nearest (index
// 0 if it has none).
//
// What bounds it: operations. It reads (N + M) * C floats and writes M * k
// indices, a few hundred KB at the FP-decode shapes, but computes M * N
// distances (2C + 3 operations each) and keeps the k smallest.
//
// Design: one pass over the support a query. A sorted list of the L nearest
// (distance, index) pairs so far lives in registers; a point enters it only
// if it is strictly nearer than the list's last, behind any equal distance,
// so among equal distances the lower index (scanned first) stays first. The
// block stages its cloud's support in shared memory: (x, y, z, |x|^2) as one
// float4 a point at C = 3, else C planes and a plane of |x|^2. Two variants,
// which the wrapper picks by (k, N, C) (ops/knn.py knn_variant):
//   - a thread a query (C = 3, k <= 8; the FP decode's k = 3): 128 queries a
//     block, the query and |q|^2 in registers, every support read a broadcast
//     of one float4 to the warp; the list of L = k (3) or 8 is the output;
//   - a warp a query (k > 8, or C != 3): lane l scans points l, l + 32, ...
//     into its own list of L = min(k, ceil(N / 32)) rounded up to a power of
//     two; then k_eff rounds of a warp argmin over the lists' heads
//     (redux.sync min of the distance's order-preserving bits, then of the
//     index among the lanes that hold it) pop the winners in order. At C = 3
//     the query sits in registers; otherwise each channel of the query is a
//     warp-wide broadcast load.
// Nothing but the k indices leaves the block. Shared memory holds
// N * (C + 1) floats: N <= knn_max_points(C) (14,528 at C = 3).
//
// Past knn_max_points(C) (DGCNN's feature-space graphs: N = 1024 at C = 64
// and 128, where the staged support would need 266 and 529 KB) the tiled
// instance, knn_tiled_kernel, takes the call. It is built like a matrix
// product, since that is what its distances are:
//   - a block takes kTQ = 64 queries of one cloud and streams the support
//     in tiles of kTP = 64 points; each thread holds a 4 x 4 micro-tile of
//     (query, point) cross products in registers, and per four channels
//     reads four queries and four points as float4s: half a shared-memory
//     load a multiply-add (the warp-a-query scan made two). Every
//     accumulator still takes its products one channel after another, each
//     product and sum rounded on its own (no FMA), so the distances are the
//     plain version's bit for bit;
//   - the ring: kStages = 2 slots of (64 queries + 64 points) x kCK = 64
//     channels, filled by cp.async (16-byte copies where C % 4 == 0, else
//     4-byte ones) a stage ahead of the products; rows padded to 68 floats,
//     so the 8 rows a warp reads at once fall in distinct banks. C is taken
//     in chunks of 64, so shared memory (86.5 KB, two blocks an SM) does not
//     grow with C;
//   - each point's and each query's |.|^2 is summed once per block, in
//     channel order across the chunks, by two of the eight warps;
//   - after a tile's last chunk the 64 x 64 distances go to shared memory
//     and each warp merges 8 queries' rows into their lists. A query's list
//     is the 32 nearest so far, one (distance, index) pair a lane, sorted by
//     distance then index. It starts as the first tile's first 32 points,
//     sorted by a bitonic network; later a row of 32 candidates is compared
//     with the list's k-th entry, and only those before it are inserted (a
//     ballot for the rank, a shuffle up for the shift), about k ln(N / 32)
//     a query after the first 32 on data in random order (69 at k = 20,
//     N = 1024). The order is the pair's, so the scan order does not matter
//     and ties go to the lower index as in the plain version.
// 256 threads a block, two blocks an SM (launch bounds); a block reads its
// cloud's support once per 64 queries. The bound is operations,
// M * N * (2C + 2) a cloud (C products and C - 1 sums of q.x, |q|^2 + |x|^2,
// the doubling, the difference); without FMAs each is an instruction, so
// half the f32 peak is the ceiling. Where the time goes is read from
// variants of this file (scripts/knn_tiled_variants.py: no selection, the
// first tile's merge alone, candidates filtered but not inserted, other
// stages) timed by scripts/torch_fps_knn_timing.py --unchecked; PERF.md
// keeps the readings. The ring takes any C: the only ceiling is the
// launcher's int.
#include <cuda_runtime.h>
#include <climits>
#include <cmath>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreadQueries = 128;  // a block of the thread-a-query variant
constexpr int kWarpsPerBlock = 8;    // the warp-a-query variant
constexpr size_t kMaxSmem = 227 * 1024;
// the tiled instance's plan (ops/knn.py knn_tiled_plan holds a copy)
constexpr int kTQ = 64;              // queries a block
constexpr int kTP = 64;              // points a tile
constexpr int kCK = 64;              // channels a stage
constexpr int kStages = 2;           // stages in the ring
constexpr int kRow = kCK + 4;        // a staged row, padded (see the note)
constexpr int kDRow = kTP + 8;       // a row of the distance tile
constexpr int kStageFloats = (kTQ + kTP) * kRow;
constexpr int kTiledThreads = 256;   // 8 warps, a 4 x 4 micro-tile a thread
constexpr int kWarpQueries = kTQ / (kTiledThreads / 32);
static_assert(kTQ == 64 && kTP == 64, "the micro-tile map covers 64 x 64");

// Shared memory of a tiled block: the ring, the distance tile, the norms.
constexpr size_t kTiledSmem =
    ((size_t)kStages * kStageFloats + (size_t)kTQ * kDRow + kTQ + kTP) *
    sizeof(float);

// Sorted insertion of (d, j) into (ld, li)[0..L): only where d is strictly
// smaller than the last entry; behind entries of equal distance.
template <int L>
__device__ __forceinline__ void insert(float (&ld)[L], int (&li)[L], float d,
                                       int j) {
  if (!(d < ld[L - 1])) return;  // also drops NaN
#pragma unroll
  for (int t = L - 1; t > 0; --t) {
    if (d < ld[t - 1]) {
      ld[t] = ld[t - 1];
      li[t] = li[t - 1];
    } else if (d < ld[t]) {
      ld[t] = d;
      li[t] = j;
    }
  }
  if (d < ld[0]) {
    ld[0] = d;
    li[0] = j;
  }
}

// The distance's bits in an order that follows the float order (no NaN).
__device__ __forceinline__ unsigned ordered(float d) {
  const unsigned u = __float_as_uint(__fadd_rn(d, 0.0f));  // -0 -> +0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The cloud's support into shared memory: float4 (x, y, z, |x|^2) at C = 3,
// else C planes of N and |x|^2 after them.
template <bool kC3>
__device__ __forceinline__ void stage_support(const float* X, int N, int C,
                                              float* sm) {
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    float acc = 0.0f;
    if (kC3) {
      const float x = X[(size_t)i * 3], y = X[(size_t)i * 3 + 1],
                  z = X[(size_t)i * 3 + 2];
      acc = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                      __fmul_rn(z, z));
      reinterpret_cast<float4*>(sm)[i] = make_float4(x, y, z, acc);
    } else {
      for (int c = 0; c < C; ++c) {
        const float v = X[(size_t)i * C + c];
        sm[(size_t)c * N + i] = v;
        const float sq = __fmul_rn(v, v);
        acc = c == 0 ? sq : __fadd_rn(acc, sq);
      }
      sm[(size_t)C * N + i] = acc;
    }
  }
}

// d2 of the query (qx, qy, qz, q2) to a staged C = 3 point.
__device__ __forceinline__ float dist3(float qx, float qy, float qz, float q2,
                                       float4 x) {
  const float cross = __fadd_rn(__fadd_rn(__fmul_rn(qx, x.x), __fmul_rn(qy, x.y)),
                                __fmul_rn(qz, x.z));
  return __fsub_rn(__fadd_rn(q2, x.w), __fmul_rn(2.0f, cross));
}

template <int L>
__global__ void __launch_bounds__(kThreadQueries)
knn_thread_kernel(const float* __restrict__ xyz, const float* __restrict__ query,
                  int N, int M, int K, int* __restrict__ idx) {
  extern __shared__ float4 pts[];
  const int b = blockIdx.y;
  stage_support<true>(xyz + (size_t)b * N * 3, N, 3,
                      reinterpret_cast<float*>(pts));
  __syncthreads();
  const int m = blockIdx.x * kThreadQueries + threadIdx.x;
  if (m >= M) return;
  const float* Q = query + ((size_t)b * M + m) * 3;
  const float qx = Q[0], qy = Q[1], qz = Q[2];
  const float q2 = __fadd_rn(__fadd_rn(__fmul_rn(qx, qx), __fmul_rn(qy, qy)),
                             __fmul_rn(qz, qz));
  float ld[L];
  int li[L];
#pragma unroll
  for (int t = 0; t < L; ++t) {
    ld[t] = INFINITY;
    li[t] = INT_MAX;
  }
  for (int j = 0; j < N; ++j) insert<L>(ld, li, dist3(qx, qy, qz, q2, pts[j]), j);
  int* out = idx + ((size_t)b * M + m) * K;
  const int first = li[0] == INT_MAX ? 0 : li[0];
#pragma unroll
  for (int t = 0; t < L; ++t)
    if (t < K) out[t] = li[t] == INT_MAX ? first : li[t];
  for (int t = L; t < K; ++t) out[t] = first;
}

template <int L, bool kC3>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
knn_warp_kernel(const float* __restrict__ xyz, const float* __restrict__ query,
                int N, int M, int C, int K, int* __restrict__ idx) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const int b = blockIdx.y;
  stage_support<kC3>(xyz + (size_t)b * N * C, N, C, sm);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (m >= M) return;  // whole warps
  const float* Q = query + ((size_t)b * M + m) * C;
  float q2 = 0.0f, qx = 0.0f, qy = 0.0f, qz = 0.0f;
  if (kC3) {
    qx = Q[0];
    qy = Q[1];
    qz = Q[2];
    q2 = __fadd_rn(__fadd_rn(__fmul_rn(qx, qx), __fmul_rn(qy, qy)),
                   __fmul_rn(qz, qz));
  } else {
    for (int c = 0; c < C; ++c) {
      const float sq = __fmul_rn(Q[c], Q[c]);
      q2 = c == 0 ? sq : __fadd_rn(q2, sq);
    }
  }
  float ld[L];
  int li[L];
#pragma unroll
  for (int t = 0; t < L; ++t) {
    ld[t] = INFINITY;
    li[t] = INT_MAX;
  }
  for (int j = lane; j < N; j += 32) {  // increasing j within a lane
    float d;
    if (kC3) {
      d = dist3(qx, qy, qz, q2, sm4[j]);
    } else {
      float cross = 0.0f;
      for (int c = 0; c < C; ++c) {
        const float pr = __fmul_rn(Q[c], sm[(size_t)c * N + j]);
        cross = c == 0 ? pr : __fadd_rn(cross, pr);
      }
      d = __fsub_rn(__fadd_rn(q2, sm[(size_t)C * N + j]),
                    __fmul_rn(2.0f, cross));
    }
    insert<L>(ld, li, d, j);
  }
  // k_eff rounds of a warp argmin over the lists' heads; lane p keeps the
  // p-th winner
  const int k_eff = K < N ? K : N;
  int mine = INT_MAX, first = INT_MAX;
  for (int p = 0; p < k_eff; ++p) {
    const unsigned key = li[0] == INT_MAX ? kFull : ordered(ld[0]);
    const unsigned kmin = __reduce_min_sync(kFull, key);
    const unsigned jmin = __reduce_min_sync(
        kFull, key == kmin ? (unsigned)li[0] : kFull);
    if (kmin == kFull) break;  // no candidate left (NaN or inf distances)
    if (p == 0) first = (int)jmin;
    if (lane == p) mine = (int)jmin;
    if ((unsigned)li[0] == jmin) {  // the winner pops its head
#pragma unroll
      for (int t = 0; t < L - 1; ++t) {
        ld[t] = ld[t + 1];
        li[t] = li[t + 1];
      }
      ld[L - 1] = INFINITY;
      li[L - 1] = INT_MAX;
    }
  }
  if (first == INT_MAX) first = 0;
  if (lane < K) idx[((size_t)b * M + m) * K + lane] =
      mine == INT_MAX ? first : mine;
}

// ---------------------------------------------------------------------------
// The tiled instance (see the note at the top).

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// One stage of the ring: the block's kTQ queries, then the tile's kTP points,
// channels c0 .. c0 + kCK of each, a padded row each; rows and channels past
// the arrays are zero-filled. kVec: 16-byte copies (C % 4 == 0 and aligned
// arrays), else 4-byte ones. The divisions are by constants (shifts).
template <bool kVec>
__device__ __forceinline__ void load_stage(float* st, const float* Q,
                                           const float* X, int M, int N,
                                           int C, int m0, int base, int c0) {
  constexpr int kPer = kVec ? kCK / 4 : kCK;  // copies a row
  for (int e = threadIdx.x; e < (kTQ + kTP) * kPer; e += kTiledThreads) {
    const int r = e / kPer, c = (e % kPer) * (kVec ? 4 : 1);
    const bool isq = r < kTQ;
    const int row = isq ? m0 + r : base + r - kTQ;
    const bool ok = row < (isq ? M : N) && c0 + c < C;
    const float* src = (isq ? Q : X) + (ok ? (size_t)row * C + c0 + c : 0);
    if (kVec)
      cp_async16(st + r * kRow + c, src, ok);
    else
      cp_async4(st + r * kRow + c, src, ok);
  }
}

// (d, j) strictly before (e, i): nearer, or as near with a lower index.
__device__ __forceinline__ bool before(float d, int j, float e, int i) {
  return d < e || (d == e && j < i);
}

// The warp's 32 (distance, index) pairs, one a lane, sorted ascending by
// `before` across the lanes (a bitonic network of 15 exchanges).
__device__ __forceinline__ void warp_sort(float& d, int& j, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const float od = __shfl_xor_sync(kFull, d, stride);
      const int oj = __shfl_xor_sync(kFull, j, stride);
      const bool keep_min = ((lane & stride) == 0) == ((lane & size) == 0);
      if (keep_min ? before(od, oj, d, j) : before(d, j, od, oj)) {
        d = od;
        j = oj;
      }
    }
  }
}

// Insert (v, i) into the warp's sorted list (lane l holds its l-th entry):
// its rank is the number of entries before it; the entries from there on
// move up one lane and the last falls off. A rank of 32 changes nothing.
__device__ __forceinline__ void warp_insert(float& d, int& j, float v, int i,
                                            int lane) {
  const int rank = __popc(__ballot_sync(kFull, before(d, j, v, i)));
  const float ud = __shfl_up_sync(kFull, d, 1);
  const int uj = __shfl_up_sync(kFull, j, 1);
  if (lane == rank) {
    d = v;
    j = i;
  } else if (lane > rank) {
    d = ud;
    j = uj;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kTiledThreads, 2)
knn_tiled_kernel(const float* __restrict__ xyz, const float* __restrict__ query,
                 int N, int M, int C, int K, int* __restrict__ idx) {
  extern __shared__ float4 sm4[];
  float* ring = reinterpret_cast<float*>(sm4);
  float* D = ring + kStages * kStageFloats;  // kTQ rows of kDRow
  float* q2s = D + kTQ * kDRow;
  float* x2s = q2s + kTQ;
  const int b = blockIdx.y, m0 = blockIdx.x * kTQ;
  const float* Q = query + (size_t)b * M * C;
  const float* X = xyz + (size_t)b * N * C;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  // the micro-tile: points tx + 16 jj, queries ty + 16 ii; a warp spans
  // 8 point columns and 4 query rows
  const int tx = (lane & 7) + ((warp & 1) << 3);
  const int ty = (lane >> 3) + ((warp >> 1) << 2);
  const int nK = (C + kCK - 1) / kCK;
  const int total = (N + kTP - 1) / kTP * nK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total)
      load_stage<kVec>(ring + s * kStageFloats, Q, X, M, N, C, m0,
                       s / nK * kTP, s % nK * kCK);
    cp_async_commit();
  }
  float acc[4][4];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[ii][jj] = -0.0f;  // -0 + x == x
  float nrm = -0.0f;  // threads 0-63: |q|^2 (first tile), 64-127: |x|^2
  float ld[kWarpQueries];  // the sorted lists of the warp's queries
  int li[kWarpQueries];
  for (int s = 0; s < total; ++s) {
    const int tile = s / nK, kc = s - tile * nK;
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage s is in; stage s - 1's slot is free
    {
      const int sn = s + kStages - 1;
      if (sn < total)
        load_stage<kVec>(ring + sn % kStages * kStageFloats, Q, X, M, N, C,
                         m0, sn / nK * kTP, sn % nK * kCK);
      cp_async_commit();
    }
    const float* st = ring + s % kStages * kStageFloats;
    const float* Qs = st;
    const float* Xs = st + kTQ * kRow;
    const int cc = min(kCK, C - kc * kCK);
    // the norms, each a sum in channel order carried across the chunks
    if (t < kTQ + kTP && (t >= kTQ || tile == 0)) {
      const float* row = st + t * kRow;
      if (kVec) {
        for (int c = 0; c < cc; c += 4) {
          const float4 v = *reinterpret_cast<const float4*>(row + c);
          nrm = __fadd_rn(nrm, __fmul_rn(v.x, v.x));
          nrm = __fadd_rn(nrm, __fmul_rn(v.y, v.y));
          nrm = __fadd_rn(nrm, __fmul_rn(v.z, v.z));
          nrm = __fadd_rn(nrm, __fmul_rn(v.w, v.w));
        }
      } else {
        for (int c = 0; c < cc; ++c)
          nrm = __fadd_rn(nrm, __fmul_rn(row[c], row[c]));
      }
      if (kc == nK - 1) {
        (t < kTQ ? q2s[t] : x2s[t - kTQ]) = nrm;
        nrm = -0.0f;
      }
    }
    // the cross products, one channel after another in every accumulator
    if (kVec) {
#pragma unroll 2
      for (int c = 0; c < cc; c += 4) {
        float4 a[4], x[4];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
          a[ii] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * ii) * kRow + c);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          x[jj] = *reinterpret_cast<const float4*>(Xs + (tx + 16 * jj) * kRow + c);
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            float r = acc[ii][jj];
            r = __fadd_rn(r, __fmul_rn(a[ii].x, x[jj].x));
            r = __fadd_rn(r, __fmul_rn(a[ii].y, x[jj].y));
            r = __fadd_rn(r, __fmul_rn(a[ii].z, x[jj].z));
            acc[ii][jj] = __fadd_rn(r, __fmul_rn(a[ii].w, x[jj].w));
          }
      }
    } else {
      for (int c = 0; c < cc; ++c) {
        float a[4], x[4];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) a[ii] = Qs[(ty + 16 * ii) * kRow + c];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) x[jj] = Xs[(tx + 16 * jj) * kRow + c];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            acc[ii][jj] = __fadd_rn(acc[ii][jj], __fmul_rn(a[ii], x[jj]));
      }
    }
    if (kc != nK - 1) continue;
    // the tile's distances into D, then each warp merges its queries' rows
    __syncthreads();  // the norms are in
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        D[(ty + 16 * ii) * kDRow + tx + 16 * jj] =
            __fsub_rn(__fadd_rn(q2s[ty + 16 * ii], x2s[tx + 16 * jj]),
                      __fmul_rn(2.0f, acc[ii][jj]));
        acc[ii][jj] = -0.0f;
      }
    __syncthreads();
    const int base = tile * kTP;
    const int n = min(kTP, N - base);
#pragma unroll
    for (int qi = 0; qi < kWarpQueries; ++qi) {
      const int q = warp * kWarpQueries + qi;
      if (m0 + q >= M) continue;  // the whole warp
#pragma unroll
      for (int h = 0; h < kTP / 32; ++h) {
        const int p = h * 32 + lane;
        const float v = D[q * kDRow + p];
        // NaN and +inf are never candidates
        const bool ok = p < n && v < INFINITY;
        if (tile == 0 && h == 0) {  // the list starts as these 32, sorted
          float d = ok ? v : INFINITY;
          int j = ok ? base + p : INT_MAX;
          warp_sort(d, j, lane);
          ld[qi] = d;
          li[qi] = j;
          continue;
        }
        // only what comes before the k-th entry can enter; the threshold is
        // read once a row of 32 (one that has since moved up lets more
        // through, which warp_insert places at rank >= K or drops)
        const float td = __shfl_sync(kFull, ld[qi], K - 1);
        const int tj = __shfl_sync(kFull, li[qi], K - 1);
        unsigned mask = __ballot_sync(kFull, ok && before(v, base + p, td, tj));
        while (mask) {
          const int src = __ffs(mask) - 1;
          mask &= mask - 1;
          warp_insert(ld[qi], li[qi], __shfl_sync(kFull, v, src),
                      base + h * 32 + src, lane);
        }
      }
    }
  }
  // lane l < K writes the l-th nearest; a slot without a candidate (k > N,
  // or NaN / inf distances) repeats the nearest, index 0 if there is none
#pragma unroll
  for (int qi = 0; qi < kWarpQueries; ++qi) {
    const int m = m0 + warp * kWarpQueries + qi;
    if (m >= M) continue;
    const int first = __shfl_sync(kFull, li[qi], 0);
    const int f = first == INT_MAX ? 0 : first;
    if (lane < K)
      idx[((size_t)b * M + m) * K + lane] = li[qi] == INT_MAX ? f : li[qi];
  }
}

template <int L>
cudaError_t launch_thread(const float* xyz, const float* query, int B, int N,
                          int M, int K, int* idx, cudaStream_t stream) {
  const size_t smem = (size_t)N * 16;
  cudaError_t e = cudaFuncSetAttribute(
      knn_thread_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((M + kThreadQueries - 1) / kThreadQueries, B);
  knn_thread_kernel<L><<<grid, kThreadQueries, smem, stream>>>(xyz, query, N,
                                                               M, K, idx);
  return cudaGetLastError();
}

template <int L, bool kC3>
cudaError_t launch_warp(const float* xyz, const float* query, int B, int N,
                        int M, int C, int K, int* idx, cudaStream_t stream) {
  const size_t smem = (size_t)N * (C + 1) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      knn_warp_kernel<L, kC3>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((M + kWarpsPerBlock - 1) / kWarpsPerBlock, B);
  knn_warp_kernel<L, kC3><<<grid, kWarpsPerBlock * 32, smem, stream>>>(
      xyz, query, N, M, C, K, idx);
  return cudaGetLastError();
}

template <bool kC3>
cudaError_t launch_warp_l(const float* xyz, const float* query, int B, int N,
                          int M, int C, int K, int L, int* idx,
                          cudaStream_t stream) {
  switch (L) {
    case 1: return launch_warp<1, kC3>(xyz, query, B, N, M, C, K, idx, stream);
    case 2: return launch_warp<2, kC3>(xyz, query, B, N, M, C, K, idx, stream);
    case 4: return launch_warp<4, kC3>(xyz, query, B, N, M, C, K, idx, stream);
    case 8: return launch_warp<8, kC3>(xyz, query, B, N, M, C, K, idx, stream);
    case 16:
      return launch_warp<16, kC3>(xyz, query, B, N, M, C, K, idx, stream);
    case 32:
      return launch_warp<32, kC3>(xyz, query, B, N, M, C, K, idx, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kVec>
cudaError_t launch_tiled(const float* xyz, const float* query, int B, int N,
                         int M, int C, int K, int* idx, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      knn_tiled_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kTiledSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid((M + kTQ - 1) / kTQ, B);
  knn_tiled_kernel<kVec><<<grid, kTiledThreads, kTiledSmem, stream>>>(
      xyz, query, N, M, C, K, idx);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest N the kernel takes at C channels (shared-memory planes).
int knn_max_points(int C) {
  return (int)(kMaxSmem / ((size_t)(C + 1) * sizeof(float)));
}

// The tiled instance's plan: queries a block, points a tile, channels a
// stage, stages in the ring, shared memory a block (bytes).
void knn_tiled_plan(int* out) {
  out[0] = kTQ;
  out[1] = kTP;
  out[2] = kCK;
  out[3] = kStages;
  out[4] = (int)kTiledSmem;
}

// The tiled instance: xyz (B,N,C), query (B,M,C) f32, contiguous -> idx
// (B,M,K) i32; any N >= 1 and C >= 1. Returns cudaError_t.
int knn_tiled_launch(const float* xyz, const float* query, int B, int N,
                     int M, int C, int K, int* idx, cudaStream_t stream) {
  if (B <= 0 || N <= 0 || M <= 0 || C <= 0 || K <= 0 || K > 32 ||
      B > 65535)
    return cudaErrorInvalidValue;
  const bool vec = C % 4 == 0 && (size_t)xyz % 16 == 0 &&
                   (size_t)query % 16 == 0;
  return vec ? launch_tiled<true>(xyz, query, B, N, M, C, K, idx, stream)
             : launch_tiled<false>(xyz, query, B, N, M, C, K, idx, stream);
}

// xyz (B,N,C) f32 support, query (B,M,C) f32, contiguous -> idx (B,M,K) i32.
// variant 0: a thread a query (C = 3, L = 1, 2, 3, 4 or 8 >= K); variant 1:
// a warp a query (L = 1, 2, 4, 8, 16 or 32, L >= min(K, ceil(N / 32))).
// Returns cudaError_t.
int knn_launch(const float* xyz, const float* query, int B, int N, int M,
               int C, int K, int variant, int L, int* idx,
               cudaStream_t stream) {
  if (B <= 0 || N <= 0 || M <= 0 || C <= 0 || K <= 0 || K > 32 ||
      B > 65535 || N > knn_max_points(C))
    return cudaErrorInvalidValue;
  if (variant == 0) {
    if (C != 3 || L < K) return cudaErrorInvalidValue;
    switch (L) {
      case 1: return launch_thread<1>(xyz, query, B, N, M, K, idx, stream);
      case 2: return launch_thread<2>(xyz, query, B, N, M, K, idx, stream);
      case 3: return launch_thread<3>(xyz, query, B, N, M, K, idx, stream);
      case 4: return launch_thread<4>(xyz, query, B, N, M, K, idx, stream);
      case 8: return launch_thread<8>(xyz, query, B, N, M, K, idx, stream);
      default: return cudaErrorInvalidValue;
    }
  }
  if (variant != 1 || L < (K < (N + 31) / 32 ? K : (N + 31) / 32))
    return cudaErrorInvalidValue;
  return C == 3 ? launch_warp_l<true>(xyz, query, B, N, M, C, K, L, idx, stream)
                : launch_warp_l<false>(xyz, query, B, N, M, C, K, L, idx,
                                       stream);
}

const char* apt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
