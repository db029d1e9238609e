// Furthest point sampling for Hopper (sm_90a).
//
// Replaces the TPU kernel adaptpoint_tpu/ops/pallas/fps.py
// (furthest_point_sample_pallas, _fps_kernel). Same function as the plain
// version ops/geometry.py furthest_point_sample: the first index is 0, the
// running min-distance starts at 1e10, and each step takes the first index of
// the maximum.
//
// What bounds it: the latency of the dependent chain, not bytes or
// operations. Each of the npoint - 1 steps needs the last step's winner, and
// a step's work (N distances, a few hundred operations a thread at most) is
// small beside the latency of a block-wide argmax. Only B of the card's 132
// SMs have work (one block a cloud).
//
// Two kernels; the wrapper picks one by N (ops/fpsample.py fps_tiling): the
// chain kernel up to 4096 points, the pruned kernel past them.
//
// The chain kernel (fps_kernel): one block a cloud, T = 512 threads up to
// N = 2048, else 1024, N up to 4096. Thread t owns the P <= 4 consecutive
// points tP .. tP + P - 1, their coordinates and running minima in
// registers. Because a lower lane, and a lower warp, owns lower indices, the
// first index of a maximum is the maximum held by the lowest lane (warp)
// that holds it. A step is:
//   1. each thread updates its minima against the last winner (q) and keeps
//      its first maximum with that point's coordinates;
//   2. each warp takes the max of the values' bits with redux.sync (every
//      minimum is >= +0, so the bits order like the values), and the lowest
//      lane holding it (ballot) writes (value, index, x, y, z) to the warp's
//      slot of a partial array chosen by step parity;
//   3. one __syncthreads;
//   4. every warp reads all the partials and reduces them the same way, and
//      takes the winner's coordinates from the winning partial by shuffle:
//      the next step starts without a shared-memory load of the winner.
// Two partial arrays by parity make one barrier a step enough: a warp
// writes step j + 2's partial only after the barrier of step j + 1, which
// every warp passes after reading step j's.
//
// The cluster instance (fps_cluster_kernel, 4096 threads of 6 points, N up
// to 24576): the earlier pick past 16384 points, compiled only to be timed
// beside the pruned kernel (ops/fpsample.py FPS_CLUSTER_INSTANCE). A cloud
// spans a thread-block cluster of CB = 4 blocks of 1024 threads, block r
// owning the points r * 1024 P .. (r + 1) * 1024 P - 1, their coordinates in
// shared memory planes. In step 2 the winning lane writes its warp's partial
// to its slot r * 32 + warp of the partial arrays of every block of the
// cluster (through distributed shared memory); step 3 is a cluster barrier;
// in step 4 the winner is the lowest warp of the lowest block holding the
// maximum. At B = 8 on the H100 (700 W) a step took 1873 ns at N = 24000
// (clusters of 2 and 8 blocks 2043 and 2546), against 1686 ns for one block
// at N = 16384: the cluster barrier, not the distance work, set a step.
//
// The pruned kernel (fps_pruned_kernel, past 4096 points, any N): one block
// of 1024 threads a cloud. It first sorts the cloud into buckets of S points
// (S = 32 up to 65536 points, then the smallest multiple of 32 that leaves at
// most two buckets a thread) by the Morton cell of a 16^3 grid over the
// cloud's box (a counting sort in shared memory) into a scratch tensor of
// (x, y, z, index), each bucket's box and best key (its largest running
// minimum, the lowest original index among ties) held by one thread. A step
// then skips every bucket whose lower bound lb on the distance from the last
// winner q is at least its best: lb is d at q clamped to the box, rounded as
// d is, and round-to-nearest is monotone, so lb <= the f32 distance of every
// point in the box and no minimum there can drop. The warp owning a near
// bucket updates it in one pass (one lane a point, its minima in shared
// memory up to 51200 points, else in the scratch) and reduces its new key;
// the block's largest key, compared as (value bits, ~index) so that the
// lowest original index wins a tie across buckets, is the next winner (one
// barrier, as above). At B = 8, 24000 -> 6000 a late step touches about 10 of
// 750 buckets (6 on a room of surfaces); on the H100 (700 W) a step took
// 1112 ns on uniform rooms and 998 on surfaces, against 1875 for the
// four-block cluster in the same call. A clocked build, timed during
// development, put ~2260 cycles a step into the check (~230), the near
// buckets' passes on the slowest warp (~800 cycles a pass: the points' L2
// latency and a warp argmax), the warp's reduction (~330) and the last
// reduction (~350): the passes, not the barrier, set it. Timed during
// development and not kept: 512 threads of two buckets (1438 ns against
// 1112), buckets of 64 (1391), loading four near buckets' points together
// (registers spill at 1024 threads; 1595 against 1208) and a list of the
// block's near buckets taken by the warps in turn (two more barriers a step;
// 1299 against 1217).
//
// Alternatives timed during development on the H100 and not kept: points
// strided over the threads (a second redux.sync a level for the index) was
// slower a step, and a 64-bit shared atomicMax of (value, ~index) in place
// of the partials was no faster. The block size barely moves a step: the
// SM's instruction rate on the distance work and the fixed chain of the
// reduction, not the threads, set it.
//
// Arithmetic: d = (dx*dx + dy*dy) + dz*dz with every product and sum rounded
// on its own (__fmul_rn/__fadd_rn, and the file builds with -fmad=false), so
// the distances and therefore the argmax ties equal the plain version's.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <climits>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 1024;
constexpr int kMaxRegPerThread = 4;  // coordinates in registers up to here

template <int T, int P>
__global__ void __launch_bounds__(T)
fps_kernel(const float* __restrict__ xyz, int N, int npoint,
           int* __restrict__ idx) {
  constexpr int W = T / 32;
  static_assert(P <= kMaxRegPerThread, "coordinates in registers");
  __shared__ float4 part[2][W];  // (value, index, x, y) of each warp
  __shared__ float part_z[2][W];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* p = xyz + (size_t)blockIdx.x * N * 3;
  float px[P], py[P], pz[P], mind[P];
#pragma unroll
  for (int t = 0; t < P; ++t) {
    const int i = tid * P + t;
    px[t] = i < N ? p[3 * i] : 0.0f;
    py[t] = i < N ? p[3 * i + 1] : 0.0f;
    pz[t] = i < N ? p[3 * i + 2] : 0.0f;
    mind[t] = i < N ? 1e10f : -1.0f;  // a slot past N stays at -1
  }
  int* out = idx + (size_t)blockIdx.x * npoint;
  if (tid == 0) out[0] = 0;
  float qx = p[0], qy = p[1], qz = p[2];

  for (int j = 1; j < npoint; ++j) {
    float bv = -1.0f, bx = 0.0f, by = 0.0f, bz = 0.0f;
    int bi = 0;
#pragma unroll
    for (int t = 0; t < P; ++t) {  // increasing index
      const float dx = __fsub_rn(px[t], qx);
      const float dy = __fsub_rn(py[t], qy);
      const float dz = __fsub_rn(pz[t], qz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      const float m = fminf(mind[t], d);  // -1 past N
      mind[t] = m;
      if (m > bv) {  // strict: the first index of a tie stays
        bv = m;
        bi = tid * P + t;
        bx = px[t];
        by = py[t];
        bz = pz[t];
      }
    }
    // the warp's winner: the lowest lane holding the max of the value bits
    // (+0 for a thread without points: it comes after every lane with one)
    const unsigned vb = bv < 0.0f ? 0u : __float_as_uint(bv);
    const unsigned wmax = __reduce_max_sync(kFull, vb);
    const unsigned won = __ballot_sync(kFull, vb == wmax);
    if (lane == __ffs(won) - 1) {
      part[j & 1][warp] =
          make_float4(__uint_as_float(wmax), __int_as_float(bi), bx, by);
      part_z[j & 1][warp] = bz;
    }
    __syncthreads();
    // every warp: the block's winner, the lowest warp holding the max
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float az = 0.0f;
    if (lane < W) {
      a = part[j & 1][lane];
      az = part_z[j & 1][lane];
    }
    const unsigned v = lane < W ? __float_as_uint(a.x) : 0u;
    const unsigned gmax = __reduce_max_sync(kFull, v);
    const int gl = __ffs(__ballot_sync(kFull, lane < W && v == gmax)) - 1;
    qx = __shfl_sync(kFull, a.z, gl);
    qy = __shfl_sync(kFull, a.w, gl);
    qz = __shfl_sync(kFull, az, gl);
    const float gi = __shfl_sync(kFull, a.y, gl);
    if (tid == 0) out[j] = __float_as_int(gi);
  }
}

// The cluster kernel: as fps_kernel, block r of a cloud's cluster of CB
// blocks owning points from r * T * P, their coordinates in shared memory
// planes, each block holding the partials of all CB blocks, a lane reading
// one partial of each block.
template <int T, int P, int CB>
__global__ void __launch_bounds__(T)
fps_cluster_kernel(const float* __restrict__ xyz, int N, int npoint,
                   int* __restrict__ idx) {
  constexpr int W = T / 32;
  static_assert(W <= 32, "a lane reads one partial of each block");
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  // planes x | y | z of T * P, point tid * P + t at t * T + tid
  // (conflict-free reads)
  extern __shared__ float planes[];
  __shared__ float4 part[2][CB * W];  // (value, index, x, y)
  __shared__ float part_z[2][CB * W];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int first = rank * T * P;  // this block's first point
  const int cloud = blockIdx.x / CB;
  const float* p = xyz + (size_t)cloud * N * 3;
  float mind[P];
#pragma unroll
  for (int t = 0; t < P; ++t) {
    const int i = first + tid * P + t;
    planes[t * T + tid] = i < N ? p[3 * i] : 0.0f;
    planes[(P + t) * T + tid] = i < N ? p[3 * i + 1] : 0.0f;
    planes[(2 * P + t) * T + tid] = i < N ? p[3 * i + 2] : 0.0f;
    mind[t] = i < N ? 1e10f : -1.0f;  // a slot past N stays at -1
  }
  int* out = idx + (size_t)cloud * npoint;
  const bool writer = rank == 0 && tid == 0;
  if (writer) out[0] = 0;
  float qx = p[0], qy = p[1], qz = p[2];
  // every block running (its shared memory live) and the planes written
  cluster.sync();

  for (int j = 1; j < npoint; ++j) {
    float bv = -1.0f, bx = 0.0f, by = 0.0f, bz = 0.0f;
    int bi = 0;
#pragma unroll
    for (int t = 0; t < P; ++t) {  // increasing index
      const float x = planes[t * T + tid];
      const float y = planes[(P + t) * T + tid];
      const float z = planes[(2 * P + t) * T + tid];
      const float dx = __fsub_rn(x, qx);
      const float dy = __fsub_rn(y, qy);
      const float dz = __fsub_rn(z, qz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      const float m = fminf(mind[t], d);
      mind[t] = m;
      if (m > bv) {
        bv = m;
        bi = first + tid * P + t;
        bx = x;
        by = y;
        bz = z;
      }
    }
    const unsigned vb = bv < 0.0f ? 0u : __float_as_uint(bv);
    const unsigned wmax = __reduce_max_sync(kFull, vb);
    const unsigned won = __ballot_sync(kFull, vb == wmax);
    if (lane == __ffs(won) - 1) {  // to this slot of every block's arrays
      const float4 v =
          make_float4(__uint_as_float(wmax), __int_as_float(bi), bx, by);
      const int slot = (j & 1) * CB * W + rank * W + warp;
#pragma unroll
      for (int r = 0; r < CB; ++r) {
        cluster.map_shared_rank(&part[0][0], r)[slot] = v;
        cluster.map_shared_rank(&part_z[0][0], r)[slot] = bz;
      }
    }
    cluster.sync();
    // every warp: the lowest block, then the lowest warp in it, holding the
    // max; its partial read from this block's copy by every lane
    unsigned vr[CB];
    unsigned lmax = 0u;
#pragma unroll
    for (int r = 0; r < CB; ++r) {
      vr[r] = lane < W ? __float_as_uint(part[j & 1][r * W + lane].x) : 0u;
      lmax = vr[r] > lmax ? vr[r] : lmax;
    }
    const unsigned gmax = __reduce_max_sync(kFull, lmax);
    int sel = -1;
#pragma unroll
    for (int r = 0; r < CB; ++r) {
      const unsigned hit = __ballot_sync(kFull, lane < W && vr[r] == gmax);
      if (sel < 0 && hit != 0u) sel = r * W + __ffs(hit) - 1;
    }
    const float4 a = part[j & 1][sel];
    qx = a.z;
    qy = a.w;
    qz = part_z[j & 1][sel];
    if (writer) out[j] = __float_as_int(a.y);
  }
}

// ---------------------------------------------------------------------------
// The pruned kernel: one block a cloud of any N, most of a step skipped.

constexpr int kGridBits = 4;                  // a 16^3 grid over the cloud's box
constexpr int kGrid = 1 << kGridBits;
constexpr int kCells = 1 << (3 * kGridBits);  // 4096 cells in Morton order
constexpr int kMinimaSmemMax = 200 * 1024;    // minima in shared memory up to

constexpr int kMaxBucketsPerThread = 2;
constexpr int kPrunedThreads = kMaxThreads;  // threads a cloud

struct PrunedPlan {
  int bucket;       // points a bucket, a multiple of 32
  int buckets;      // ceil(N / bucket), at most two a thread of 1024
  int n_pad;        // buckets * bucket
  int smem_minima;  // 1: the running minima in shared memory, 0: in scratch
  int smem_bytes;   // dynamic shared memory a block
  long long scratch_floats;  // scratch a cloud: the sorted points (float4),
                             // then the minima where not in shared memory
};

// Buckets of the smallest multiple of 32 points with at most two buckets a
// thread. False where it refuses (ops/fpsample.py pruned_plan is its host
// copy).
bool pruned_plan(int N, PrunedPlan* pl) {
  if (N <= 0) return false;
  const long long per = 32LL * kPrunedThreads * kMaxBucketsPerThread;
  const int S = (int)(((long long)N + per - 1) / per * 32);
  const int nb = (int)(((long long)N + S - 1) / S);
  const long long n_pad = (long long)nb * S;
  if (n_pad > INT_MAX / 4) return false;
  pl->bucket = S;
  pl->buckets = nb;
  pl->n_pad = (int)n_pad;
  pl->smem_minima = n_pad * 4 <= kMinimaSmemMax;
  const long long minima = pl->smem_minima ? n_pad * 4 : 0;
  pl->smem_bytes = (int)(minima > kCells * 4 ? minima : kCells * 4);
  pl->scratch_floats = 4 * n_pad + (pl->smem_minima ? 0 : n_pad);
  return true;
}

__device__ __forceinline__ float sq_dist(float x, float y, float z, float qx,
                                         float qy, float qz) {
  const float dx = __fsub_rn(x, qx);
  const float dy = __fsub_rn(y, qy);
  const float dz = __fsub_rn(z, qz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// The Morton cell of a point in the grid over the box from lo, sc = kGrid /
// extent a side (0 for a flat side). Only the order of the points follows
// from it, never a result, so its own rounding does not matter.
__device__ __forceinline__ int grid_cell(float x, float y, float z,
                                         float3 lo, float3 sc) {
  const int cx = min(kGrid - 1, max(0, __float2int_rz((x - lo.x) * sc.x)));
  const int cy = min(kGrid - 1, max(0, __float2int_rz((y - lo.y) * sc.y)));
  const int cz = min(kGrid - 1, max(0, __float2int_rz((z - lo.z) * sc.z)));
  int c = 0;
#pragma unroll
  for (int k = 0; k < kGridBits; ++k)
    c |= (((cx >> k) & 1) << (3 * k)) | (((cy >> k) & 1) << (3 * k + 1)) |
         (((cz >> k) & 1) << (3 * k + 2));
  return c;
}

// The lane holding the warp's largest key (h, l), compared as h, then l;
// (wh, wl) that key in every lane.
__device__ __forceinline__ int warp_argmax(unsigned h, unsigned l,
                                           unsigned& wh, unsigned& wl) {
  wh = __reduce_max_sync(kFull, h);
  const unsigned eq = __ballot_sync(kFull, h == wh);
  unsigned m = l;
  if (eq & (eq - 1)) {  // a tie of the values: the largest l among them
    if (h == wh) m = __reduce_max_sync(eq, l);
    m = __shfl_sync(kFull, m, __ffs(eq) - 1);
    wl = m;
    return __ffs(__ballot_sync(kFull, h == wh && l == m)) - 1;
  }
  const int win = __ffs(eq) - 1;
  wl = __shfl_sync(kFull, m, win);
  return win;
}

// fps_pruned_kernel: the points sorted into buckets of S (a multiple of 32)
// by Morton cell; warp w owns the buckets b = slot * W + w (slot < 32 KB),
// lane slot % 32 holding bucket b's box and best key (the largest running
// minimum in it and, among ties, the lowest original index) in its set
// slot / 32. A step updates only the buckets whose box comes nearer the
// last winner q than their best (lb < best): each warp takes its near
// buckets one pass each, one lane a point; then the block's largest key,
// as fps_kernel takes its winner (one barrier). kOne: S == 32, one point a
// lane a bucket.
template <int KB, bool kSmemMin, bool kOne>
__global__ void __launch_bounds__(kPrunedThreads, 1)
fps_pruned_kernel(const float* __restrict__ xyz, int N, int npoint, int S,
                  int nb, int* __restrict__ idx, float4* sorted_all,
                  float* mind_all) {
  constexpr int T = kPrunedThreads;
  constexpr int W = T / 32;
  constexpr int kPer = kCells / T;  // cells a thread in the prefix sum
  extern __shared__ __align__(16) unsigned char dyn[];
  unsigned* hist = reinterpret_cast<unsigned*>(dyn);  // then the minima
  __shared__ float red[6][W];
  __shared__ unsigned wsum[W];
  __shared__ uint4 part[2][W];  // (value bits, ~index, x bits, y bits)
  __shared__ float part_z[2][W];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_pad = nb * S;
  const float* p = xyz + (size_t)blockIdx.x * N * 3;
  float4* sorted = sorted_all + (size_t)blockIdx.x * n_pad;
  float* mind = kSmemMin ? reinterpret_cast<float*>(dyn)
                         : mind_all + (size_t)blockIdx.x * n_pad;

  // 1. the cloud's box
  float lo[3] = {INFINITY, INFINITY, INFINITY};
  float hi[3] = {-INFINITY, -INFINITY, -INFINITY};
  for (int i = tid; i < N; i += T) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float v = p[3 * i + k];
      lo[k] = fminf(lo[k], v);
      hi[k] = fmaxf(hi[k], v);
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    for (int o = 16; o > 0; o >>= 1) {
      lo[k] = fminf(lo[k], __shfl_xor_sync(kFull, lo[k], o));
      hi[k] = fmaxf(hi[k], __shfl_xor_sync(kFull, hi[k], o));
    }
    if (lane == 0) {
      red[k][warp] = lo[k];
      red[3 + k][warp] = hi[k];
    }
  }
  for (int c = tid; c < kCells; c += T) hist[c] = 0u;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    for (int w = 0; w < W; ++w) {
      lo[k] = fminf(lo[k], red[k][w]);
      hi[k] = fmaxf(hi[k], red[3 + k][w]);
    }
  }
  const float3 blo = make_float3(lo[0], lo[1], lo[2]);
  const float3 sc = make_float3(hi[0] > lo[0] ? kGrid / (hi[0] - lo[0]) : 0.f,
                                hi[1] > lo[1] ? kGrid / (hi[1] - lo[1]) : 0.f,
                                hi[2] > lo[2] ? kGrid / (hi[2] - lo[2]) : 0.f);

  // 2. points a cell, then each cell's first slot (prefix sums in Morton
  // order)
  for (int i = tid; i < N; i += T)
    atomicAdd(&hist[grid_cell(p[3 * i], p[3 * i + 1], p[3 * i + 2], blo, sc)],
              1u);
  __syncthreads();
  unsigned own[kPer];
  unsigned run = 0u;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    own[k] = hist[tid * kPer + k];
    run += own[k];
  }
  unsigned incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const unsigned v = lane < W ? wsum[lane] : 0u;
    unsigned s = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned u = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += u;
    }
    if (lane < W) wsum[lane] = s - v;
  }
  __syncthreads();
  unsigned start = wsum[warp] + incl - run;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    hist[tid * kPer + k] = start;
    start += own[k];
  }
  __syncthreads();

  // 3. the points in cell order with their indices; the last bucket's
  // slots past N are padding, whose minimum stays -1. Written and read by
  // this block alone: plain loads after the barrier, cached in L1
  for (int i = tid; i < N; i += T) {
    const float x = p[3 * i], y = p[3 * i + 1], z = p[3 * i + 2];
    const unsigned pos = atomicAdd(&hist[grid_cell(x, y, z, blo, sc)], 1u);
    sorted[pos] = make_float4(x, y, z, __int_as_float(i));
  }
  for (int s = N + tid; s < n_pad; s += T)
    sorted[s] = make_float4(0.f, 0.f, 0.f, __int_as_float(-1));
  __syncthreads();

  // 4. the minima, and each bucket's box and best key (1e10, its lowest
  // index)
  for (int s = tid; s < n_pad; s += T) mind[s] = s < N ? 1e10f : -1.0f;
  bool has[KB];
  float b0[KB], b1[KB], b2[KB], h0[KB], h1[KB], h2[KB];
  float kv[KB], bx[KB], by[KB], bz[KB];
  unsigned kl[KB];  // ~ the best's index
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    const int b = (k * 32 + lane) * W + warp;
    has[k] = b < nb;
    b0[k] = b1[k] = b2[k] = INFINITY;
    h0[k] = h1[k] = h2[k] = -INFINITY;
    kv[k] = 1e10f;
    bx[k] = by[k] = bz[k] = 0.f;
    int ki = INT_MAX;
    const int end = has[k] ? min(N, b * S + S) : 0;
    for (int s = b * S; s < end; ++s) {
      const float4 pt = sorted[s];
      b0[k] = fminf(b0[k], pt.x);
      b1[k] = fminf(b1[k], pt.y);
      b2[k] = fminf(b2[k], pt.z);
      h0[k] = fmaxf(h0[k], pt.x);
      h1[k] = fmaxf(h1[k], pt.y);
      h2[k] = fmaxf(h2[k], pt.z);
      const int i = __float_as_int(pt.w);
      if (i < ki) {
        ki = i;
        bx[k] = pt.x;
        by[k] = pt.y;
        bz[k] = pt.z;
      }
    }
    kl[k] = has[k] ? ~(unsigned)ki : 0u;
  }
  int* out = idx + (size_t)blockIdx.x * npoint;
  if (tid == 0) out[0] = 0;
  float qx = p[0], qy = p[1], qz = p[2];
  __syncthreads();

  const int chunks = kOne ? 1 : S / 32;
  for (int j = 1; j < npoint; ++j) {
    // a. the buckets whose box comes nearer q than their best: lb is d at
    // q clamped to the box, rounded as d, so lb <= d of every point in it
    unsigned long long todo = 0ull;
#pragma unroll
    for (int k = 0; k < KB; ++k) {
      const bool near =
          has[k] && sq_dist(fminf(fmaxf(qx, b0[k]), h0[k]),
                            fminf(fmaxf(qy, b1[k]), h1[k]),
                            fminf(fmaxf(qz, b2[k]), h2[k]), qx, qy, qz) < kv[k];
      todo |= (unsigned long long)__ballot_sync(kFull, near) << (32 * k);
    }
    // b. the warp's near buckets, one pass of the warp each, one lane a
    // point (loading four buckets' points together was slower: the
    // registers spill at 1024 threads, PERF.md)
    while (todo) {
      const int sl = __ffsll(todo) - 1;
      todo &= todo - 1;
      const int base = (sl * W + warp) * S;
      unsigned vh = 0u, vl = 0u;
      float ex = 0.f, ey = 0.f, ez = 0.f;
      for (int c = 0; c < chunks; ++c) {
        const int t = base + c * 32 + lane;
        const float4 pt = sorted[t];
        const float m = fminf(mind[t], sq_dist(pt.x, pt.y, pt.z, qx, qy, qz));
        mind[t] = m;
        if (m >= 0.0f) {  // not padding
          const unsigned h = __float_as_uint(m);
          const unsigned l = ~(unsigned)__float_as_int(pt.w);
          if (h > vh || (h == vh && l > vl)) {
            vh = h;
            vl = l;
            ex = pt.x;
            ey = pt.y;
            ez = pt.z;
          }
        }
      }
      unsigned wh, wl;
      const int win = warp_argmax(vh, vl, wh, wl);
      const float wx = __shfl_sync(kFull, ex, win);
      const float wy = __shfl_sync(kFull, ey, win);
      const float wz = __shfl_sync(kFull, ez, win);
      if (lane == (sl & 31)) {
#pragma unroll
        for (int k = 0; k < KB; ++k) {
          if (k == (sl >> 5)) {
            kv[k] = __uint_as_float(wh);
            kl[k] = wl;
            bx[k] = wx;
            by[k] = wy;
            bz[k] = wz;
          }
        }
      }
    }
    // c. the block's largest key: each thread's, each warp's to a partial
    // array by step parity, one barrier, then every warp reduces them
    unsigned th = has[0] ? __float_as_uint(kv[0]) : 0u, tl = kl[0];
    float tx = bx[0], ty = by[0], tz = bz[0];
#pragma unroll
    for (int k = 1; k < KB; ++k) {
      const unsigned h = has[k] ? __float_as_uint(kv[k]) : 0u;
      if (h > th || (h == th && kl[k] > tl)) {
        th = h;
        tl = kl[k];
        tx = bx[k];
        ty = by[k];
        tz = bz[k];
      }
    }
    unsigned wh, wl;
    const int win = warp_argmax(th, tl, wh, wl);
    if (lane == win) {
      part[j & 1][warp] =
          make_uint4(wh, wl, __float_as_uint(tx), __float_as_uint(ty));
      part_z[j & 1][warp] = tz;
    }
    __syncthreads();
    uint4 a = make_uint4(0u, 0u, 0u, 0u);
    float az = 0.f;
    if (lane < W) {
      a = part[j & 1][lane];
      az = part_z[j & 1][lane];
    }
    unsigned gh, gl;
    const int g = warp_argmax(a.x, a.y, gh, gl);
    qx = __uint_as_float(__shfl_sync(kFull, a.z, g));
    qy = __uint_as_float(__shfl_sync(kFull, a.w, g));
    qz = __shfl_sync(kFull, az, g);
    if (tid == 0) out[j] = (int)~gl;
  }
}

template <int KB, bool kSmemMin, bool kOne>
cudaError_t launch_pruned(const float* xyz, int B, int N, int npoint,
                          const PrunedPlan& pl, int* idx, float* scratch,
                          cudaStream_t stream) {
  const auto kernel = fps_pruned_kernel<KB, kSmemMin, kOne>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem_bytes);
  if (e != cudaSuccess) return e;
  // the rest of the SM's 256 KB to L1, which caches the sorted points
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxL1);
  if (e != cudaSuccess) return e;
  float4* sorted = reinterpret_cast<float4*>(scratch);
  float* mind = scratch + (size_t)B * pl.n_pad * 4;
  kernel<<<B, kPrunedThreads, pl.smem_bytes, stream>>>(
      xyz, N, npoint, pl.bucket, pl.buckets, idx, sorted, mind);
  return cudaGetLastError();
}

template <int T, int P>
cudaError_t launch(const float* xyz, int B, int N, int npoint, int* idx,
                   cudaStream_t stream) {
  fps_kernel<T, P><<<B, T, 0, stream>>>(xyz, N, npoint, idx);
  return cudaGetLastError();
}

template <int P, int CB>
cudaError_t launch_cluster(const float* xyz, int B, int N, int npoint,
                           int* idx, cudaStream_t stream) {
  constexpr int T = kMaxThreads;
  const size_t smem = (size_t)3 * T * P * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      fps_cluster_kernel<T, P, CB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CB * B);
  cfg.blockDim = dim3(T);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CB;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, fps_cluster_kernel<T, P, CB>, xyz, N, npoint,
                         idx);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// xyz (B, N, 3) f32 contiguous -> idx (B, npoint) i32 with T threads a cloud
// and P points a thread, T * P >= N: the chain kernel's instances fps_tiling
// picks, 512 threads of 1, 2 or 4 points (N <= 2048) and 1024 of 4
// (N <= 4096), and the cluster instance timed beside the pruned kernel, 4096
// threads of 6 (a cluster of four blocks of 1024, N <= 24576). Returns
// cudaError_t.
int fps_launch(const float* xyz, int B, int N, int npoint, int T, int P,
               int* idx, cudaStream_t stream) {
  if (B <= 0 || N <= 0 || npoint <= 0 || (long long)T * P < N)
    return cudaErrorInvalidValue;
  switch (T * 100 + P) {
    case 51201: return launch<512, 1>(xyz, B, N, npoint, idx, stream);
    case 51202: return launch<512, 2>(xyz, B, N, npoint, idx, stream);
    case 51204: return launch<512, 4>(xyz, B, N, npoint, idx, stream);
    case 102404: return launch<1024, 4>(xyz, B, N, npoint, idx, stream);
    case 409606: return launch_cluster<6, 4>(xyz, B, N, npoint, idx, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The pruned kernel's plan for N points into out[6]: bucket, buckets, n_pad,
// minima in shared memory (1) or scratch (0), dynamic shared memory bytes,
// scratch floats a cloud. Returns cudaError_t.
int fps_pruned_plan(int N, long long* out) {
  PrunedPlan pl;
  if (!pruned_plan(N, &pl)) return cudaErrorInvalidValue;
  out[0] = pl.bucket;
  out[1] = pl.buckets;
  out[2] = pl.n_pad;
  out[3] = pl.smem_minima;
  out[4] = pl.smem_bytes;
  out[5] = pl.scratch_floats;
  return cudaSuccess;
}

// xyz (B, N, 3) f32 contiguous -> idx (B, npoint) i32 by the pruned kernel;
// scratch holds B * fps_pruned_plan(N)[5] floats, 16-byte aligned. One
// launch, on one of four instances by the plan: one or two buckets a thread,
// the minima in shared memory or the scratch, buckets of 32 or more points.
// Returns cudaError_t.
int fps_pruned_launch(const float* xyz, int B, int N, int npoint, int* idx,
                      float* scratch, cudaStream_t stream) {
  PrunedPlan pl;
  if (B <= 0 || npoint <= 0 || !pruned_plan(N, &pl))
    return cudaErrorInvalidValue;
  if (pl.buckets <= kPrunedThreads)  // N <= 32768: S = 32, minima in smem
    return launch_pruned<1, true, true>(xyz, B, N, npoint, pl, idx, scratch,
                                        stream);
  if (pl.smem_minima)
    return launch_pruned<2, true, true>(xyz, B, N, npoint, pl, idx, scratch,
                                        stream);
  return pl.bucket == 32
             ? launch_pruned<2, false, true>(xyz, B, N, npoint, pl, idx,
                                             scratch, stream)
             : launch_pruned<2, false, false>(xyz, B, N, npoint, pl, idx,
                                              scratch, stream);
}

const char* apt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
