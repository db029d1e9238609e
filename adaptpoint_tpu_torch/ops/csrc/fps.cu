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
// Design: one block a cloud, T = 512 threads up to N = 2048, else 1024 (the
// wrapper picks T and P by N, ops/fpsample.py fps_tiling). Thread t owns
// the P consecutive points tP .. tP + P - 1, their coordinates in registers
// (in shared memory for P > 4, N up to 16384) and their running minima in
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
// Past 16384 points (fps_cluster_kernel, N up to 32768): the coordinates of
// a cloud no longer fit one block's shared memory (3 * 4 B * N: 288 KB at
// N = 24000 against 227 KB) and the minima no longer fit its registers (64 a
// thread at 1024 threads), and reading the cloud from L2 every step would move
// npoint * 12 N bytes through one SM. So a cloud takes a thread-block cluster
// of CB blocks of 1024 threads on CB SMs, block r owning the points
// r * 1024 P .. (r + 1) * 1024 P - 1, each holding its share exactly as the
// one-block kernel holds a cloud (coordinates in registers for P <= 4). In
// step 2 the winning lane writes its warp's partial to its slot r * 32 + warp
// of the partial arrays of every block of the cluster (its own and, through
// distributed shared memory, the others'); step 3 is a cluster barrier
// (arrive.release / wait.acquire) in place of __syncthreads; in step 4 each
// lane reads one partial of each block, and the winner is the lowest warp of
// the lowest block holding the maximum (lower blocks own lower points), its
// partial read from the block's own copy by every lane. The parity argument
// above holds across the blocks, since the cluster barrier waits for all.
// So each step has one barrier, as in one block, and 1 / CB of the distance
// work of a 1024-thread block holding the cloud. fps_tiling takes CB = 4
// (P = 6 up to N = 24576, else 8): at B = 8 on the H100 (700 W) a step took
// 2043 ns (CB = 2, P = 12), 1873 (CB = 4, P = 6) and 2546 (CB = 8, P = 3) at
// N = 24000, 2314 (2, 16), 2047 (4, 8) and 2593 (8, 4) at N = 32768, against
// 1686 ns for one block at N = 16384: the cluster barrier, not the distance
// work, sets a step. The other cluster instances stay compiled for timing
// (fpsample.FPS_CLUSTER_DESIGNS).
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

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 1024;
constexpr int kMaxRegPerThread = 4;  // coordinates in registers up to here
// the largest N: a cluster of four blocks of 1024 threads of 8 points
constexpr int kMaxPoints = 4 * 1024 * 8;

template <int T, int P>
__global__ void __launch_bounds__(T)
fps_kernel(const float* __restrict__ xyz, int N, int npoint,
           int* __restrict__ idx) {
  constexpr int W = T / 32;
  constexpr bool kSmem = P > kMaxRegPerThread;
  constexpr int PR = kSmem ? 1 : P;  // coordinates held in registers
  // kSmem: planes x | y | z of T * P, point tid * P + t at t * T + tid
  // (conflict-free reads)
  extern __shared__ float planes[];
  __shared__ float4 part[2][W];  // (value, index, x, y) of each warp
  __shared__ float part_z[2][W];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* p = xyz + (size_t)blockIdx.x * N * 3;
  float px[PR], py[PR], pz[PR], mind[P];
#pragma unroll
  for (int t = 0; t < P; ++t) {
    const int i = tid * P + t;
    const float x = i < N ? p[3 * i] : 0.0f;
    const float y = i < N ? p[3 * i + 1] : 0.0f;
    const float z = i < N ? p[3 * i + 2] : 0.0f;
    mind[t] = i < N ? 1e10f : -1.0f;  // a slot past N stays at -1
    if (kSmem) {
      planes[t * T + tid] = x;
      planes[(P + t) * T + tid] = y;
      planes[(2 * P + t) * T + tid] = z;
    } else {
      px[t % PR] = x;
      py[t % PR] = y;
      pz[t % PR] = z;
    }
  }
  int* out = idx + (size_t)blockIdx.x * npoint;
  if (tid == 0) out[0] = 0;
  float qx = p[0], qy = p[1], qz = p[2];
  if (kSmem) __syncthreads();

  for (int j = 1; j < npoint; ++j) {
    float bv = -1.0f, bx = 0.0f, by = 0.0f, bz = 0.0f;
    int bi = 0;
#pragma unroll
    for (int t = 0; t < P; ++t) {  // increasing index
      const float x = kSmem ? planes[t * T + tid] : px[t % PR];
      const float y = kSmem ? planes[(P + t) * T + tid] : py[t % PR];
      const float z = kSmem ? planes[(2 * P + t) * T + tid] : pz[t % PR];
      const float dx = __fsub_rn(x, qx);
      const float dy = __fsub_rn(y, qy);
      const float dz = __fsub_rn(z, qz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      const float m = fminf(mind[t], d);  // -1 past N
      mind[t] = m;
      if (m > bv) {  // strict: the first index of a tie stays
        bv = m;
        bi = tid * P + t;
        bx = x;
        by = y;
        bz = z;
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
// blocks owning points from r * T * P, each block holding the partials of
// all CB blocks, a lane reading one partial of each block.
template <int T, int P, int CB>
__global__ void __launch_bounds__(T)
fps_cluster_kernel(const float* __restrict__ xyz, int N, int npoint,
                   int* __restrict__ idx) {
  constexpr int W = T / 32;
  static_assert(W <= 32, "a lane reads one partial of each block");
  constexpr bool kSmem = P > kMaxRegPerThread;
  constexpr int PR = kSmem ? 1 : P;  // coordinates held in registers
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  extern __shared__ float planes[];  // kSmem: x | y | z, as fps_kernel
  __shared__ float4 part[2][CB * W];  // (value, index, x, y)
  __shared__ float part_z[2][CB * W];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int first = rank * T * P;  // this block's first point
  const int cloud = blockIdx.x / CB;
  const float* p = xyz + (size_t)cloud * N * 3;
  float px[PR], py[PR], pz[PR], mind[P];
#pragma unroll
  for (int t = 0; t < P; ++t) {
    const int i = first + tid * P + t;
    const float x = i < N ? p[3 * i] : 0.0f;
    const float y = i < N ? p[3 * i + 1] : 0.0f;
    const float z = i < N ? p[3 * i + 2] : 0.0f;
    mind[t] = i < N ? 1e10f : -1.0f;  // a slot past N stays at -1
    if (kSmem) {
      planes[t * T + tid] = x;
      planes[(P + t) * T + tid] = y;
      planes[(2 * P + t) * T + tid] = z;
    } else {
      px[t % PR] = x;
      py[t % PR] = y;
      pz[t % PR] = z;
    }
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
      const float x = kSmem ? planes[t * T + tid] : px[t % PR];
      const float y = kSmem ? planes[(P + t) * T + tid] : py[t % PR];
      const float z = kSmem ? planes[(2 * P + t) * T + tid] : pz[t % PR];
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

template <int T, int P>
cudaError_t launch(const float* xyz, int B, int N, int npoint, int* idx,
                   cudaStream_t stream) {
  const size_t smem =
      P > kMaxRegPerThread ? (size_t)3 * T * P * sizeof(float) : 0;
  cudaError_t e = cudaFuncSetAttribute(
      fps_kernel<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  fps_kernel<T, P><<<B, T, smem, stream>>>(xyz, N, npoint, idx);
  return cudaGetLastError();
}

template <int P, int CB>
cudaError_t launch_cluster(const float* xyz, int B, int N, int npoint,
                           int* idx, cudaStream_t stream) {
  constexpr int T = kMaxThreads;
  const size_t smem =
      P > kMaxRegPerThread ? (size_t)3 * T * P * sizeof(float) : 0;
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

// Largest N the kernels take: a cluster of four blocks of 1024 threads of 8
// points, 96 KB of planes each (one block: 16 points a thread of 1024, 192
// KB of planes, N <= 16384).
int fps_max_points() { return kMaxPoints; }

// xyz (B, N, 3) f32 contiguous -> idx (B, npoint) i32 with T threads a cloud
// and P points a thread, T * P >= N: the instances fps_tiling picks, 512
// threads of 1, 2 or 4 points (N <= 2048), 1024 of 4, 8 or 16 (one block,
// N <= 16384) and 4096 of 6 or 8 (a cluster of four blocks of 1024,
// N <= 32768); and for timing, clusters of two blocks (2048 threads of 12 or
// 16 points) and of eight (8192 of 3 or 4). Returns cudaError_t.
int fps_launch(const float* xyz, int B, int N, int npoint, int T, int P,
               int* idx, cudaStream_t stream) {
  if (B <= 0 || N <= 0 || npoint <= 0 || (long long)T * P < N)
    return cudaErrorInvalidValue;
  switch (T * 100 + P) {
    case 51201: return launch<512, 1>(xyz, B, N, npoint, idx, stream);
    case 51202: return launch<512, 2>(xyz, B, N, npoint, idx, stream);
    case 51204: return launch<512, 4>(xyz, B, N, npoint, idx, stream);
    case 102404: return launch<1024, 4>(xyz, B, N, npoint, idx, stream);
    case 102408: return launch<1024, 8>(xyz, B, N, npoint, idx, stream);
    case 102416: return launch<1024, 16>(xyz, B, N, npoint, idx, stream);
    case 204812: return launch_cluster<12, 2>(xyz, B, N, npoint, idx, stream);
    case 204816: return launch_cluster<16, 2>(xyz, B, N, npoint, idx, stream);
    case 409606: return launch_cluster<6, 4>(xyz, B, N, npoint, idx, stream);
    case 409608: return launch_cluster<8, 4>(xyz, B, N, npoint, idx, stream);
    case 819203: return launch_cluster<3, 8>(xyz, B, N, npoint, idx, stream);
    case 819204: return launch_cluster<4, 8>(xyz, B, N, npoint, idx, stream);
    default: return cudaErrorInvalidValue;
  }
}

const char* apt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
