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
#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 1024;
constexpr int kMaxPerThread = 16;
constexpr int kMaxRegPerThread = 4;  // coordinates in registers up to here

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

}  // namespace

extern "C" {

// Largest N the kernel takes (16 points a thread of 1024, 192 KB of planes).
int fps_max_points() { return kMaxPerThread * kMaxThreads; }

// xyz (B, N, 3) f32 contiguous -> idx (B, npoint) i32 with T threads a cloud
// and P points a thread, T * P >= N: the instances fps_tiling picks, 512
// threads of 1, 2 or 4 points (N <= 2048) and 1024 of 4, 8 or 16.
// Returns cudaError_t.
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
    default: return cudaErrorInvalidValue;
  }
}

const char* apt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
