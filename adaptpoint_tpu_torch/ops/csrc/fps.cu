// Furthest point sampling for Hopper (sm_90a).
//
// Replaces the TPU kernel adaptpoint_tpu/ops/pallas/fps.py
// (furthest_point_sample_pallas, _fps_kernel). Same function as the plain
// version ops/geometry.py furthest_point_sample: the first index is 0, the
// running min-distance starts at 1e10, and each step takes the first index of
// the maximum.
//
// Design: one block per cloud. The cloud sits in shared memory as three
// planes x[N], y[N], z[N] (12 KB at N=1024); each thread keeps the running
// min of its P = ceil(N / 512) points in registers. Every one of the
// npoint-1 steps updates those minima and reduces (value, -index) over the
// block: a shuffle reduction in each warp, then one over the 16 warp results.
//
// What bounds it: latency, not bytes or operations. The steps depend on each
// other, each is a block-wide reduction with two barriers, and only B of the
// card's 132 SMs have work (B=32 on the serving path). Making it faster
// (several clouds per SM, fewer barriers per step) is later work.
//
// Arithmetic: d = (dx*dx + dy*dy) + dz*dz with every product and sum rounded
// on its own (__fmul_rn/__fadd_rn, and the file builds with -fmad=false), so
// the distances and therefore the argmax ties equal the plain version's.
#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ void better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

template <int P>
__global__ void __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ xyz, int N, int npoint,
           int* __restrict__ idx) {
  extern __shared__ float planes[];  // x[N] | y[N] | z[N]
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int sel;
  float* xs = planes;
  float* ys = planes + N;
  float* zs = planes + 2 * N;
  const float* p = xyz + (size_t)blockIdx.x * N * 3;
  for (int i = threadIdx.x; i < N; i += kThreads) {
    xs[i] = p[3 * i];
    ys[i] = p[3 * i + 1];
    zs[i] = p[3 * i + 2];
  }
  float mind[P];
#pragma unroll
  for (int t = 0; t < P; ++t) mind[t] = 1e10f;
  int* out = idx + (size_t)blockIdx.x * npoint;
  if (threadIdx.x == 0) out[0] = 0;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int last = 0;
  __syncthreads();

  for (int j = 1; j < npoint; ++j) {
    const float qx = xs[last], qy = ys[last], qz = zs[last];
    float bv = -1.0f;
    int bi = INT_MAX;
#pragma unroll
    for (int t = 0; t < P; ++t) {
      const int i = threadIdx.x + t * kThreads;  // increasing in t
      if (i < N) {
        const float dx = __fsub_rn(xs[i], qx);
        const float dy = __fsub_rn(ys[i], qy);
        const float dz = __fsub_rn(zs[i], qz);
        const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                  __fmul_rn(dz, dz));
        const float m = fminf(mind[t], d);
        mind[t] = m;
        if (m > bv) {  // strict: the first index of a tie stays
          bv = m;
          bi = i;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      better(bv, bi, ov, oi);
    }
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < kWarps ? red_v[lane] : -1.0f;
      bi = lane < kWarps ? red_i[lane] : INT_MAX;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        better(bv, bi, ov, oi);
      }
      if (lane == 0) {
        sel = bi;
        out[j] = bi;
      }
    }
    __syncthreads();
    last = sel;
  }
}

template <int P>
cudaError_t launch(const float* xyz, int B, int N, int npoint, int* idx,
                   cudaStream_t stream) {
  const size_t smem = (size_t)3 * N * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      fps_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  fps_kernel<P><<<B, kThreads, smem, stream>>>(xyz, N, npoint, idx);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest N the kernel takes (P = 32 points a thread, 192 KB of planes).
int fps_max_points() { return 32 * kThreads; }

// xyz (B, N, 3) f32 contiguous -> idx (B, npoint) i32. Returns cudaError_t.
int fps_launch(const float* xyz, int B, int N, int npoint, int* idx,
               cudaStream_t stream) {
  if (B <= 0 || N <= 0 || npoint <= 0) return cudaErrorInvalidValue;
  const int P = (N + kThreads - 1) / kThreads;
  if (P <= 1) return launch<1>(xyz, B, N, npoint, idx, stream);
  if (P <= 2) return launch<2>(xyz, B, N, npoint, idx, stream);
  if (P <= 4) return launch<4>(xyz, B, N, npoint, idx, stream);
  if (P <= 8) return launch<8>(xyz, B, N, npoint, idx, stream);
  if (P <= 16) return launch<16>(xyz, B, N, npoint, idx, stream);
  if (P <= 32) return launch<32>(xyz, B, N, npoint, idx, stream);
  return cudaErrorInvalidValue;
}

const char* apt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
