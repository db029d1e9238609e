// 3-NN weighted gather of the feature-propagation decode for Hopper
// (sm_90a), forward and backward.
//
// Replaces the TPU kernels adaptpoint_tpu/ops/pallas/fpinterp.py _call_fwd
// (_fwd_kernel, with _build_woh) and _bwd (_bwd_kernel): the weighted sum of
// three bf16 feature rows per output row, with the TPU kernel's rounding.
// Same function as the plain versions in ops/fpinterp.py. Per output row
// (b, n), with neighbours i0, i1, i2 and f32 weights w0, w1, w2:
//   merged weights, duplicates summed in the TPU kernel's order (its
//   weighted one-hot is 0 + w0 at i0, then + w1 at i1, then + w2 at i2):
//     W0 = (w0 + [i1 == i0] w1) + [i2 == i0] w2
//     W1 = [i1 != i0] (w1 + [i2 == i1] w2)
//     W2 = [i2 != i0 and i2 != i1] w2
//   the two-way bf16 split hi_j = bf16(W_j), lo_j = bf16(W_j - hi_j);
//   out[c] = ((hi0 f0 + hi1 f1) + hi2 f2) + ((lo0 f0 + lo1 f1) + lo2 f2)
//   with f_j = feat[b, i_j, c] (bf16). Every product of two bf16 values is
//   exact in f32, and the sums are taken in this fixed order with
//   __fadd_rn (no contraction, -fmad=false), so the kernel and the plain
//   version agree bit for bit.
// Backward, with the f32 cotangent g rounded to bf16 once (gb):
//   d_feat[b, i_j, c] += hi_j gb + lo_j gb    (each distinct neighbour once,
//                        f32 sums, rounded to bf16 once at the end)
//   d_w[b, n, j]       = sum_c gb[c] feat[b, i_j, c]   (a duplicate slot gets
//                        the whole sum too, as the TPU kernel's masked dW)
//
// Design: the TPU kernel multiplies a (TM, M) weighted one-hot into the
// (M, C) features on its matrix unit; here each output row reads its three
// rows directly, a third of the one-hot's reads and none of its FLOPs. One
// warp per output row, its lanes over the channels (c = lane, lane + 32,
// ...): the bf16 feature reads and the f32 output writes are coalesced.
// Each lane builds the row's merged weights itself from the row's six
// numbers (a broadcast read). The backward's warp reads the row's
// cotangent once, scatters the weighted terms with atomicAdd into an f32
// buffer the launch zeroes first, and, when d_w is asked for, keeps three
// per-lane partial sums that a shuffle reduction finishes. A second kernel
// rounds the f32 buffer to bf16. A cloud's features (256 KB at every level
// of the augmentor's decode at B = 32) stay in L2 while its rows read them.
//
// What bounds it: bytes. Forward: feat read once, idx and w, out (B, N, C)
// f32 written once: about 171 MB over the decode's four levels at B = 32,
// N = 2048. Backward: g read once, feat, idx and w, d_feat written once.
// The atomic adds land in no fixed order: d_feat's f32 sums can differ from
// the plain version's in their last bits (and so, on a rounding boundary,
// by one bf16 ulp), and from run to run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The row's neighbours, the duplicate flags and the split merged weights.
struct RowWeights {
  int i[3];
  bool first[3];  // slot j holds the first occurrence of its index
  float hi[3], lo[3];
};

__device__ __forceinline__ RowWeights row_weights(const int* __restrict__ idx,
                                                  const float* __restrict__ w,
                                                  long long row) {
  RowWeights r;
  const int i0 = idx[row * 3], i1 = idx[row * 3 + 1], i2 = idx[row * 3 + 2];
  const float w0 = w[row * 3], w1 = w[row * 3 + 1], w2 = w[row * 3 + 2];
  float W[3];
  W[0] = __fadd_rn(__fadd_rn(w0, i1 == i0 ? w1 : 0.f), i2 == i0 ? w2 : 0.f);
  W[1] = i1 == i0 ? 0.f : __fadd_rn(w1, i2 == i1 ? w2 : 0.f);
  W[2] = (i2 == i0 || i2 == i1) ? 0.f : w2;
  r.i[0] = i0;
  r.i[1] = i1;
  r.i[2] = i2;
  r.first[0] = true;
  r.first[1] = i1 != i0;
  r.first[2] = i2 != i0 && i2 != i1;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    r.hi[j] = bf16r(W[j]);
    r.lo[j] = bf16r(__fsub_rn(W[j], r.hi[j]));
  }
  return r;
}

__global__ void __launch_bounds__(kWarps * 32)
fpinterp_fwd_kernel(const __nv_bfloat16* __restrict__ feat,
                    const int* __restrict__ idx, const float* __restrict__ w,
                    int M, int N, int C, long long rows,
                    float* __restrict__ out) {
  const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const long long b = row / N;
  const RowWeights r = row_weights(idx, w, row);
  const __nv_bfloat16* f0 = feat + ((size_t)b * M + r.i[0]) * C;
  const __nv_bfloat16* f1 = feat + ((size_t)b * M + r.i[1]) * C;
  const __nv_bfloat16* f2 = feat + ((size_t)b * M + r.i[2]) * C;
  float* o = out + (size_t)row * C;
  for (int c = lane; c < C; c += 32) {
    const float a0 = __bfloat162float(f0[c]);
    const float a1 = __bfloat162float(f1[c]);
    const float a2 = __bfloat162float(f2[c]);
    const float s_hi = __fadd_rn(__fadd_rn(__fmul_rn(r.hi[0], a0),
                                           __fmul_rn(r.hi[1], a1)),
                                 __fmul_rn(r.hi[2], a2));
    const float s_lo = __fadd_rn(__fadd_rn(__fmul_rn(r.lo[0], a0),
                                           __fmul_rn(r.lo[1], a1)),
                                 __fmul_rn(r.lo[2], a2));
    o[c] = __fadd_rn(s_hi, s_lo);
  }
}

__global__ void __launch_bounds__(kWarps * 32)
fpinterp_bwd_kernel(const __nv_bfloat16* __restrict__ feat,
                    const int* __restrict__ idx, const float* __restrict__ w,
                    const float* __restrict__ g, int M, int N, int C,
                    long long rows, float* __restrict__ acc,
                    float* __restrict__ d_w) {
  const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const long long b = row / N;
  const RowWeights r = row_weights(idx, w, row);
  const float* gr = g + (size_t)row * C;
  float part[3] = {0.f, 0.f, 0.f};
  for (int c = lane; c < C; c += 32) {
    const float gb = bf16r(gr[c]);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const size_t at = ((size_t)b * M + r.i[j]) * C + c;
      if (acc != nullptr && r.first[j]) {
        atomicAdd(acc + at, __fadd_rn(__fmul_rn(r.hi[j], gb),
                                      __fmul_rn(r.lo[j], gb)));
      }
      if (d_w != nullptr) {
        part[j] = __fadd_rn(part[j],
                            __fmul_rn(gb, __bfloat162float(feat[at])));
      }
    }
  }
  if (d_w == nullptr) return;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      part[j] = __fadd_rn(part[j], __shfl_xor_sync(0xffffffffu, part[j], s));
    }
  }
  if (lane == 0) {
    d_w[row * 3] = part[0];
    d_w[row * 3 + 1] = part[1];
    d_w[row * 3 + 2] = part[2];
  }
}

__global__ void __launch_bounds__(256)
round_to_bf16_kernel(const float* __restrict__ acc, long long total,
                     __nv_bfloat16* __restrict__ out) {
  const long long e = (long long)blockIdx.x * 256 + threadIdx.x;
  if (e < total) out[e] = __float2bfloat16_rn(acc[e]);
}

inline int row_blocks(long long rows) {
  return (int)((rows + kWarps - 1) / kWarps);
}

}  // namespace

extern "C" {

// feat (B,M,C) bf16, idx (B,N,3) i32 in [0, M), w (B,N,3) f32 ->
// out (B,N,C) f32, all contiguous. Returns cudaError_t.
int weighted_gather3_launch(const void* feat, const int* idx, const float* w,
                            int B, int M, int N, int C, float* out,
                            cudaStream_t stream) {
  if (B <= 0 || M <= 0 || N <= 0 || C <= 0) return cudaErrorInvalidValue;
  const long long rows = (long long)B * N;
  fpinterp_fwd_kernel<<<row_blocks(rows), kWarps * 32, 0, stream>>>(
      (const __nv_bfloat16*)feat, idx, w, M, N, C, rows, out);
  return cudaGetLastError();
}

// The backward with the f32 cotangent g (B,N,C). d_feat (B,M,C) bf16 needs
// the f32 scratch acc (B,M,C), zeroed here on the stream; d_w (B,N,3) f32.
// Either output may be null (not asked for).
int weighted_gather3_bwd_launch(const void* feat, const int* idx,
                                const float* w, const float* g, int B, int M,
                                int N, int C, float* acc, void* d_feat,
                                float* d_w, cudaStream_t stream) {
  if (B <= 0 || M <= 0 || N <= 0 || C <= 0) return cudaErrorInvalidValue;
  if ((acc == nullptr) != (d_feat == nullptr)) return cudaErrorInvalidValue;
  if (acc == nullptr && d_w == nullptr) return cudaSuccess;
  const long long rows = (long long)B * N;
  const long long total = (long long)B * M * C;
  if (acc != nullptr) {
    cudaError_t e = cudaMemsetAsync(acc, 0, (size_t)total * sizeof(float),
                                    stream);
    if (e != cudaSuccess) return e;
  }
  fpinterp_bwd_kernel<<<row_blocks(rows), kWarps * 32, 0, stream>>>(
      (const __nv_bfloat16*)feat, idx, w, g, M, N, C, rows, acc, d_w);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || acc == nullptr) return e;
  round_to_bf16_kernel<<<(int)((total + 255) / 256), 256, 0, stream>>>(
      acc, total, (__nv_bfloat16*)d_feat);
  return cudaGetLastError();
}

const char* apt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
