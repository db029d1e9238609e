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
// numbers (a broadcast read). A cloud's features (256 KB at every level of
// the augmentor's decode at B = 32) stay in L2 while its rows read them.
// The backward's d_feat is one launch of scatter_rows.cuh with FpOp: slot
// (n, j) of a cloud names row i_j, is kept where it holds the first
// occurrence of its index, and adds hi_j gb + lo_j gb of source row n. A
// block lists its rows' sources in ascending n with their packed weights,
// then sums each row in f32 and rounds it to bf16 once at its one store:
// from a 128-channel slice of the cloud's cotangent staged in shared memory
// as bf16 where that fits ("staged": the decode's first level), else
// streaming the source rows ("ordered"). No memset, no scratch, the same
// bits from run to run. d_w, asked for only when the weights need a
// gradient (the GAN step does not), is a pass of its own: a warp a row,
// three per-lane partial sums finished by a shuffle reduction.
//
// What bounds it: bytes. Forward: feat read once, idx and w, out (B, N, C)
// f32 written once: about 171 MB over the decode's four levels at B = 32,
// N = 2048. Backward: g read once, idx and w, d_feat written once (and
// feat read once for d_w).
#include "scatter_rows.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;

using apt_scatter::bf16r;

// The row's neighbours, the duplicate flags and the split merged weights.
struct RowWeights {
  int i[3];
  bool first[3];  // slot j holds the first occurrence of its index
  float hi[3], lo[3];
};

__device__ __forceinline__ RowWeights merge(const int (&i)[3],
                                            const float (&w)[3]) {
  RowWeights r;
  float W[3];
  W[0] = __fadd_rn(__fadd_rn(w[0], i[1] == i[0] ? w[1] : 0.f),
                   i[2] == i[0] ? w[2] : 0.f);
  W[1] = i[1] == i[0] ? 0.f : __fadd_rn(w[1], i[2] == i[1] ? w[2] : 0.f);
  W[2] = (i[2] == i[0] || i[2] == i[1]) ? 0.f : w[2];
#pragma unroll
  for (int j = 0; j < 3; ++j) r.i[j] = i[j];
  r.first[0] = true;
  r.first[1] = i[1] != i[0];
  r.first[2] = i[2] != i[0] && i[2] != i[1];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    r.hi[j] = bf16r(W[j]);
    r.lo[j] = bf16r(__fsub_rn(W[j], r.hi[j]));
  }
  return r;
}

__device__ __forceinline__ RowWeights row_weights(const int* __restrict__ idx,
                                                  const float* __restrict__ w,
                                                  long long row) {
  const int i[3] = {idx[row * 3], idx[row * 3 + 1], idx[row * 3 + 2]};
  const float wr[3] = {w[row * 3], w[row * 3 + 1], w[row * 3 + 2]};
  return merge(i, wr);
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

// Row 13's op: slot s = 3 n + j of a cloud names row i_j of source row n,
// is kept where slot j holds the first occurrence of its index, and adds
// hi_j bf16(g) + lo_j bf16(g). Its word packs both weights, which are bf16
// values: hi_j's top half in its low half, lo_j's in its high half. A round
// starts at a multiple of 3 (ops/scatter_rows.py choose), so it stages
// whole rows.
struct FpOp {
  typedef float In;
  static constexpr bool kAux = true;
  static constexpr int kUnroll = 8;
  const float* g;
  const int* idx;
  const float* w;
  int N, C;
  __device__ static unsigned pack(const RowWeights& r, int j) {
    return (__float_as_uint(r.hi[j]) >> 16) |
           (__float_as_uint(r.lo[j]) & 0xffff0000u);
  }
  __device__ void stage(int b, int k0, int n, int r0, int rows, short* dest,
                        unsigned* aux) const {
    constexpr int kT = apt_scatter::kThreads;
    const long long row0 = (long long)b * N + k0 / 3;
    const int src_rows = n / 3;
    for (int i0 = threadIdx.x; i0 < src_rows; i0 += 4 * kT) {
      int iv[4][3];  // four rows' loads in flight, then their weights
      float wv[4][3];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (i0 + u * kT >= src_rows) continue;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          iv[u][j] = __ldg(idx + (row0 + i0 + u * kT) * 3 + j);
          wv[u][j] = __ldg(w + (row0 + i0 + u * kT) * 3 + j);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * kT;
        if (i >= src_rows) continue;
        const RowWeights r = merge(iv[u], wv[u]);
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          dest[3 * i + j] =
              r.first[j] ? apt_scatter::tile_row(r.i[j], r0, rows) : -1;
          aux[3 * i + j] = pack(r, j);
        }
      }
    }
  }
  // "staged": cloud b's rows of g, channels c0 .. c0 + cs (C % 8 == 0, g
  // 16-byte aligned), rounded to bf16 into src [N][cs / 8], eight 32-byte
  // loads in flight a thread.
  __device__ void stage_src(int b, int c0, int cs, uint4* src) const {
    constexpr int kT = apt_scatter::kThreads;
    const int q = cs / 8, items = N * q;
    const float* gb = g + (size_t)b * N * C + c0;
    for (int i0 = threadIdx.x; i0 < items; i0 += 8 * kT) {
      float4 v[8][2];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = i0 + u * kT, n = i / q, k = i - n * q;
        if (i < items && c0 + 8 * k < C) {
          const float4* p =
              reinterpret_cast<const float4*>(gb + (size_t)n * C + 8 * k);
          v[u][0] = __ldg(p);
          v[u][1] = __ldg(p + 1);
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = i0 + u * kT, n = i / q, k = i - n * q;
        if (i >= items) continue;
        using apt_scatter::pack2;
        src[i] = c0 + 8 * k < C
                     ? make_uint4(pack2(v[u][0].x, v[u][0].y),
                                  pack2(v[u][0].z, v[u][0].w),
                                  pack2(v[u][1].x, v[u][1].y),
                                  pack2(v[u][1].z, v[u][1].w))
                     : make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }
  __device__ static int src_rel(int s) { return s / 3; }
  __device__ bool slot(int b, int s, int& r, unsigned& a) const {
    const int n = s / 3, j = s - 3 * n;
    const RowWeights rw = row_weights(idx, w, (long long)b * N + n);
    r = rw.i[j];
    a = pack(rw, j);
    return rw.first[j];
  }
  __device__ const float* row(int b, int k0, int rel) const {
    return g + ((size_t)b * N + k0 / 3 + rel) * C;
  }
  // hi gb + lo gb for gb already rounded to bf16
  __device__ float addend_bf16(float gb, unsigned a) const {
    return __fadd_rn(__fmul_rn(apt_scatter::lo16(a), gb),
                     __fmul_rn(apt_scatter::hi16(a), gb));
  }
  __device__ float addend(float x, unsigned a) const {
    return addend_bf16(bf16r(x), a);
  }
};

__global__ void __launch_bounds__(apt_scatter::kThreads)
fpinterp_bwd_staged_kernel(FpOp op, __nv_bfloat16* __restrict__ d_feat, int S,
                           int M, int C, apt_scatter::Tiling t) {
  extern __shared__ __align__(16) unsigned char smem[];
  apt_scatter::staged_block<FpOp>(op, d_feat, S, M, C, t, smem);
}

template <int V>
__global__ void __launch_bounds__(apt_scatter::kThreads)
fpinterp_bwd_scatter_kernel(FpOp op, __nv_bfloat16* __restrict__ d_feat,
                            int S, int M, int C, apt_scatter::Tiling t) {
  extern __shared__ __align__(16) unsigned char smem[];
  apt_scatter::ordered_block<FpOp, __nv_bfloat16, V>(op, d_feat, S, M, C, t,
                                                     smem);
}

template <int V>
__global__ void __launch_bounds__(apt_scatter::kThreads)
fpinterp_bwd_l2red_kernel(FpOp op, float* __restrict__ acc, int S, int M,
                          int C, long long items) {
  apt_scatter::l2red_thread<FpOp, V>(op, acc, S, M, C, items);
}

// d_w alone: a warp a row, lanes over channels.
__global__ void __launch_bounds__(kWarps * 32)
fpinterp_bwd_dw_kernel(const __nv_bfloat16* __restrict__ feat,
                       const int* __restrict__ idx,
                       const float* __restrict__ g, int M, int N, int C,
                       long long rows, float* __restrict__ d_w) {
  const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const long long b = row / N;
  const int* ir = idx + row * 3;
  const __nv_bfloat16* f[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) f[j] = feat + ((size_t)b * M + ir[j]) * C;
  const float* gr = g + (size_t)row * C;
  float part[3] = {0.f, 0.f, 0.f};
  for (int c = lane; c < C; c += 32) {
    const float gb = bf16r(gr[c]);
#pragma unroll
    for (int j = 0; j < 3; ++j)
      part[j] = __fadd_rn(part[j], __fmul_rn(gb, __bfloat162float(f[j][c])));
  }
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

// d_feat (B, M, C) bf16 from the launch shape t; scratch is the (B, M, C)
// f32 buffer of "l2red".
cudaError_t launch_d_feat(const FpOp& op, int B, int M, int C, float* scratch,
                          __nv_bfloat16* d_feat,
                          const apt_scatter::Tiling& t, cudaStream_t stream) {
  using apt_scatter::launch;
  const int S = 3 * op.N;
  if (!apt_scatter::valid(t, C) ||
      (t.design != apt_scatter::kStaged && t.vec == 8) ||
      (t.design == apt_scatter::kOrdered && t.chunk < S && t.chunk % 3 != 0))
    return cudaErrorInvalidValue;  // f32 sources; a round stages whole rows
  if (t.design == apt_scatter::kStaged) {
    if (t.rows < M || t.chunk < S) return cudaErrorInvalidValue;
    return launch(fpinterp_bwd_staged_kernel,
                  apt_scatter::block_grid(t, B, M, C),
                  apt_scatter::smem_bytes(t, S, true, op.N), stream, op,
                  d_feat, S, M, C, t);
  }
  if (t.design == apt_scatter::kOrdered) {
    const size_t smem = apt_scatter::smem_bytes(t, S, true, op.N);
    const dim3 grid = apt_scatter::block_grid(t, B, M, C);
    return t.vec == 4 ? launch(fpinterp_bwd_scatter_kernel<4>, grid, smem,
                               stream, op, d_feat, S, M, C, t)
                      : launch(fpinterp_bwd_scatter_kernel<1>, grid, smem,
                               stream, op, d_feat, S, M, C, t);
  }
  const long long total = (long long)B * M * C;
  if (scratch == nullptr) return cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(scratch, 0, (size_t)total * 4, stream);
  if (e != cudaSuccess) return e;
  const long long items = (long long)B * S * (C / t.vec);
  const dim3 grid((unsigned)((items + 255) / 256));
  e = t.vec == 4 ? launch(fpinterp_bwd_l2red_kernel<4>, grid, 0, stream, op,
                          scratch, S, M, C, items)
                 : launch(fpinterp_bwd_l2red_kernel<1>, grid, 0, stream, op,
                          scratch, S, M, C, items);
  if (e != cudaSuccess) return e;
  return launch(apt_scatter::round_to_bf16_kernel,
                dim3((unsigned)((total + 255) / 256)), 0, stream, scratch,
                total, d_feat);
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

// The backward with the f32 cotangent g (B,N,C): d_feat (B,M,C) bf16 at the
// launch shape (design, vec, lshift, rows, chunk) of ops/scatter_rows.py
// choose, d_w (B,N,3) f32. Either output may be null (not asked for);
// scratch is the (B,M,C) f32 buffer "l2red" needs, else unused.
int weighted_gather3_bwd_launch(const void* feat, const int* idx,
                                const float* w, const float* g, int B, int M,
                                int N, int C, float* scratch, void* d_feat,
                                float* d_w, int design, int vec, int lshift,
                                int rows, int chunk, cudaStream_t stream) {
  if (B <= 0 || M <= 0 || N <= 0 || C <= 0 ||
      (long long)B * M > 0x7fffffffLL || 3LL * N > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (d_feat != nullptr) {
    const FpOp op{g, idx, w, N, C};
    const apt_scatter::Tiling t{design, vec, lshift, rows, chunk};
    cudaError_t e = launch_d_feat(op, B, M, C, scratch,
                                  (__nv_bfloat16*)d_feat, t, stream);
    if (e != cudaSuccess) return e;
  }
  if (d_w == nullptr) return cudaSuccess;
  const long long n_rows = (long long)B * N;
  fpinterp_bwd_dw_kernel<<<row_blocks(n_rows), kWarps * 32, 0, stream>>>(
      (const __nv_bfloat16*)feat, idx, g, M, N, C, n_rows, d_w);
  return cudaGetLastError();
}

// Shared memory of one d_feat block at this launch shape and N rows of
// three slots a cloud (scatter_rows.cuh smem_bytes; ops/scatter_rows.py
// holds a copy).
long long weighted_gather3_bwd_smem_bytes(int design, int vec, int lshift,
                                          int rows, int chunk, int N) {
  const apt_scatter::Tiling t{design, vec, lshift, rows, chunk};
  return (long long)apt_scatter::smem_bytes(t, 3 * N, true, N);
}

const char* apt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
