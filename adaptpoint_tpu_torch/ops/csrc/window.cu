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
// Design. The TPU kernel ranks the window's in-ball points by original
// index with one 0/1 matmul per tile (inball @ [idx_i <= idx_j]). Here a
// block instead sorts its window by original index once, in shared memory
// (bitonic), so each center scans the window in index order and stops at
// its K-th hit, as the full-N kernel (ballgroup_max.cu) does. A block takes
// a chunk of centers of one tile (8 warps, a warp per center at a time) and
// stages its own window: the original indices (order[ws + i]), their sort,
// then the coordinates read through them. The chunk trades that staging,
// repeated by every block of a tile, against parallelism: 32 centers where
// the window is wider than 512 points (the sort dominates), else 8, one a
// warp (the channel walk over wide features dominates, and more blocks
// fill the card at the small last stages). The scan is the ball-group
// kernel's: __ballot_sync in-ball masks and __popc ranks, d2 rounded step
// by step (__fmul_rn/__fadd_rn, -fmad=false) so the selection equals the
// plain version's. The slots go to shared memory and to idx_out; the lanes
// then own channels c = lane, lane + 32, ... and walk the found slots,
// reading the rounded features at the ORIGINAL rows (the JAX package
// gathers a sorted copy of the features first; the rounding is per element,
// so the values are the same and the copy is not needed). Outputs are
// written at the center's query position (cperm), so no un-permute follows.
// The backward gives a warp a center in query order, rounds each channel's
// one or two slot cotangents and scatters them with atomicAdd onto the
// winners' original rows (the JAX sorted-space sum and its un-sort in one
// step), then adds g_fi and g_new onto the center's row.
//
// What bounds it: bytes, as for the full-N kernel. The forward reads feats
// once (the slot reads repeat rows out of L2) and writes three (B, M, C)
// f32 and two (B, M, C) u8 tensors; the backward reads the four (B, M, C)
// cotangents and the slots and writes (B, N, C). Each block reads its
// window again (16 bytes a point, out of L2).
//
// Arithmetic: forward outputs, slots and counts exact against the plain
// version; the backward's atomic adds land in no fixed order.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <climits>

namespace {

constexpr int kWarps = 8;
constexpr int kChunk = 32;  // centers a block takes over a wide window

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// the first `splits` parts of the exact three-way bf16 split of x, summed
// in f32 in part order
__device__ __forceinline__ float split_round(float x, int splits) {
  const float p0 = bf16r(x);
  if (splits == 1) return p0;
  const float r1 = __fsub_rn(x, p0);
  const float p1 = bf16r(r1);
  if (splits == 2) return __fadd_rn(p0, p1);
  return __fadd_rn(__fadd_rn(p0, p1), bf16r(__fsub_rn(r1, p1)));
}

__host__ __device__ inline int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

__host__ __device__ inline size_t smem_bytes(int w, int K) {
  return (size_t)next_pow2(w) * sizeof(int) + (size_t)w * 3 * sizeof(float) +
         (size_t)kWarps * K * sizeof(int);
}

__global__ void __launch_bounds__(kWarps * 32)
window_max_kernel(const float* __restrict__ xyz,
                  const float* __restrict__ feats,
                  const int* __restrict__ order, const int* __restrict__ win,
                  const int* __restrict__ qpos, const int* __restrict__ cperm,
                  int N, int M, int C, int K, int tm, int w, int chunk,
                  int splits, float r2, float* __restrict__ new_xyz,
                  float* __restrict__ fi, float* __restrict__ fmax,
                  float* __restrict__ fmin, unsigned char* __restrict__ amax,
                  unsigned char* __restrict__ amin, int* __restrict__ cnt_out,
                  int* __restrict__ idx_out, int* __restrict__ qrow_out) {
  extern __shared__ int smem[];
  const int w2 = next_pow2(w);
  int* sidx = smem;                                   // w2 original indices
  float* sx = reinterpret_cast<float*>(smem + w2);    // w coordinates each
  float* sy = sx + w;
  float* sz = sy + w;
  int* snbr = reinterpret_cast<int*>(sz + w);         // kWarps x K slots

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * chunk;  // first key-sorted center of the block
  const int t = c0 / tm;
  const int T = M / tm;
  const int ws = win[b * T + t] * 128;
  const int nvalid = min(w, N - ws);
  const int* ord = order + (size_t)b * N;
  const float* X = xyz + (size_t)b * N * 3;
  const float* F = feats + (size_t)b * N * C;

  for (int i = threadIdx.x; i < w2; i += blockDim.x)
    sidx[i] = i < nvalid ? ord[ws + i] : INT_MAX;
  __syncthreads();
  // bitonic sort of the window's original indices, ascending
  for (int k = 2; k <= w2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < w2; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const int a = sidx[i], bb = sidx[ixj];
          if ((a > bb) == ((i & k) == 0)) {
            sidx[i] = bb;
            sidx[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < nvalid; i += blockDim.x) {
    const int o = sidx[i];
    sx[i] = X[3 * o];
    sy[i] = X[3 * o + 1];
    sz[i] = X[3 * o + 2];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int* nbr = snbr + warp * K;
  for (int ci = warp; ci < chunk; ci += kWarps) {
    const size_t s = (size_t)b * M + c0 + ci;
    const int qp = qpos[s];
    const int m = cperm[s];
    const bool inwin = qp >= ws && qp < ws + w;
    const int qo = inwin ? ord[qp] : -1;
    const float qx = inwin ? X[3 * qo] : 0.0f;
    const float qy = inwin ? X[3 * qo + 1] : 0.0f;
    const float qz = inwin ? X[3 * qo + 2] : 0.0f;

    int cnt = 0;
    for (int base = 0; base < nvalid && cnt < K; base += 32) {
      const int j = base + lane;
      bool in = false;
      if (j < nvalid) {
        const float dx = __fsub_rn(qx, sx[j]);
        const float dy = __fsub_rn(qy, sy[j]);
        const float dz = __fsub_rn(qz, sz[j]);
        const float d2 = __fadd_rn(
            __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
        in = d2 < r2;
      }
      const unsigned mask = __ballot_sync(0xffffffffu, in);
      const int rank = cnt + __popc(mask & ((1u << lane) - 1u));
      if (in && rank < K) nbr[rank] = sidx[j];
      cnt += __popc(mask);
    }
    __syncwarp();
    const int found = cnt < K ? cnt : K;
    const int first = found > 0 ? nbr[0] : 0;
    for (int k = found + lane; k < K; k += 32) nbr[k] = first;
    __syncwarp();

    const size_t bm = (size_t)b * M + m;
    for (int k = lane; k < K; k += 32) idx_out[bm * K + k] = nbr[k];
    if (lane == 0) {
      cnt_out[bm] = found;
      qrow_out[bm] = qo;
      new_xyz[bm * 3] = qx;
      new_xyz[bm * 3 + 1] = qy;
      new_xyz[bm * 3 + 2] = qz;
    }
    for (int c = lane; c < C; c += 32) {
      fi[bm * C + c] = inwin ? split_round(F[(size_t)qo * C + c], splits)
                             : 0.0f;
      float vmax, vmin;
      int kmax = 0, kmin = 0;
      if (found == 0) {  // empty ball: the original row 0, unrounded
        vmax = vmin = F[c];
      } else {
        vmax = __int_as_float((int)0xff800000u);  // -inf
        vmin = __int_as_float((int)0x7f800000u);  // +inf
        for (int k = 0; k < found; ++k) {  // pad slots never win
          const float v = split_round(F[(size_t)nbr[k] * C + c], splits);
          if (v > vmax) { vmax = v; kmax = k; }
          if (v < vmin) { vmin = v; kmin = k; }
        }
      }
      fmax[bm * C + c] = vmax;
      fmin[bm * C + c] = vmin;
      amax[bm * C + c] = (unsigned char)kmax;
      amin[bm * C + c] = (unsigned char)kmin;
    }
    __syncwarp();  // nbr is rewritten by the warp's next center
  }
}

__global__ void __launch_bounds__(kWarps * 32)
window_max_bwd_kernel(const int* __restrict__ idx, const int* __restrict__ cnt,
                      const int* __restrict__ qrow,
                      const float* __restrict__ g_new,
                      const float* __restrict__ g_fi,
                      const float* __restrict__ g_fmax,
                      const float* __restrict__ g_fmin,
                      const unsigned char* __restrict__ amax,
                      const unsigned char* __restrict__ amin, int B, int N,
                      int M, int C, int K, int grad_splits,
                      float* __restrict__ g_xyz, float* __restrict__ g_feats) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long g = (long long)blockIdx.x * kWarps + warp;
  if (g >= (long long)B * M) return;
  const int b = (int)(g / M);
  const size_t bm = (size_t)g;
  const int found = cnt[bm];
  const int q = qrow[bm];
  const int* nbr = idx + bm * K;
  if (g_feats) {
    float* GF = g_feats + (size_t)b * N * C;
    for (int c = lane; c < C; c += 32) {
      const size_t e = bm * C + c;
      if (found > 0) {
        const float ga = g_fmax ? g_fmax[e] : 0.0f;
        const float gi = g_fmin ? g_fmin[e] : 0.0f;
        const int ka = amax[e], ki = amin[e];
        if (ka == ki) {
          const float v = split_round(__fadd_rn(ga, gi), grad_splits);
          if (v != 0.0f) atomicAdd(GF + (size_t)nbr[ka] * C + c, v);
        } else {
          const float va = split_round(ga, grad_splits);
          const float vi = split_round(gi, grad_splits);
          if (va != 0.0f) atomicAdd(GF + (size_t)nbr[ka] * C + c, va);
          if (vi != 0.0f) atomicAdd(GF + (size_t)nbr[ki] * C + c, vi);
        }
      }
      if (g_fi && q >= 0) atomicAdd(GF + (size_t)q * C + c, g_fi[e]);
    }
  }
  if (g_xyz && g_new && q >= 0 && lane < 3)
    atomicAdd(g_xyz + ((size_t)b * N + q) * 3 + lane, g_new[bm * 3 + lane]);
}

int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

}  // namespace

extern "C" {

// Dynamic shared memory the forward needs at window width w and K slots.
int window_max_smem(int w, int K) { return (int)smem_bytes(w, K); }

// xyz (B,N,3) f32, feats (B,N,C) f32, order (B,N) i32, win (B,M/tm) i32,
// qpos, cperm (B,M) i32 (window_prep's), all contiguous -> in query order
// new_xyz (B,M,3), fi, fmax, fmin (B,M,C) f32, amax, amin (B,M,C) u8,
// cnt (B,M) i32 (in-ball count capped at K), idx (B,M,K) i32 original
// indices, qrow (B,M) i32 (the center's row, -1 outside its window).
// r2 = f32(r)*f32(r); K <= 255; M a multiple of tm; w a multiple of 128 no
// larger than N rounded up to 128. Returns cudaError_t.
int window_max_launch(const float* xyz, const float* feats, const int* order,
                      const int* win, const int* qpos, const int* cperm, int B,
                      int N, int M, int C, int K, int tm, int w, int splits,
                      float r2, float* new_xyz, float* fi, float* fmax,
                      float* fmin, unsigned char* amax, unsigned char* amin,
                      int* cnt, int* idx, int* qrow, cudaStream_t stream) {
  if (B <= 0 || N <= 0 || M <= 0 || C <= 0 || K <= 0 || K > 255 || tm <= 0 ||
      M % tm || w <= 0 || w % 128 || splits < 1 || splits > 3)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(w, K);
  cudaError_t e = cudaFuncSetAttribute(
      window_max_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const int chunk = gcd(tm, next_pow2(w) > 512 ? kChunk : kWarps);
  const dim3 grid(M / chunk, B);
  window_max_kernel<<<grid, kWarps * 32, smem, stream>>>(
      xyz, feats, order, win, qpos, cperm, N, M, C, K, tm, w, chunk, splits,
      r2, new_xyz, fi, fmax, fmin, amax, amin, cnt, idx, qrow);
  return cudaGetLastError();
}

// The forward's idx, cnt, qrow, amax, amin; cotangents g_new (B,M,3), g_fi,
// g_fmax, g_fmin (B,M,C) f32 contiguous or null (zero) -> g_xyz (B,N,3),
// g_feats (B,N,C) f32, either null to skip it; both are zeroed here on the
// stream. Returns cudaError_t.
int window_max_bwd_launch(const int* idx, const int* cnt, const int* qrow,
                          const float* g_new, const float* g_fi,
                          const float* g_fmax, const float* g_fmin,
                          const unsigned char* amax, const unsigned char* amin,
                          int B, int N, int M, int C, int K, int grad_splits,
                          float* g_xyz, float* g_feats, cudaStream_t stream) {
  if (B <= 0 || N <= 0 || M <= 0 || C <= 0 || K <= 0 || K > 255 ||
      grad_splits < 1 || grad_splits > 3)
    return cudaErrorInvalidValue;
  cudaError_t e;
  if (g_xyz) {
    e = cudaMemsetAsync(g_xyz, 0, (size_t)B * N * 3 * sizeof(float), stream);
    if (e != cudaSuccess) return e;
  }
  if (g_feats) {
    e = cudaMemsetAsync(g_feats, 0, (size_t)B * N * C * sizeof(float), stream);
    if (e != cudaSuccess) return e;
  }
  const long long warps = (long long)B * M;
  const int blocks = (int)((warps + kWarps - 1) / kWarps);
  window_max_bwd_kernel<<<blocks, kWarps * 32, 0, stream>>>(
      idx, cnt, qrow, g_new, g_fi, g_fmax, g_fmin, amax, amin, B, N, M, C, K,
      grad_splits, g_xyz, g_feats);
  return cudaGetLastError();
}

const char* apt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
