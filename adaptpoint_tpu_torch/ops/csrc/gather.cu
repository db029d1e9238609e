// Row gather and its scatter-add backward for Hopper (sm_90a).
//
// Replaces the TPU kernels adaptpoint_tpu/ops/pallas/gather.py
// gather_rows_pallas (_fwd_kernel) and its VJP _bwd (_bwd_kernel). Same
// functions as the plain versions in ops/gather.py:
//   forward   out[b, m, :]          = pts[b, idx[b, m], :]      (exact copy)
//   backward  g_pts[b, idx[b, m], :] += g[b, m, :]              (f32 sums,
//             duplicates all added, then cast to the primal type)
// for float32 and bfloat16 rows. The TPU kernels gather with one-hot
// matmuls and a 3-way bf16 split because the TPU has no fast row gather;
// here a row is addressed directly.
//
// Forward design: rows are the unit. A row of C * elem_bytes bytes moves in
// the widest accesses its size and the pointers allow (16, 8, 4 or 2
// bytes: C = 4 f32 is one 16-byte load a row, C = 3 f32 three 4-byte
// ones), by one thread or, for wide rows, a group of lanes (a power of two,
// at most 32, so that a lane moves about 4 accesses: C = 1024 f32 is a warp
// with 8 float4s a lane). The group loads the row's index once and divides
// by M once (32 bits); a grid of at most 8 blocks an SM walks the rows with
// a grid stride. The launch function picks the access width and the group.
//
// Backward design: scatter_rows.cuh's destination-ordered block with an op
// whose slots are idx's entries and whose addends are g's rows as they are
// (every duplicate added): a block owns a tile of one cloud's output rows
// and a channel slice, builds its rows' slot lists in shared memory in
// ascending slot order, and a group of lanes sums a row's list in f32 with
// 16-byte loads (8 bf16 or 4 f32 channels a lane where C and the pointers
// allow, one channel otherwise) and writes it once, bf16 rounded once for
// bf16. One launch, no memset, no scratch; rows no index names are zeros.
// Its launch shape comes from ops/scatter_rows.py choose, which takes the
// L2-reduction design ("l2red": a memset, the kernel and, for bf16, a
// rounding pass) for small scatters.
//
// What bounds them: bytes (every input read once, every output written
// once); at the train step's shape, (32, 2048, 4) -> 1024 rows, about 1 MB,
// the launch. The backward sums each row in ascending slot order: the same
// bits from run to run, exact where indices are distinct (the resampling
// gather).
//
// Indices must lie in [0, N): the kernels do not check (the one-hot TPU
// kernel yields a zero row there; the model never passes one).
#include "scatter_rows.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kSms = 132;          // H100 SXM
constexpr int kBlocksPerSm = 8;    // 2048 threads an SM

// rows B * M of vpr accesses of type V each; 2^lshift lanes a row
template <typename V>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const V* __restrict__ pts, const int* __restrict__ idx,
                   int rows, int N, int M, int vpr, int lshift,
                   V* __restrict__ out) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int sub = threadIdx.x & ((1 << lshift) - 1);
  const int stride = (gridDim.x * kThreads) >> lshift;
  for (int r = t >> lshift; r < rows; r += stride) {
    const unsigned b = (unsigned)r / (unsigned)M;
    const V* src = pts + ((size_t)b * N + __ldg(idx + r)) * vpr;
    V* dst = out + (size_t)r * vpr;
    for (int v = sub; v < vpr; v += 1 << lshift) dst[v] = __ldg(src + v);
  }
}

template <typename V>
cudaError_t launch_gather(const void* pts, const int* idx, int rows, int N,
                          int M, int row_bytes, cudaStream_t stream,
                          void* out) {
  const int vpr = row_bytes / (int)sizeof(V);
  int lshift = 0;  // about 4 accesses a lane, at most a warp a row
  while (lshift < 5 && (4 << lshift) < vpr) ++lshift;
  const long long threads = (long long)rows << lshift;
  const long long want = (threads + kThreads - 1) / kThreads;
  const int blocks = (int)(want < kSms * kBlocksPerSm ? want
                                                      : kSms * kBlocksPerSm);
  gather_rows_kernel<V><<<blocks, kThreads, 0, stream>>>(
      static_cast<const V*>(pts), idx, rows, N, M, vpr, lshift,
      static_cast<V*>(out));
  return cudaGetLastError();
}

// Row 15's op: slot s of cloud b names row idx[b, s] and adds g[b, s, :]
// as it is.
template <typename T>
struct RowsOp {
  typedef T In;
  static constexpr bool kAux = false;
  static constexpr int kUnroll = 8;
  const T* g;
  const int* idx;
  int S, C;
  __device__ void stage(int b, int k0, int n, int r0, int rows, short* dest,
                        unsigned*) const {
    apt_scatter::stage_rows(idx + (size_t)b * S + k0, n, r0, rows, dest);
  }
  __device__ bool slot(int b, int s, int& r, unsigned& a) const {
    r = __ldg(idx + (size_t)b * S + s);
    a = 0;
    return true;
  }
  __device__ static int src_rel(int s) { return s; }
  __device__ const T* row(int b, int k0, int rel) const {
    return g + ((size_t)b * S + k0 + rel) * C;
  }
  __device__ float addend(float x, unsigned) const { return x; }
};

template <typename T, int V>
__global__ void __launch_bounds__(apt_scatter::kThreads)
gather_rows_bwd_kernel(RowsOp<T> op, T* __restrict__ out, int S, int M,
                       int C, apt_scatter::Tiling t) {
  extern __shared__ __align__(16) unsigned char smem[];
  apt_scatter::ordered_block<RowsOp<T>, T, V>(op, out, S, M, C, t, smem);
}

template <typename T, int V>
__global__ void __launch_bounds__(apt_scatter::kThreads)
gather_rows_bwd_l2red_kernel(RowsOp<T> op, float* __restrict__ acc, int S,
                             int M, int C, long long items) {
  apt_scatter::l2red_thread<RowsOp<T>, V>(op, acc, S, M, C, items);
}

// g (B, S, C) of T onto out (B, M, C) of T by idx (B, S); scratch is the
// f32 buffer of "l2red" for bf16.
template <typename T>
cudaError_t launch_bwd(const T* g, const int* idx, int B, int M, int S,
                       int C, float* scratch, T* out,
                       const apt_scatter::Tiling& t, cudaStream_t stream) {
  using namespace apt_scatter;
  if (!valid(t, C) || t.design == kStaged) return cudaErrorInvalidValue;
  const RowsOp<T> op{g, idx, S, C};
  if (t.design == kOrdered) {
    const size_t smem = smem_bytes(t, S, false, 0);
    const dim3 grid = block_grid(t, B, M, C);
    if (t.vec == 1)
      return launch(gather_rows_bwd_kernel<T, 1>, grid, smem, stream, op,
                    out, S, M, C, t);
    if (t.vec == 4)
      return launch(gather_rows_bwd_kernel<T, 4>, grid, smem, stream, op,
                    out, S, M, C, t);
    if constexpr (sizeof(T) == 2)
      return launch(gather_rows_bwd_kernel<T, 8>, grid, smem, stream, op,
                    out, S, M, C, t);
    return cudaErrorInvalidValue;
  }
  float* acc = sizeof(T) == 4 ? reinterpret_cast<float*>(out) : scratch;
  const long long total = (long long)B * M * C;
  if (acc == nullptr) return cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(acc, 0, (size_t)total * 4, stream);
  if (e != cudaSuccess) return e;
  const long long items = (long long)B * S * (C / t.vec);
  const dim3 grid((unsigned)((items + 255) / 256));
  e = t.vec == 4 ? launch(gather_rows_bwd_l2red_kernel<T, 4>, grid, 0, stream,
                          op, acc, S, M, C, items)
                 : launch(gather_rows_bwd_l2red_kernel<T, 1>, grid, 0, stream,
                          op, acc, S, M, C, items);
  if (e != cudaSuccess || sizeof(T) == 4) return e;
  return launch(round_to_bf16_kernel, dim3((unsigned)((total + 255) / 256)),
                0, stream, acc, total, reinterpret_cast<__nv_bfloat16*>(out));
}

}  // namespace

extern "C" {

// pts (B,N,C), idx (B,M) i32 -> out (B,M,C); elem_bytes 4 (f32) or 2 (bf16),
// all contiguous; B * M and B * N * C below 2^31. Returns cudaError_t.
int gather_rows_launch(const void* pts, const int* idx, int B, int N, int M,
                       int C, int elem_bytes, void* out,
                       cudaStream_t stream) {
  if (B <= 0 || N <= 0 || M <= 0 || C <= 0 ||
      (elem_bytes != 4 && elem_bytes != 2) ||
      (long long)B * M > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const int rows = B * M;
  const int row_bytes = C * elem_bytes;
  const uintptr_t align = reinterpret_cast<uintptr_t>(pts) |
                          reinterpret_cast<uintptr_t>(out) |
                          (uintptr_t)row_bytes;
  if (align % 16 == 0)
    return launch_gather<uint4>(pts, idx, rows, N, M, row_bytes, stream, out);
  if (align % 8 == 0)
    return launch_gather<uint2>(pts, idx, rows, N, M, row_bytes, stream, out);
  if (align % 4 == 0)
    return launch_gather<uint32_t>(pts, idx, rows, N, M, row_bytes, stream,
                                   out);
  return launch_gather<uint16_t>(pts, idx, rows, N, M, row_bytes, stream,
                                 out);
}

// g (B,M,C) f32 or bf16, idx (B,M) i32 -> g_pts (B,N,C) of the same type,
// all contiguous, B * N below 2^31; the launch shape (design, vec, lshift,
// rows, chunk) from ops/scatter_rows.py choose. scratch: the (B,N,C) f32
// buffer "l2red" needs for bf16, else unused. Returns cudaError_t.
int gather_rows_bwd_launch(const void* g, const int* idx, int B, int N, int M,
                           int C, int elem_bytes, float* scratch, void* g_pts,
                           int design, int vec, int lshift, int rows,
                           int chunk, cudaStream_t stream) {
  if (B <= 0 || N <= 0 || M <= 0 || C <= 0 ||
      (long long)B * N > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const apt_scatter::Tiling t{design, vec, lshift, rows, chunk};
  if (elem_bytes == 4)
    return launch_bwd((const float*)g, idx, B, N, M, C, scratch,
                      (float*)g_pts, t, stream);
  if (elem_bytes == 2)
    return launch_bwd((const __nv_bfloat16*)g, idx, B, N, M, C, scratch,
                      (__nv_bfloat16*)g_pts, t, stream);
  return cudaErrorInvalidValue;
}

// Shared memory of one backward block at this launch shape and M slots a
// cloud (scatter_rows.cuh smem_bytes; ops/scatter_rows.py holds a copy).
long long gather_rows_bwd_smem_bytes(int design, int vec, int lshift,
                                     int rows, int chunk, int M) {
  const apt_scatter::Tiling t{design, vec, lshift, rows, chunk};
  return (long long)apt_scatter::smem_bytes(t, M, false, 0);
}

const char* apt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
