// The channel walk shared by the max-pooled ball group (ballgroup_max.cu,
// kernel row 7) and its windowed twin (window.cu, row 20) for Hopper
// (sm_90a): 16-byte vectors of channels, their stores, and the max / min
// over a center's found slots.
//
// A thread owns one center and V consecutive channels (16 bytes: 4 f32 or
// 8 bf16, or 1 where the channels or the pointer do not allow a vector). It
// walks the found slots kUnroll at a time: the kUnroll row loads are issued
// before their compares, which run in slot order with strict > / <, so each
// output keeps the first slot that holds it. Pad slots repeat slot 0 and
// never win, so the walk stops at the last found slot.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace apt_bgm {

typedef __nv_bfloat16 bf16;

constexpr int kUnroll = 4;  // slot loads in flight a thread

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// V consecutive elements of type T, loaded as one vector (16 bytes when
// V > 1): raw(i) as stored, val(i) as row 7 compares them (bf16 rounded for
// f32 features, exact for bf16 ones).
template <typename T, int V>
struct Vec;

template <>
struct Vec<float, 4> {
  float4 r;
  __device__ __forceinline__ void load(const float* p) {
    r = *reinterpret_cast<const float4*>(p);
  }
  __device__ __forceinline__ float raw(int i) const {
    return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
  }
  __device__ __forceinline__ float val(int i) const { return bf16r(raw(i)); }
};

template <>
struct Vec<float, 1> {
  float r;
  __device__ __forceinline__ void load(const float* p) { r = *p; }
  __device__ __forceinline__ float raw(int) const { return r; }
  __device__ __forceinline__ float val(int) const { return bf16r(r); }
};

template <>
struct Vec<bf16, 8> {
  uint4 r;
  __device__ __forceinline__ void load(const bf16* p) {
    r = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ float raw(int i) const {
    const unsigned w = i < 2 ? r.x : i < 4 ? r.y : i < 6 ? r.z : r.w;
    return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
  }
  __device__ __forceinline__ float val(int i) const { return raw(i); }
};

template <>
struct Vec<bf16, 1> {
  bf16 r;
  __device__ __forceinline__ void load(const bf16* p) { r = *p; }
  __device__ __forceinline__ float raw(int) const {
    return __bfloat162float(r);
  }
  __device__ __forceinline__ float val(int) const { return raw(0); }
};

// Store V values (already representable in T where T is bf16) at p.
template <int V>
__device__ __forceinline__ void store(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = v[i];
  }
}

template <int V>
__device__ __forceinline__ void store(bf16* p, const float (&v)[V]) {
  if constexpr (V == 8) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const unsigned*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = __float2bfloat16_rn(v[i]);
  }
}

// V slots (bytes) at p, packed into one store.
template <int V>
__device__ __forceinline__ void store_slots(unsigned char* p,
                                            const int (&s)[V]) {
  if constexpr (V == 1) {
    p[0] = (unsigned char)s[0];
  } else {
    unsigned w[2] = {0u, 0u};
#pragma unroll
    for (int i = 0; i < V; ++i) w[i >> 2] |= (unsigned)s[i] << (8 * (i & 3));
    if constexpr (V == 4)
      *reinterpret_cast<unsigned*>(p) = w[0];
    else
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  }
}

// The max and min over slots 0 .. walk - 1 (walk >= 1) of the V channels
// from col of the rows nbc names (F: the cloud's (N, C) rows), each value
// val(vector, i); kmax / kmin the first slot holding each.
template <typename T, int V, typename Val>
__device__ __forceinline__ void max_min_walk(const T* F, int C, int col,
                                             const int* nbc, int walk,
                                             Val val, float (&vmax)[V],
                                             float (&vmin)[V],
                                             int (&kmax)[V],
                                             int (&kmin)[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i) {
    vmax[i] = __int_as_float((int)0xff800000u);  // -inf
    vmin[i] = __int_as_float((int)0x7f800000u);  // +inf
    kmax[i] = kmin[i] = 0;
  }
  for (int k0 = 0; k0 < walk; k0 += kUnroll) {
    Vec<T, V> v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (k0 + u < walk) v[u].load(F + (size_t)nbc[k0 + u] * C + col);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (k0 + u >= walk) continue;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float x = val(v[u], i);
        if (x > vmax[i]) {
          vmax[i] = x;
          kmax[i] = k0 + u;
        }
        if (x < vmin[i]) {
          vmin[i] = x;
          kmin[i] = k0 + u;
        }
      }
    }
  }
}

}  // namespace apt_bgm
