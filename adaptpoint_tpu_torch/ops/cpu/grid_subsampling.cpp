// Voxel-grid barycenter subsampling on the host (C interface for ctypes).
//
// The port's copy of the JAX package's grid subsampling, the same code so
// the same bits (reference openpoints/cpp/subsampling/grid_subsampling):
// the points of each sample_dl-sized voxel are averaged, positions and
// optional per-point features, the voxels in the order they first appear,
// with a flat open-addressing hash map. ops/cpu/grid_subsample.py builds it
// with g++ -O3 -shared -fPIC at first use and loads it with ctypes.
#include <cstdint>
#include <cstring>
#include <vector>
#include <cmath>

namespace {

struct Accum {
  double sum[3];
  double* feat_sum;  // f values
  uint32_t count;
};

inline uint64_t hash_key(int64_t x, int64_t y, int64_t z) {
  uint64_t h = 1469598103934665603ull;
  const int64_t v[3] = {x, y, z};
  const unsigned char* p = reinterpret_cast<const unsigned char*>(v);
  for (size_t i = 0; i < sizeof(v); ++i) {
    h ^= p[i];
    h *= 1099511628211ull;
  }
  return h;
}

}  // namespace

extern "C" {

// First pass: count voxels. Second pass (out != nullptr): write barycenters.
// points: (n, 3) xyz; feats: (n, f) or nullptr; sample_dl: voxel edge.
// out_points: (capacity, 3); out_feats: (capacity, f).
// Returns the number of voxels (subsampled points).
int64_t grid_subsample(const float* points, int64_t n,
                       const float* feats, int64_t f,
                       float sample_dl,
                       float* out_points, float* out_feats,
                       int64_t capacity) {
  if (n <= 0 || sample_dl <= 0.f) return 0;

  // voxel origin at the min corner (parity with the reference's
  // floor((p - origin) / dl) indexing)
  float minv[3] = {points[0], points[1], points[2]};
  for (int64_t i = 1; i < n; ++i) {
    for (int d = 0; d < 3; ++d) {
      float v = points[i * 3 + d];
      if (v < minv[d]) minv[d] = v;
    }
  }

  // open-addressing hash table sized ~2x n
  size_t table_size = 1;
  while (table_size < static_cast<size_t>(n) * 2) table_size <<= 1;
  std::vector<int64_t> keys(table_size * 3);
  std::vector<int32_t> slot_of(table_size, -1);
  std::vector<Accum> accums;
  accums.reserve(static_cast<size_t>(n) / 4 + 16);
  std::vector<double> feat_store;
  if (f > 0) feat_store.reserve((static_cast<size_t>(n) / 4 + 16) * f);

  const uint64_t mask = table_size - 1;
  for (int64_t i = 0; i < n; ++i) {
    const float* p = points + i * 3;
    int64_t vx = static_cast<int64_t>(std::floor((p[0] - minv[0]) / sample_dl));
    int64_t vy = static_cast<int64_t>(std::floor((p[1] - minv[1]) / sample_dl));
    int64_t vz = static_cast<int64_t>(std::floor((p[2] - minv[2]) / sample_dl));
    uint64_t h = hash_key(vx, vy, vz) & mask;
    int32_t slot;
    for (;;) {
      slot = slot_of[h];
      if (slot < 0) {
        slot = static_cast<int32_t>(accums.size());
        slot_of[h] = slot;
        keys[h * 3] = vx;
        keys[h * 3 + 1] = vy;
        keys[h * 3 + 2] = vz;
        Accum a;
        a.sum[0] = a.sum[1] = a.sum[2] = 0.0;
        a.count = 0;
        a.feat_sum = nullptr;
        accums.push_back(a);
        if (f > 0) {
          feat_store.resize(accums.size() * f, 0.0);
        }
        break;
      }
      if (keys[h * 3] == vx && keys[h * 3 + 1] == vy && keys[h * 3 + 2] == vz)
        break;
      h = (h + 1) & mask;
    }
    Accum& a = accums[slot];
    a.sum[0] += p[0];
    a.sum[1] += p[1];
    a.sum[2] += p[2];
    a.count += 1;
    if (f > 0) {
      double* fs = feat_store.data() + static_cast<size_t>(slot) * f;
      const float* fv = feats + i * f;
      for (int64_t j = 0; j < f; ++j) fs[j] += fv[j];
    }
  }

  int64_t n_out = static_cast<int64_t>(accums.size());
  if (out_points != nullptr) {
    int64_t m = n_out < capacity ? n_out : capacity;
    for (int64_t s = 0; s < m; ++s) {
      const Accum& a = accums[s];
      const double inv = 1.0 / a.count;
      out_points[s * 3] = static_cast<float>(a.sum[0] * inv);
      out_points[s * 3 + 1] = static_cast<float>(a.sum[1] * inv);
      out_points[s * 3 + 2] = static_cast<float>(a.sum[2] * inv);
      if (f > 0 && out_feats != nullptr) {
        const double* fs = feat_store.data() + static_cast<size_t>(s) * f;
        for (int64_t j = 0; j < f; ++j)
          out_feats[s * f + j] = static_cast<float>(fs[j] * inv);
      }
    }
  }
  return n_out;
}

}  // extern "C"
