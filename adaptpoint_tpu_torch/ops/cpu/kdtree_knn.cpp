// KD-tree k-nearest-neighbours and sorted radius queries on the host (C
// interface for ctypes).
//
// The port's copy of the JAX package's host kd-tree, the same code so the
// same bits (the reference's vendored nearest_neighbors package and the
// sklearn KDTree of its S3DIS sphere dataset): a median-split 3D kd-tree
// with a bounded max-heap per kNN query; radius queries sorted by
// (distance, index). ops/cpu/kdtree_knn.py builds it with
// g++ -O3 -shared -fPIC at first use and loads it with ctypes.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

struct Node {
  int32_t idx;      // point index at this node
  int32_t left;     // child node ids (-1 = none)
  int32_t right;
  int8_t axis;
};

struct Tree {
  const float* pts;
  std::vector<Node> nodes;
  int32_t root;

  int32_t build(std::vector<int32_t>& ids, int lo, int hi, int depth) {
    if (lo >= hi) return -1;
    int axis = depth % 3;
    int mid = (lo + hi) / 2;
    std::nth_element(ids.begin() + lo, ids.begin() + mid, ids.begin() + hi,
                     [&](int32_t a, int32_t b) {
                       return pts[a * 3 + axis] < pts[b * 3 + axis];
                     });
    Node n;
    n.idx = ids[mid];
    n.axis = static_cast<int8_t>(axis);
    int32_t self = static_cast<int32_t>(nodes.size());
    nodes.push_back(n);
    nodes[self].left = build(ids, lo, mid, depth + 1);
    nodes[self].right = build(ids, mid + 1, hi, depth + 1);
    return self;
  }
};

struct Heap {  // bounded max-heap of (dist, idx)
  float* d;
  int32_t* i;
  int k;
  int n = 0;

  void push(float dist, int32_t idx) {
    if (n < k) {
      d[n] = dist;
      i[n] = idx;
      ++n;
      int c = n - 1;
      while (c > 0) {
        int p = (c - 1) / 2;
        if (d[p] >= d[c]) break;
        std::swap(d[p], d[c]);
        std::swap(i[p], i[c]);
        c = p;
      }
    } else if (dist < d[0]) {
      d[0] = dist;
      i[0] = idx;
      int p = 0;
      for (;;) {
        int l = 2 * p + 1, r = 2 * p + 2, m = p;
        if (l < n && d[l] > d[m]) m = l;
        if (r < n && d[r] > d[m]) m = r;
        if (m == p) break;
        std::swap(d[p], d[m]);
        std::swap(i[p], i[m]);
        p = m;
      }
    }
  }
  float worst() const { return n < k ? 1e30f : d[0]; }
};

void search(const Tree& t, int32_t node, const float* q, Heap& heap) {
  if (node < 0) return;
  const Node& n = t.nodes[node];
  const float* p = t.pts + n.idx * 3;
  float dx = q[0] - p[0], dy = q[1] - p[1], dz = q[2] - p[2];
  heap.push(dx * dx + dy * dy + dz * dz, n.idx);
  float delta = q[n.axis] - p[n.axis];
  int32_t near = delta < 0 ? n.left : n.right;
  int32_t far = delta < 0 ? n.right : n.left;
  search(t, near, q, heap);
  if (delta * delta < heap.worst()) search(t, far, q, heap);
}

}  // namespace

extern "C" {

// support (n,3) f32; queries (m,3) f32; out_idx (m,k) i32; out_d2 (m,k) f32
// (sorted ascending per row).
void kdtree_knn(const float* support, int64_t n, const float* queries,
                int64_t m, int32_t k, int32_t* out_idx, float* out_d2) {
  Tree tree;
  tree.pts = support;
  std::vector<int32_t> ids(n);
  for (int64_t i = 0; i < n; ++i) ids[i] = static_cast<int32_t>(i);
  tree.nodes.reserve(n);
  tree.root = tree.build(ids, 0, static_cast<int>(n), 0);

  std::vector<float> hd(k);
  std::vector<int32_t> hi(k);
  for (int64_t qi = 0; qi < m; ++qi) {
    Heap heap{hd.data(), hi.data(), k, 0};
    search(tree, tree.root, queries + qi * 3, heap);
    // sort ascending
    std::vector<std::pair<float, int32_t>> items(heap.n);
    for (int j = 0; j < heap.n; ++j) items[j] = {hd[j], hi[j]};
    std::sort(items.begin(), items.end());
    for (int j = 0; j < k; ++j) {
      int src = j < heap.n ? j : heap.n - 1;  // pad with the farthest found
      out_idx[qi * k + j] = items[src].second;
      out_d2[qi * k + j] = items[src].first;
    }
  }
}

}  // extern "C"

namespace {

// Persistent tree wrapper owning a copy of the points (handle API).
struct OwnedTree {
  std::vector<float> pts;
  Tree tree;
};

void radius_collect(const Tree& t, int32_t node, const float* q, float r2,
                    std::vector<std::pair<float, int32_t>>& out) {
  if (node < 0) return;
  const Node& n = t.nodes[node];
  const float* p = t.pts + n.idx * 3;
  float dx = q[0] - p[0], dy = q[1] - p[1], dz = q[2] - p[2];
  float d2 = dx * dx + dy * dy + dz * dz;
  if (d2 <= r2) out.emplace_back(d2, n.idx);
  float delta = q[n.axis] - p[n.axis];
  int32_t near = delta < 0 ? n.left : n.right;
  int32_t far = delta < 0 ? n.right : n.left;
  radius_collect(t, near, q, r2, out);
  if (delta * delta <= r2) radius_collect(t, far, q, r2, out);
}

}  // namespace

extern "C" {

// Build a persistent tree over (n,3) f32 points; returns an opaque handle.
void* kdtree_build(const float* points, int64_t n) {
  OwnedTree* o = new OwnedTree();
  o->pts.assign(points, points + n * 3);
  o->tree.pts = o->pts.data();
  std::vector<int32_t> ids(n);
  for (int64_t i = 0; i < n; ++i) ids[i] = static_cast<int32_t>(i);
  o->tree.nodes.reserve(n);
  o->tree.root = o->tree.build(ids, 0, static_cast<int>(n), 0);
  return o;
}

void kdtree_free(void* handle) { delete static_cast<OwnedTree*>(handle); }

// kNN against a persistent tree (same output layout as kdtree_knn).
void kdtree_query(void* handle, const float* queries, int64_t m, int32_t k,
                  int32_t* out_idx, float* out_d2) {
  OwnedTree* o = static_cast<OwnedTree*>(handle);
  std::vector<float> hd(k);
  std::vector<int32_t> hi(k);
  for (int64_t qi = 0; qi < m; ++qi) {
    Heap heap{hd.data(), hi.data(), k, 0};
    search(o->tree, o->tree.root, queries + qi * 3, heap);
    std::vector<std::pair<float, int32_t>> items(heap.n);
    for (int j = 0; j < heap.n; ++j) items[j] = {hd[j], hi[j]};
    std::sort(items.begin(), items.end());
    for (int j = 0; j < k; ++j) {
      int src = j < heap.n ? j : heap.n - 1;
      out_idx[qi * k + j] = items[src].second;
      out_d2[qi * k + j] = items[src].first;
    }
  }
}

// All points within radius r of query (sorted by distance ascending,
// truncated to max_out). Returns the number written.
int64_t kdtree_radius(void* handle, const float* query, float r,
                      int64_t max_out, int32_t* out_idx, float* out_d2) {
  OwnedTree* o = static_cast<OwnedTree*>(handle);
  std::vector<std::pair<float, int32_t>> items;
  radius_collect(o->tree, o->tree.root, query, r * r, items);
  std::sort(items.begin(), items.end());
  int64_t cnt = std::min<int64_t>(items.size(), max_out);
  for (int64_t j = 0; j < cnt; ++j) {
    out_idx[j] = items[j].second;
    out_d2[j] = items[j].first;
  }
  return cnt;
}

}  // extern "C"
