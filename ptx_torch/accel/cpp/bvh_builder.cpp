// Native binned-SAH BVH builder.
//
// The host-side build is the one place in this framework where native code
// genuinely pays: for million-triangle scenes the Python builder's recursion
// and per-node numpy passes dominate scene-load time.  This implements the
// same algorithm and produces the same flattened stackless layout as
// ptx_torch/accel/bvh.py (DFS order, escape links, leaf-contiguous triangle
// ranges); ptx_torch/accel/native.py loads it via ctypes with the numpy
// builder as fallback oracle.  The port's own copy of
// ptx/accel/cpp/bvh_builder.cpp.
//
// Semantics mirror the reference's SAH builder class
// (path_tracer_lib/path_tracer/core/mesh.cpp:131-247): cost = surface-area x
// count, leaf when no split beats the no-split cost -- re-expressed as a
// binned sweep over centroids instead of exact sorted events.
//
// Build: ptx_torch/accel/native.py runs g++ into ptx_torch/build/ on first use.

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Vec3 {
  float x, y, z;
};

static inline Vec3 vmin(const Vec3& a, const Vec3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline Vec3 vmax(const Vec3& a, const Vec3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}
static inline float surface(const Vec3& mn, const Vec3& mx) {
  float dx = std::max(mx.x - mn.x, 0.0f);
  float dy = std::max(mx.y - mn.y, 0.0f);
  float dz = std::max(mx.z - mn.z, 0.0f);
  return 2.0f * (dx * dy + dy * dz + dz * dx);
}
static inline float axis_of(const Vec3& v, int a) {
  return a == 0 ? v.x : (a == 1 ? v.y : v.z);
}

struct BuildNode {
  Vec3 bb_min, bb_max;
  int32_t first, count;  // triangle range (leaf) -- count 0 for interior
  int32_t left = -1, right = -1;
};

struct Builder {
  const Vec3* tri_min;
  const Vec3* tri_max;
  const Vec3* centroid;
  int leaf_size;
  int n_bins;
  std::vector<int32_t> order;
  std::vector<BuildNode> nodes;

  int build(int32_t first, int32_t count) {
    Vec3 mn = tri_min[order[first]];
    Vec3 mx = tri_max[order[first]];
    Vec3 cmn = centroid[order[first]];
    Vec3 cmx = cmn;
    for (int32_t i = 1; i < count; i++) {
      int32_t t = order[first + i];
      mn = vmin(mn, tri_min[t]);
      mx = vmax(mx, tri_max[t]);
      cmn = vmin(cmn, centroid[t]);
      cmx = vmax(cmx, centroid[t]);
    }
    int node_id = (int)nodes.size();
    nodes.push_back({mn, mx, first, count});
    if (count <= leaf_size) return node_id;

    float parent_area = surface(mn, mx);
    float leaf_cost = (float)count;
    float best_cost = FLT_MAX;
    int best_axis = -1;
    float best_thresh = 0.0f;

    std::vector<int32_t> bin_count(n_bins);
    std::vector<Vec3> bin_min(n_bins), bin_max(n_bins);
    std::vector<Vec3> lmn(n_bins), lmx(n_bins), rmn(n_bins), rmx(n_bins);
    std::vector<int32_t> lcount(n_bins);

    for (int axis = 0; axis < 3; axis++) {
      float c0 = axis_of(cmn, axis), c1 = axis_of(cmx, axis);
      float extent = c1 - c0;
      if (extent <= 1e-12f) continue;
      std::fill(bin_count.begin(), bin_count.end(), 0);
      for (int b = 0; b < n_bins; b++) {
        bin_min[b] = {FLT_MAX, FLT_MAX, FLT_MAX};
        bin_max[b] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
      }
      for (int32_t i = 0; i < count; i++) {
        int32_t t = order[first + i];
        float rel = (axis_of(centroid[t], axis) - c0) / extent;
        int b = std::min((int)(rel * n_bins), n_bins - 1);
        bin_count[b]++;
        bin_min[b] = vmin(bin_min[b], tri_min[t]);
        bin_max[b] = vmax(bin_max[b], tri_max[t]);
      }
      // prefix
      Vec3 amn = bin_min[0], amx = bin_max[0];
      int32_t acc = 0;
      for (int b = 0; b < n_bins; b++) {
        amn = vmin(amn, bin_min[b]);
        amx = vmax(amx, bin_max[b]);
        acc += bin_count[b];
        lmn[b] = amn;
        lmx[b] = amx;
        lcount[b] = acc;
      }
      // suffix
      Vec3 bmn = bin_min[n_bins - 1], bmx = bin_max[n_bins - 1];
      for (int b = n_bins - 1; b >= 0; b--) {
        bmn = vmin(bmn, bin_min[b]);
        bmx = vmax(bmx, bin_max[b]);
        rmn[b] = bmn;
        rmx[b] = bmx;
      }
      for (int b = 0; b < n_bins - 1; b++) {
        int32_t nl = lcount[b], nr = count - nl;
        if (nl == 0 || nr == 0) continue;
        float cost = (surface(lmn[b], lmx[b]) * nl +
                      surface(rmn[b + 1], rmx[b + 1]) * nr) /
                     std::max(parent_area, 1e-30f);
        if (cost < best_cost) {
          best_cost = cost;
          best_axis = axis;
          best_thresh = c0 + extent * (float)(b + 1) / n_bins;
        }
      }
    }

    if (best_axis < 0 || best_cost >= leaf_cost) return node_id;

    // Stable partition: left = centroids below threshold, original order kept
    // on both sides (matches the numpy builder's concatenate of idx[sel] and
    // idx[~sel]).
    auto mid = std::stable_partition(
        order.begin() + first, order.begin() + first + count,
        [&](int32_t t) { return axis_of(centroid[t], best_axis) < best_thresh; });
    int32_t n_left = (int32_t)(mid - (order.begin() + first));
    if (n_left == 0 || n_left == count) return node_id;

    nodes[node_id].left = build(first, n_left);
    nodes[node_id].right = build(first + n_left, count - n_left);
    nodes[node_id].count = 0;
    return node_id;
  }
};

void flatten_dfs(const std::vector<BuildNode>& nodes, float* bb_min,
                 float* bb_max, int32_t* first, int32_t* count,
                 int32_t* miss) {
  std::vector<int32_t> out_index(nodes.size());
  // Pass 1: DFS slot assignment (iterative).
  {
    int32_t slot = 0;
    std::vector<int32_t> stack{0};
    while (!stack.empty()) {
      int32_t id = stack.back();
      stack.pop_back();
      out_index[id] = slot++;
      const BuildNode& nd = nodes[id];
      if (nd.count == 0) {
        stack.push_back(nd.right);  // right pushed first -> left popped first
        stack.push_back(nd.left);
      }
    }
  }
  // Pass 2: fill data + escape links.
  {
    struct Item {
      int32_t id, miss_link;
    };
    std::vector<Item> stack{{0, -1}};
    while (!stack.empty()) {
      Item it = stack.back();
      stack.pop_back();
      const BuildNode& nd = nodes[it.id];
      int32_t i = out_index[it.id];
      std::memcpy(bb_min + 3 * i, &nd.bb_min, 12);
      std::memcpy(bb_max + 3 * i, &nd.bb_max, 12);
      miss[i] = it.miss_link;
      if (nd.count) {
        first[i] = nd.first;
        count[i] = nd.count;
      } else {
        first[i] = 0;
        count[i] = 0;
        stack.push_back({nd.right, it.miss_link});
        stack.push_back({nd.left, out_index[nd.right]});
      }
    }
  }
}

}  // namespace

extern "C" {

// Returns the node count, or -1 if max_nodes was too small.
int32_t ptx_build_bvh(const float* v0, const float* e1, const float* e2,
                      int32_t n_tris, int32_t leaf_size, int32_t n_bins,
                      int32_t max_nodes, int32_t* order_out, float* bb_min,
                      float* bb_max, int32_t* first, int32_t* count,
                      int32_t* miss) {
  std::vector<Vec3> tri_min(n_tris), tri_max(n_tris), centroid(n_tris);
  for (int32_t i = 0; i < n_tris; i++) {
    Vec3 a = {v0[3 * i], v0[3 * i + 1], v0[3 * i + 2]};
    Vec3 b = {a.x + e1[3 * i], a.y + e1[3 * i + 1], a.z + e1[3 * i + 2]};
    Vec3 c = {a.x + e2[3 * i], a.y + e2[3 * i + 1], a.z + e2[3 * i + 2]};
    tri_min[i] = vmin(vmin(a, b), c);
    tri_max[i] = vmax(vmax(a, b), c);
    centroid[i] = {(a.x + b.x + c.x) / 3.0f, (a.y + b.y + c.y) / 3.0f,
                   (a.z + b.z + c.z) / 3.0f};
  }

  Builder builder;
  builder.tri_min = tri_min.data();
  builder.tri_max = tri_max.data();
  builder.centroid = centroid.data();
  builder.leaf_size = leaf_size;
  builder.n_bins = n_bins;
  builder.order.resize(n_tris);
  for (int32_t i = 0; i < n_tris; i++) builder.order[i] = i;
  builder.nodes.reserve(2 * n_tris / std::max(leaf_size, 1) + 16);
  builder.build(0, n_tris);

  int32_t n_nodes = (int32_t)builder.nodes.size();
  if (n_nodes > max_nodes) return -1;
  std::memcpy(order_out, builder.order.data(), sizeof(int32_t) * n_tris);
  flatten_dfs(builder.nodes, bb_min, bb_max, first, count, miss);
  return n_nodes;
}
}
