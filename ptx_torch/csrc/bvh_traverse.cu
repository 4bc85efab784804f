// The stackless BVH walk: one thread per ray follows the escape links.
//
// Replaces: ptx/accel/traverse.py::_make_traverse (the closest and the any
// walk, a jax.lax.while_loop per ray under vmap, which XLA compiles to one
// device loop) and ::node_visits (the walk without leaf tests that counts
// the nodes visited).  Plain version: ptx_torch/accel/traverse.py, which
// this kernel equals bit for bit on every output.
//
// Per ray: node = 0; while node >= 0 and steps < max_steps (and, for the
// any walk, no hit yet):
//   the slab test of box `node` against 1 / d (correctly rounded);
//     per axis t0 = (lo - o) * inv, t1 = (hi - o) * inv; an axis where
//     either is NaN drops out (the plain version's NaN-propagating
//     min / max, then NaN -> -inf / +inf), so fminf / fmaxf, which drop a
//     NaN, never see one;
//   box = far >= max(near, 0) and near < best_t (the visits walk: no best);
//   a leaf (count > 0) whose box is hit: Moller-Trumbore on its triangles
//     first .. first + min(count, leaf_size) - 1 (indices clamped to the
//     last triangle, as a JAX gather clamps), written as the plain
//     version's torch ops (each cross term its own product, dots summed
//     (x + y) + z, 1 / det correctly rounded; -fmad=false keeps nvcc from
//     fusing), a triangle replacing the best only on a strictly smaller t:
//     the leaf's first least t, kept when it beats the best;
//   node = box and not a leaf ? node + 1 : miss[node]; ++steps.
// Node indices are clamped into the array as the plain version clamps them.
//
// Design: correctness first.  The node and triangle arrays are read through
// __ldg; no stack, no shared memory, no persistent threads, no node
// packing.  The rays may be strided rows (the fused step's shadow rays are
// columns 0:3 and 3:6 of its [R, 8] rows).
// Bound on the card: 34 operations per node visited (slab test) and 58 per
// triangle tested (Moller-Trumbore), and the rays, the results and the node
// and triangle arrays once (chip_smoke.py's SLAB_OPS / MT_OPS); on
// arch:300000 the byte side bounds it, and the walk runs at 2-10 % of that
// bound (PERF.md): one dependent node load after another, and threads of a
// warp on different paths, not bandwidth, are what hold it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;                         // threads per CTA
constexpr float INF_T = 3.0e38f;                // geometry.INF
constexpr float NEG_EPS = -1.0e-4f;             // float32(-EPS)
constexpr float ONE_EPS = (float)(1.0 + 1.0e-4);  // float32(1 + EPS)

enum Mode { CLOSEST = 0, ANY = 1, VISITS = 2 };

}  // namespace

// The scene's BVH and triangles (ctypes mirror: traverse_cuda._BvhArgs).
struct BvhArgs {
  const float* lo;     // [n_nodes, 3]
  const float* hi;     // [n_nodes, 3]
  const int* first;    // [n_nodes]
  const int* count;    // [n_nodes], 0 = interior
  const int* miss;     // [n_nodes], escape link, -1 = end
  const float* a;      // [n_tris, 3]
  const float* e1;     // [n_tris, 3]
  const float* e2;     // [n_tris, 3]
  int n_nodes;
  int n_tris;
  int leaf_size;
  int max_steps;
};

namespace {

struct Out {
  float* t;
  int* tri;
  float* beta;
  float* gamma;
  uint8_t* hit;
  int* steps;
};

__device__ __forceinline__ float3 ld3(const float* p, long long i) {
  return make_float3(__ldg(p + 3 * i), __ldg(p + 3 * i + 1),
                     __ldg(p + 3 * i + 2));
}

// One axis of the slab test; a NaN distance leaves near / far as they are.
__device__ __forceinline__ void slab(float lo, float hi, float o, float inv,
                                     float& near, float& far) {
  const float t0 = (lo - o) * inv, t1 = (hi - o) * inv;
  if (t0 != t0 || t1 != t1) return;
  near = fmaxf(near, fminf(t0, t1));
  far = fminf(far, fmaxf(t0, t1));
}

// geometry.moller_trumbore: t (INF where no hit), beta, gamma.
__device__ __forceinline__ float moller_trumbore(float3 o, float3 d, float3 a,
                                                 float3 e1, float3 e2,
                                                 float& beta, float& gamma) {
  const float px = d.y * e2.z - d.z * e2.y;
  const float py = d.z * e2.x - d.x * e2.z;
  const float pz = d.x * e2.y - d.y * e2.x;
  const float det = e1.x * px + e1.y * py + e1.z * pz;
  const bool degenerate = det == 0.0f;
  const float inv_det = __frcp_rn(degenerate ? 1.0f : det);
  const float tx = o.x - a.x, ty = o.y - a.y, tz = o.z - a.z;
  beta = (tx * px + ty * py + tz * pz) * inv_det;
  const float qx = ty * e1.z - tz * e1.y;
  const float qy = tz * e1.x - tx * e1.z;
  const float qz = tx * e1.y - ty * e1.x;
  gamma = (d.x * qx + d.y * qy + d.z * qz) * inv_det;
  const float t = (e2.x * qx + e2.y * qy + e2.z * qz) * inv_det;
  const bool ok = beta >= NEG_EPS && beta <= ONE_EPS && gamma >= NEG_EPS &&
                  beta + gamma <= ONE_EPS && t >= 0.0f && isfinite(t) &&
                  !degenerate;
  return ok ? t : INF_T;
}

template <int MODE>
__global__ void __launch_bounds__(NT)
bvh_walk_kernel(const float* __restrict__ orig, long long orig_stride,
                const float* __restrict__ dirn, long long dirn_stride,
                int n_rays, BvhArgs bvh, Out out) {
  const int r = blockIdx.x * NT + threadIdx.x;
  if (r >= n_rays) return;
  const float* po = orig + r * orig_stride;
  const float* pd = dirn + r * dirn_stride;
  const float3 o = make_float3(po[0], po[1], po[2]);
  const float3 d = make_float3(pd[0], pd[1], pd[2]);
  const float3 inv = make_float3(__frcp_rn(d.x), __frcp_rn(d.y), __frcp_rn(d.z));

  float best_t = INF_T, best_b = 0.0f, best_g = 0.0f;
  int best_tri = 0, node = 0, steps = 0;
  while (node >= 0 && steps < bvh.max_steps &&
         (MODE != ANY || best_t >= INF_T)) {
    const int nd = min(node, bvh.n_nodes - 1);
    const float3 lo = ld3(bvh.lo, nd), hi = ld3(bvh.hi, nd);
    float near = -INFINITY, far = INFINITY;
    slab(lo.x, hi.x, o.x, inv.x, near, far);
    slab(lo.y, hi.y, o.y, inv.y, near, far);
    slab(lo.z, hi.z, o.z, inv.z, near, far);
    bool box = far >= fmaxf(near, 0.0f);
    const int count = __ldg(bvh.count + nd);
    bool descend;
    if (MODE == VISITS) {
      descend = box && count == 0;
    } else {
      box = box && near < best_t;
      descend = box && !(count > 0);
      if (box && count > 0) {
        const int first = __ldg(bvh.first + nd);
        const int n = min(count, bvh.leaf_size);
        for (int i = 0; i < n; ++i) {
          const int idx = min(first + i, bvh.n_tris - 1);
          float b, g;
          const float t = moller_trumbore(o, d, ld3(bvh.a, idx),
                                          ld3(bvh.e1, idx), ld3(bvh.e2, idx),
                                          b, g);
          if (t < best_t) {
            best_t = t;
            best_tri = idx;
            best_b = b;
            best_g = g;
            if (MODE == ANY) break;
          }
        }
      }
    }
    node = descend ? node + 1 : __ldg(bvh.miss + nd);
    ++steps;
  }
  if (MODE == CLOSEST) {
    out.t[r] = best_t;
    out.tri[r] = best_tri;
    out.beta[r] = best_b;
    out.gamma[r] = best_g;
    out.hit[r] = best_t < INF_T;
  } else if (MODE == ANY) {
    out.hit[r] = best_t < INF_T;
  } else {
    out.steps[r] = steps;
  }
}

template <int MODE>
int launch(const float* orig, long long orig_stride, const float* dirn,
           long long dirn_stride, int n_rays, const BvhArgs* bvh, Out out,
           void* stream) {
  if (n_rays < 1 || bvh->n_nodes < 1 || bvh->n_tris < 1 ||
      bvh->leaf_size < 1)
    return (int)cudaErrorInvalidValue;
  bvh_walk_kernel<MODE><<<(n_rays + NT - 1) / NT, NT, 0,
                          (cudaStream_t)stream>>>(orig, orig_stride, dirn,
                                                  dirn_stride, n_rays, *bvh,
                                                  out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ptx_bvh_closest(const float* orig, long long orig_stride,
                               const float* dirn, long long dirn_stride,
                               int n_rays, const BvhArgs* bvh, float* t,
                               int* tri, float* beta, float* gamma,
                               uint8_t* hit, void* stream) {
  return launch<CLOSEST>(orig, orig_stride, dirn, dirn_stride, n_rays, bvh,
                         Out{t, tri, beta, gamma, hit, nullptr}, stream);
}

extern "C" int ptx_bvh_any(const float* orig, long long orig_stride,
                           const float* dirn, long long dirn_stride,
                           int n_rays, const BvhArgs* bvh, uint8_t* hit,
                           void* stream) {
  return launch<ANY>(orig, orig_stride, dirn, dirn_stride, n_rays, bvh,
                     Out{nullptr, nullptr, nullptr, nullptr, hit, nullptr},
                     stream);
}

extern "C" int ptx_bvh_visits(const float* orig, long long orig_stride,
                              const float* dirn, long long dirn_stride,
                              int n_rays, const BvhArgs* bvh, int* steps,
                              void* stream) {
  return launch<VISITS>(orig, orig_stride, dirn, dirn_stride, n_rays, bvh,
                        Out{nullptr, nullptr, nullptr, nullptr, nullptr, steps},
                        stream);
}
