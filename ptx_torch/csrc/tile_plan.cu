// The tile traversal plan in one launch: the exact gate and its per-block
// sort.
//
// Replaces: ptx/kernels/intersect_pallas.py::_exact_gate_kernel (launched by
// _exact_gate_pallas from _plan_tiles when the scene has at most
// FRUSTUM_PLAN_TILES = 4096 tiles) and the jax.lax.sort_key_val that
// _plan_tiles runs on its output.
//
// For every 128-ray block b it writes the plan of tiles.sort_plan:
//   order [B, T] i32    tiles front to back by the block's least entry
//                       distance, equal distances by tile id; the slots past
//                       count repeat order[max(count - 1, 0)];
//   count [B] i32       the tiles that some ray of the block enters;
//   near [B, T + 1] f32 the sorted entry distances, 3e38 in the extra column;
// bit for bit equal to sort_plan(_exact_gate(rays, boxes)) (intersect_cuda.py).
//
// The gate of ray r and box t: slab tests per axis with the IEEE reciprocal
// 1 / d; an axis whose t0 or t1 is NaN drops out (_exact_gate turns a NaN
// min / max into -inf / +inf); the ray enters when far >= enter, with enter
// = (near > 0 ? near : 0), never -0 and never NaN.  The block's distance is
// the least of (enters ? enter : 3e38) over its 128 rays, and the tile is
// gated when some ray enters.
//
// The sort key of tile t is (bits(distance) << 32) | (t << 1) | !gated.  The
// distance is never negative, NaN or -0, so its bits order as the floats do;
// the tile id makes the keys of a row distinct, so any sort of them gives
// torch.sort(stable=True) of the distances, ties included (0 for every box
// that holds a ray origin, 3e38 for every tile no ray enters): here the
// slot of a key is its rank, the number of keys below it.  The flag bit
// below the tile id only carries `gated`, for the count.
//
// Design.  The main path plans 8,192-ray chunks (64 blocks) against ~500
// tiles.  The former gate kernel ran one thread per box over all 128 rays in
// 4-warp CTAs, and left the sort to a dozen torch ops, each a launch.  Here:
// * a cluster of PLAN_CLUSTER = 8 CTAs per ray block (grid n_blocks * 8, so
//   a 64-block chunk is 512 CTAs for 132 SMs): CTA `rank` gates the tiles
//   [rank * slice, +slice), slice = ceil(T / 8);
// * SPLIT = 8 neighbouring threads per tile, each testing 16 of the 128 rays
//   (origins and reciprocals in shared memory, computed once per CTA; a warp
//   load reads 8 consecutive rays), combined with shuffles; the box stays in
//   registers;
// * the 8 threads of a tile push its key into the shared memory of all 8
//   CTAs (st.shared::cluster), then one cluster barrier;
// * each CTA ranks the keys of its own slice against all T keys (broadcast
//   shared loads, partial counts added in shared memory) and writes near
//   and order at each key's rank; the owner of rank count - 1 pushes its
//   tile to every CTA, and after a second cluster barrier the CTAs fill the
//   order slots past count with it.  Every output is written once.
// Timed against two alternatives on an H100 (ab_trees.py, PERF.md): with
// rank 0 bitonic-sorting the keys padded to a power of two the launch took
// 39.0 us on a 64-block chunk against this design's 18.9; a gate kernel and
// a per-block sort kernel took 22.8, but 44 against 50 on the 240-block
// launch of a 640x480 frame and 46 against 53 at 256 blocks.
// Bound on the card: the slab tests, ~28 operations each, R x T of them
// (4.4M for a 64-block chunk against 534 tiles); rays, boxes and the plan
// are a few hundred kilobytes.  The ranking adds T^2 / 8 key comparisons
// per CTA.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int RB = 128;                // rays per block
constexpr int PLAN_CLUSTER = 8;        // CTAs per ray block
constexpr int NT = 256;                // threads per CTA
constexpr int SPLIT = 8;               // threads per tile
constexpr int TILES_PER_PASS = NT / SPLIT;
constexpr int MAX_TILES = 4096;        // FRUSTUM_PLAN_TILES
constexpr int MAX_SLICE = MAX_TILES / PLAN_CLUSTER;
constexpr int RANK_CHUNK = 64;         // keys compared per rank item
constexpr float MISS = 3.0e38f;        // INF of the JAX package
static_assert(32 % SPLIT == 0 && RB % SPLIT == 0,
              "a tile's threads share a warp and split the rays evenly");
static_assert(SPLIT == PLAN_CLUSTER, "thread `sub` of a tile feeds CTA `sub`");

// min / max that return NaN when either input is NaN (PTX .NaN).
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The shared::cluster address of `p`'s counterpart in CTA `rank`.
__device__ __forceinline__ uint32_t peer_addr(const void* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(a)
               : "r"(smem_addr(p)), "r"(rank));
  return a;
}

__device__ __forceinline__ void store_peer(uint32_t addr, uint64_t v) {
  asm volatile("st.shared::cluster.u64 [%0], %1;" ::"r"(addr), "l"(v)
               : "memory");
}

__device__ __forceinline__ void store_peer(uint32_t addr, int v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;" ::"r"(addr), "r"(v)
               : "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// This thread's part of the gate of box (lo, hi): rays sub, sub + SPLIT, ...
// of the block.  `best` takes the least (enters ? enter : MISS), `any` the
// OR of enters.  The NaN-keeping min / max per axis, then the NaN-dropping
// fmaxf / fminf across axes, drop an axis whose t0 or t1 is NaN; when all
// three are NaN, near is NaN (enter 0) and far is NaN (!(far < enter)
// holds), as _exact_gate's -inf / +inf give.
__device__ __forceinline__ void gate_part(const float4* s_o,
                                          const float4* s_inv, int sub,
                                          const float (&lo)[3],
                                          const float (&hi)[3], float& best,
                                          bool& any) {
#pragma unroll 4
  for (int ii = 0; ii < RB / SPLIT; ++ii) {
    const float4 o = s_o[sub + ii * SPLIT], inv = s_inv[sub + ii * SPLIT];
    const float t0x = (lo[0] - o.x) * inv.x, t1x = (hi[0] - o.x) * inv.x;
    const float t0y = (lo[1] - o.y) * inv.y, t1y = (hi[1] - o.y) * inv.y;
    const float t0z = (lo[2] - o.z) * inv.z, t1z = (hi[2] - o.z) * inv.z;
    const float near = fmaxf(fmaxf(min_nan(t0x, t1x), min_nan(t0y, t1y)),
                             min_nan(t0z, t1z));
    const float far = fminf(fminf(max_nan(t0x, t1x), max_nan(t0y, t1y)),
                            max_nan(t0z, t1z));
    const float enter = near > 0.0f ? near : 0.0f;
    const bool in = !(far < enter);
    any |= in;
    best = fminf(best, in ? enter : MISS);
  }
}

__global__ void __cluster_dims__(PLAN_CLUSTER, 1, 1) __launch_bounds__(NT)
tile_plan_kernel(const float* __restrict__ rays,
                 const float* __restrict__ boxes, int n_tiles,
                 int* __restrict__ order, int* __restrict__ count,
                 float* __restrict__ near) {
  extern __shared__ __align__(16) uint64_t s_keys[];  // [n_tiles], all keys
  __shared__ __align__(16) float4 s_o[RB];
  __shared__ __align__(16) float4 s_inv[RB];
  __shared__ int s_rank[MAX_SLICE];      // ranks of this CTA's keys
  __shared__ int s_gated[PLAN_CLUSTER];  // gated tiles of each CTA
  __shared__ int s_last;                 // the tile at rank count - 1

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int blk = blockIdx.x / PLAN_CLUSTER;
  const int tid = threadIdx.x;
  const int slice = (n_tiles + PLAN_CLUSTER - 1) / PLAN_CLUSTER;
  const int first = min(n_tiles, rank * slice);
  const int end = min(n_tiles, first + slice);
  const int n_own = end - first;
  // Every CTA of the cluster has started by the matching wait, so its
  // shared memory may then be written by its peers.
  cluster_arrive_relaxed();

  if (tid < RB) {
    const float* r = rays + ((size_t)blk * RB + tid) * 8;
    s_o[tid] = make_float4(r[0], r[1], r[2], 0.0f);
    s_inv[tid] = make_float4(1.0f / r[3], 1.0f / r[4], 1.0f / r[5], 0.0f);
  }
  for (int i = tid; i < n_own; i += NT) s_rank[i] = 0;
  __syncthreads();
  cluster_wait();

  const int sub = tid % SPLIT;
  const uint32_t keys_sub = peer_addr(s_keys, sub);  // CTA `sub`'s keys
  int gated = 0;
  for (int base = first; base < end; base += TILES_PER_PASS) {  // uniform
    const int tile = base + tid / SPLIT;
    const bool valid = tile < end;
    float best = INFINITY;
    bool any = false;
    if (valid) {
      const float* b = boxes + (size_t)tile * 8;
      const float lo[3] = {b[0], b[1], b[2]};
      const float hi[3] = {b[3], b[4], b[5]};
      gate_part(s_o, s_inv, sub, lo, hi, best, any);
    }
#pragma unroll
    for (int off = SPLIT / 2; off > 0; off >>= 1) {
      best = fminf(best, __shfl_xor_sync(0xffffffffu, best, off));
      any |= __shfl_xor_sync(0xffffffffu, (int)any, off) != 0;
    }
    // Every thread of the tile holds its key; thread `sub` gives it to CTA
    // `sub` (SPLIT == PLAN_CLUSTER).
    if (valid)
      store_peer(keys_sub + 8u * (uint32_t)tile,
                 ((uint64_t)__float_as_uint(best) << 32) |
                     ((uint32_t)tile << 1) | (any ? 0u : 1u));
    gated += __syncthreads_count(valid && sub == 0 && any);
  }
  if (tid < PLAN_CLUSTER) store_peer(peer_addr(&s_gated[rank], tid), gated);
  cluster_sync();  // every CTA holds every key and count

  int n = 0;
#pragma unroll
  for (int r = 0; r < PLAN_CLUSTER; ++r) n += s_gated[r];
  // Ranks of this CTA's keys: item (key i, chunk c of RANK_CHUNK keys);
  // neighbouring threads take neighbouring keys of one chunk, so a warp's
  // loads of s_keys[j] are broadcasts.
  const int n_chunks = (n_tiles + RANK_CHUNK - 1) / RANK_CHUNK;
  for (int it = tid; it < n_own * n_chunks; it += NT) {
    const int i = it % n_own, c = it / n_own;
    const uint64_t key = s_keys[first + i];
    const int j0 = c * RANK_CHUNK, j1 = min(n_tiles, j0 + RANK_CHUNK);
    int below = 0;
#pragma unroll 8
    for (int j = j0; j < j1; ++j) below += s_keys[j] < key;
    atomicAdd(&s_rank[i], below);
  }
  __syncthreads();

  int* ord = order + (size_t)blk * n_tiles;
  float* nr = near + (size_t)blk * (n_tiles + 1);
  const int last = n > 0 ? n - 1 : 0;
  for (int i = tid; i < n_own; i += NT) {
    const uint64_t key = s_keys[first + i];
    const int r = s_rank[i], tile = (int)((uint32_t)key >> 1);
    nr[r] = __uint_as_float((uint32_t)(key >> 32));
    if (r < n) ord[r] = tile;
    if (r == last)
      for (int p = 0; p < PLAN_CLUSTER; ++p)
        store_peer(peer_addr(&s_last, p), tile);
  }
  cluster_sync();  // s_last is set in every CTA
  for (int k = n + rank * NT + tid; k < n_tiles; k += PLAN_CLUSTER * NT)
    ord[k] = s_last;
  if (rank == 0 && tid == 0) {
    nr[n_tiles] = MISS;
    count[blk] = n;
  }
}

}  // namespace

// rays [n_blocks * 128, 8] f32, boxes [n_tiles, 8] f32 (lo 0-2, hi 3-5),
// 1 <= n_tiles <= 4096 -> order [n_blocks, n_tiles] i32, count [n_blocks]
// i32, near [n_blocks, n_tiles + 1] f32.
extern "C" int ptx_tile_plan(const float* rays, const float* boxes,
                             int n_blocks, int n_tiles, int* order,
                             int* count, float* near, void* stream) {
  if (n_tiles < 1 || n_tiles > MAX_TILES || n_blocks < 1 ||
      n_blocks > INT_MAX / PLAN_CLUSTER)
    return (int)cudaErrorInvalidValue;
  tile_plan_kernel<<<n_blocks * PLAN_CLUSTER, NT, n_tiles * sizeof(uint64_t),
                     (cudaStream_t)stream>>>(rays, boxes, n_tiles, order, count,
                                             near);
  return (int)cudaGetLastError();
}
