// Exact per-ray slab gate of the tile traversal plan.
//
// Replaces: ptx/kernels/intersect_pallas.py::_exact_gate_kernel (launched by
// _exact_gate_pallas from _plan_tiles when the scene has at most
// FRUSTUM_PLAN_TILES tiles).
//
// Computes, for every 128-ray block b and tile box t:
//   gated[b, t] = any ray of the block enters the box (far >= max(near, 0))
//   near[b, t]  = the least entry distance max(near, 0) over those rays,
//                 3e38 when none enters.
// The output equals the plain torch version (_exact_gate) bit for bit:
// IEEE reciprocal (no fast math), NaN slabs replaced by -inf/+inf before
// the min/max as jnp.minimum/maximum would propagate them, and the entry
// distance written as (near > 0 ? near : 0) so -0 and +0 never differ.
//
// Bound on the card: R x T slab tests of ~20 instructions each (17.5M tests
// for a 32,768-ray launch against arch:300000's 534 tiles); rays and boxes
// are kilobytes, so the kernel is bound by issue and latency, not memory.
// Design: one CTA per (128-ray block, chunk of 128 tiles).  The block's
// origins and reciprocal directions sit in shared memory (every thread reads
// the same ray at once: a broadcast), each thread owns one tile box and
// loops over the 128 rays, so the per-block reduction stays in registers and
// each output is written once, with no atomics.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int RB = 128;          // rays per block
constexpr int GATE_TILES = 128;  // tile boxes per CTA (one per thread)
constexpr float MISS = 3.0e38f;  // INF of the JAX package

__global__ void __launch_bounds__(RB)
exact_gate_kernel(const float* __restrict__ rays,
                  const float* __restrict__ boxes, int n_tiles,
                  uint8_t* __restrict__ gated, float* __restrict__ near_out) {
  __shared__ float s_o[3][RB];
  __shared__ float s_inv[3][RB];
  const int blk = blockIdx.y;
  const int tid = threadIdx.x;
  const float* r = rays + (size_t)(blk * RB + tid) * 8;
  for (int a = 0; a < 3; ++a) {
    s_o[a][tid] = r[a];
    s_inv[a][tid] = 1.0f / r[3 + a];
  }
  __syncthreads();

  const int tile = blockIdx.x * GATE_TILES + tid;
  if (tile >= n_tiles) return;
  const float* b = boxes + (size_t)tile * 8;
  const float lo[3] = {b[0], b[1], b[2]};
  const float hi[3] = {b[3], b[4], b[5]};

  bool any = false;
  float best = MISS;
  for (int i = 0; i < RB; ++i) {
    float near = -INFINITY;
    float far = INFINITY;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float t0 = (lo[a] - s_o[a][i]) * s_inv[a][i];
      const float t1 = (hi[a] - s_o[a][i]) * s_inv[a][i];
      const bool nan = isnan(t0) || isnan(t1);
      const float tl = nan ? -INFINITY : fminf(t0, t1);
      const float th = nan ? INFINITY : fmaxf(t0, t1);
      near = fmaxf(near, tl);
      far = fminf(far, th);
    }
    const float enter = near > 0.0f ? near : 0.0f;
    if (far >= enter) {
      any = true;
      best = fminf(best, enter);
    }
  }
  const size_t out = (size_t)blk * n_tiles + tile;
  gated[out] = any ? 1 : 0;
  near_out[out] = best;
}

}  // namespace

// rays [n_blocks * 128, 8] f32, boxes [n_tiles, 8] f32 (lo 0-2, hi 3-5)
// -> gated [n_blocks, n_tiles] u8 (torch.bool), near [n_blocks, n_tiles] f32.
extern "C" int ptx_exact_gate(const float* rays, const float* boxes,
                              int n_blocks, int n_tiles, uint8_t* gated,
                              float* near_out, void* stream) {
  const dim3 grid((n_tiles + GATE_TILES - 1) / GATE_TILES, n_blocks);
  exact_gate_kernel<<<grid, RB, 0, (cudaStream_t)stream>>>(
      rays, boxes, n_tiles, gated, near_out);
  return (int)cudaGetLastError();
}
