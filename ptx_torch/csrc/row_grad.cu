// The backward of a gather of table rows: the gradient rows [R, C] summed
// into [M, C] by the row each was gathered from (out[idx[r]] += grad[r]).
//
// Replaces no Pallas kernel: in ptx this sum is XLA's transpose of the
// gather of ptx/scene/textures.py::material_lookup.  Added because
// autograd's own backward of that gather (index_put_ with accumulate) sorts
// the ids and then gives each run of equal ids to one group of threads, which
// adds the run up serially; a scene has a handful of materials, so a
// wavefront's thousands of rows form a handful of runs and the sum runs
// thousands of times slower than the card reads the gradient.
//
// Bound on the card: bytes.  The gradient and the ids are read once (R * (4C
// + 8) bytes), the result is M * C floats; there are R * C additions.
//
// Design: two deterministic passes, no sort and no float atomics, so every
// run gives the same bits and a CUDA graph can capture the call (no host
// sync, nothing sized from data).
//   row_grad_blocks_kernel: a fixed grid set by R and C walks the rows.  A
//     block of THREADS threads is G = THREADS / C groups of C threads; block
//     b holds rows [b * per_block, + per_block), per_block a multiple of G,
//     and group g of it rows r = g, g + G, ... of that span (r % G == g), so
//     a warp reads whole neighbouring rows (for C = 16 a half-warp covers a
//     row and a warp 128 bytes).  Thread (g, c) adds column c of its rows in
//     row order into its own [M] column of the group's [M, C] slice in shared
//     memory (no two threads touch one float).  The block then sums its G
//     slices in group order into one [M, C] partial.
//   row_grad_sum_kernel: one warp per element of [M, C]; lane l sums the
//     partials of blocks l, l + 32, ... in order, and the lanes are summed by
//     a fixed butterfly (__shfl_down_sync, 16, 8, 4, 2, 1).
// Every sum starts from 0.0f.  The plain torch version
// (kernels/gather_cuda.py::row_grad_plain) takes the same sums in the same
// order, so the two agree bit for bit (-fmad=false plays no part: there
// are only additions).  Negative ids wrap by M, as torch's indexing does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int LANES = 32;
constexpr int STATIC_SHARED = 48 * 1024;

__global__ void __launch_bounds__(THREADS)
row_grad_blocks_kernel(const float* __restrict__ grad,
                       const long long* __restrict__ idx, long long rows,
                       int m, int c, int groups, long long per_block,
                       float* __restrict__ partial) {
  extern __shared__ float slices[];  // [groups][m][c]
  const int mc = m * c;
  const int t = threadIdx.x;
  for (int e = t; e < groups * mc; e += THREADS) slices[e] = 0.0f;
  __syncthreads();
  if (t < groups * c) {
    const int g = t / c;
    const int col = t - g * c;
    float* slice = slices + g * mc + col;
    const long long start = (long long)blockIdx.x * per_block;
    const long long end = start + per_block < rows ? start + per_block : rows;
    for (long long r = start + g; r < end; r += groups) {
      long long id = idx[r];
      if (id < 0) id += m;
      slice[id * c] += grad[r * c + col];
    }
  }
  __syncthreads();
  float* out = partial + (long long)blockIdx.x * mc;
  for (int e = t; e < mc; e += THREADS) {
    float acc = 0.0f;
    for (int g = 0; g < groups; ++g) acc += slices[g * mc + e];
    out[e] = acc;
  }
}

__global__ void __launch_bounds__(THREADS)
row_grad_sum_kernel(const float* __restrict__ partial, int blocks, int mc,
                    float* __restrict__ out) {
  const int e = (blockIdx.x * THREADS + threadIdx.x) / LANES;
  const int lane = threadIdx.x % LANES;
  if (e >= mc) return;  // whole warps: THREADS is a multiple of LANES
  float acc = 0.0f;
  for (int b = lane; b < blocks; b += LANES) acc += partial[(long long)b * mc + e];
  for (int off = LANES / 2; off > 0; off /= 2)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) out[e] = acc;
}

}  // namespace

// grad [rows, c] float32, idx [rows] int64, partial [blocks, m, c] scratch,
// out [m, c]; groups = THREADS / c, per_block a multiple of groups, blocks =
// ceil(rows / per_block) >= 1 (kernels/gather_cuda.py::grid).
extern "C" int ptx_row_grad(const float* grad, const long long* idx,
                            long long rows, int m, int c, int groups,
                            long long per_block, int blocks, float* partial,
                            float* out, void* stream) {
  const size_t smem = (size_t)groups * m * c * sizeof(float);
  if (smem > STATIC_SHARED) {
    cudaError_t err = cudaFuncSetAttribute(
        row_grad_blocks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  row_grad_blocks_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      grad, idx, rows, m, c, groups, per_block, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int mc = m * c;
  row_grad_sum_kernel<<<(mc * LANES + THREADS - 1) / THREADS, THREADS, 0,
                        (cudaStream_t)stream>>>(partial, blocks, mc, out);
  return (int)cudaGetLastError();
}
