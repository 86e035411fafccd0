// Dense nearest neighbour, one direction: for each point of p, the squared
// distance to its nearest point of q and that point's index, ties to the
// lowest index.
//
// Replaces the TPU kernels pytorch_points_tpu/kernels/distance_tiles.py::
// _nn_both_kernel (nn_both_directions, the dense chamfer scan) and ::
// _nn_kernel (nn_one_direction). The TPU fuses both directions into one
// pass because its grid runs in order on one core and can carry the
// direction-2 minimum across grid steps; Hopper blocks run in no order, so
// nn_both_directions is two launches of this kernel, p -> q and q -> p.
//
// Semantics: d in the reference's order ((dx*dx + dy*dy) + dz*dz), each
// operation rounded on its own (ppt::sqdist3); the scan visits q in index
// order and takes a point only when strictly closer, so the lowest index
// wins a tie, as the reference's chunk-min then strict-< fold does. Start
// (inf, 0), as the reference's accumulators do. Masked points arrive
// poisoned by the op; the kernel bounds its ragged edges itself (no
// padding).
//
// On the card: one thread per p point; a block of 256 p points stages q in
// shared-memory tiles, read by every thread as a broadcast. It is bound by
// the distance arithmetic and compare (about 10 flops per (p, q) pair):
// N M pairs per direction, all of them, with no pruning (that is K6).
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;

__global__ void __launch_bounds__(kThreads)
    nn_dense_kernel(const float* __restrict__ p, const float* __restrict__ q,
                    int n, int m, float* __restrict__ out_d,
                    int* __restrict__ out_i) {
  __shared__ float tile[kTile * 3];
  const int b = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool active = i < n;
  const float* qb = q + static_cast<size_t>(b) * m * 3;
  const size_t row = static_cast<size_t>(b) * n + i;

  float px = 0.f, py = 0.f, pz = 0.f;
  if (active) {
    px = p[3 * row];
    py = p[3 * row + 1];
    pz = p[3 * row + 2];
  }
  float best = INFINITY;
  int best_i = 0;
  for (int base = 0; base < m; base += kTile) {
    const int len = min(kTile, m - base);
    __syncthreads();
    for (int t = threadIdx.x; t < 3 * len; t += kThreads)
      tile[t] = qb[3 * static_cast<size_t>(base) + t];
    __syncthreads();
    if (active) {
      for (int t = 0; t < len; ++t) {
        const float d = ppt::sqdist3(tile[3 * t], tile[3 * t + 1],
                                     tile[3 * t + 2], px, py, pz);
        if (d < best) {
          best = d;
          best_i = base + t;
        }
      }
    }
  }
  if (active) {
    out_d[row] = best;
    out_i[row] = best_i;
  }
}

}  // namespace

// p: float [B, N, 3]; q: float [B, M, 3]; out_d: float [B, N]; out_i: int
// [B, N].
extern "C" int ppt_nn_dense(const float* p, const float* q, int b, int n,
                            int m, float* out_d, int* out_i,
                            cudaStream_t stream) {
  if (b == 0 || n == 0) return cudaSuccess;
  const dim3 grid((n + kThreads - 1) / kThreads, b);
  nn_dense_kernel<<<grid, kThreads, 0, stream>>>(p, q, n, m, out_d, out_i);
  return cudaGetLastError();
}
