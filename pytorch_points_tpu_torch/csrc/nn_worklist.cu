// Worklist nearest neighbour: for each row of one cloud, the nearest point
// of the other cloud among the column tiles its row tile is paired with in
// a compacted list of candidate tile pairs.
//
// Replaces the TPU kernel pytorch_points_tpu/kernels/distance_tiles.py::
// _nn_worklist_kernel (_run_worklist, via nn_both_directions_pruned). The
// TPU walks the i-major list of (p-tile, q-tile) pairs as one sequential
// grid and carries both directions' minima in scratch from step to step;
// Hopper blocks run in no order, so the port makes two launches of this
// kernel, as the dense NN (K5) does: p rows against the i-major list, then
// q rows against the same pairs re-sorted j-major. A pair list sorted by
// row tile gives each row tile one contiguous run, found by binary search.
//
// Semantics: the list holds codes row_tile * n_col_tiles + col_tile,
// ascending, and only its first min(count, k_max) entries are pairs (the
// reference runs only the first k_max candidates). Within a run the column
// tiles ascend, and the scan takes a point only when strictly closer, so
// each row gets the lexicographic minimum of (d, column position) over its
// pairs: the reference's strict-< fold over i-major steps with the lowest
// in-tile index. d is ((dx*dx + dy*dy) + dz*dz), each operation rounded on
// its own (ppt::sqdist3). A row whose tile has no pair keeps (inf, 0), the
// reference's accumulator start.
//
// On the card: one thread per row, 128 rows to a block, a block per
// (cloud, row tile, 128-row slice); each column tile of the run is staged
// in shared memory and read by every thread as a broadcast. It is bound by
// the distance arithmetic and compare, about 10 flops per (row, column)
// pair of the run, and computes each candidate tile's distances twice
// (once per direction) where the TPU computed them once.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 512;  // column points staged at a time

// First index in codes[0, len) whose value is >= key (codes ascending).
__device__ __forceinline__ int lower_bound(const int* codes, int len,
                                           int key) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (codes[mid] < key)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
    nn_worklist_kernel(const float* __restrict__ rows,
                       const float* __restrict__ cols,
                       const int* __restrict__ codes,
                       const int* __restrict__ count, int n_rows, int n_cols,
                       int t_row, int t_col, int k_max,
                       float* __restrict__ out_d, int* __restrict__ out_i) {
  __shared__ float tile[kChunk * 3];
  const int b = blockIdx.z;
  const int rt = blockIdx.y;
  const int r_in = blockIdx.x * kThreads + threadIdx.x;
  const bool active = r_in < t_row;
  const int r = rt * t_row + r_in;
  const int n_ct = n_cols / t_col;
  const int* cb = codes + static_cast<size_t>(b) * k_max;
  const int len = min(count[b], k_max);
  const int start = lower_bound(cb, len, rt * n_ct);
  const int end = lower_bound(cb, len, (rt + 1) * n_ct);
  const float* colb = cols + static_cast<size_t>(b) * n_cols * 3;
  const size_t row = static_cast<size_t>(b) * n_rows + r;

  float px = 0.f, py = 0.f, pz = 0.f;
  if (active) {
    px = rows[3 * row];
    py = rows[3 * row + 1];
    pz = rows[3 * row + 2];
  }
  float best = INFINITY;
  int best_i = 0;
  for (int e = start; e < end; ++e) {
    const int col0 = (cb[e] - rt * n_ct) * t_col;
    for (int off = 0; off < t_col; off += kChunk) {
      const int base = col0 + off;
      const int cnt = min(kChunk, t_col - off);
      __syncthreads();  // the previous chunk is no longer read
      for (int t = threadIdx.x; t < 3 * cnt; t += kThreads)
        tile[t] = colb[3 * static_cast<size_t>(base) + t];
      __syncthreads();
      if (active) {
        for (int t = 0; t < cnt; ++t) {
          const float d = ppt::sqdist3(tile[3 * t], tile[3 * t + 1],
                                       tile[3 * t + 2], px, py, pz);
          if (d < best) {
            best = d;
            best_i = base + t;
          }
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

// rows: float [B, n_rows, 3] in tiles of t_row; cols: float [B, n_cols, 3]
// in tiles of t_col; codes: int [B, k_max] ascending; count: int [B];
// out_d: float [B, n_rows]; out_i: int [B, n_rows].
extern "C" int ppt_nn_worklist(const float* rows, const float* cols,
                               const int* codes, const int* count, int b,
                               int n_rows, int n_cols, int t_row, int t_col,
                               int k_max, float* out_d, int* out_i,
                               cudaStream_t stream) {
  if (b == 0 || n_rows == 0) return cudaSuccess;
  if (t_row < 1 || t_col < 1 || n_rows % t_row || n_cols % t_col ||
      n_rows / t_row > 65535 || b > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid((t_row + kThreads - 1) / kThreads, n_rows / t_row, b);
  nn_worklist_kernel<<<grid, kThreads, 0, stream>>>(
      rows, cols, codes, count, n_rows, n_cols, t_row, t_col, k_max, out_d,
      out_i);
  return cudaGetLastError();
}
