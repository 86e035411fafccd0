// Worklist nearest neighbour, both directions in one pass: for each row of
// either cloud, the nearest point of the other cloud among the tiles its
// tile is paired with in a compacted list of candidate tile pairs.
//
// Replaces the TPU kernel pytorch_points_tpu/kernels/distance_tiles.py::
// _nn_worklist_kernel (_run_worklist, via nn_both_directions_pruned). The
// TPU walks the i-major list of (p-tile, q-tile) pairs as one sequential
// grid, computes each pair's distance tile once and folds it into both
// directions' minima, carried in scratch from step to step.
//
// Semantics: the list holds codes p_tile * n_q_tiles + q_tile, and only
// its first min(count, k_max) entries are pairs (the reference runs only
// the first k_max candidates). Each p row gets the lexicographic minimum of
// (d, q position) over the q tiles its tile is paired with, and each q row
// the lexicographic minimum of (d, p position) over its p tiles: the
// reference's strict-< folds with the lowest in-tile index. d is ((dx*dx +
// dy*dy) + dz*dz), each operation rounded on its own (ppt::sqdist3); it is
// the same bits either way round (a rounded difference only changes sign).
// A row whose tile has no pair keeps (inf, 0), the reference's start.
//
// On the card: a block per pair (pairs past the list's length exit), one
// pass, each distance computed once into both directions: the pairs kernel
// of nn_pairs.cuh, which the dense NN (nn_dense.cu) shares. R = 16 rows a
// thread on blocks of 64 threads at the reference's p tiles of 1024 rows,
// fewer rows a thread on smaller tiles. Blocks meet through 64-bit keys
// merged by atomicMin (nn_pairs.cuh), so the result has the same bits on
// every run. The determinism contract (ROADMAP) is about float sums, whose
// result depends on their order; a minimum of exact keys does not.
//
// What bounds it: issue, about 15 instructions a (row, column) pair (8
// rounded operations for the distance, two compare-and-selects of a value
// and an index, a share of the reduction), once a pair, where the earlier
// form computed every distance twice, once per direction.
#include "nn_pairs.cuh"

namespace {

template <int R, int THREADS>
void launch_pairs(dim3 grid, cudaStream_t stream, const float* pp,
                  const float* qp, const int* codes, const int* count,
                  int n_rows, int n_cols, int tn, int tm, int k_max,
                  unsigned long long* pkeys, unsigned long long* qkeys) {
  nn_pairs_kernel<R, THREADS, false, true><<<grid, THREADS, 0, stream>>>(
      pp, qp, codes, count, n_rows, n_cols, tn, tm, n_cols / tm, k_max,
      pkeys, qkeys, nullptr, nullptr, nullptr, nullptr);
}

}  // namespace

// pp: float [B, n_rows, 3] in tiles of tn; qp: float [B, n_cols, 3] in
// tiles of tm; codes: int [B, k_max], the i-major list; count: int [B];
// keys: scratch of B (n_rows + n_cols) 64-bit keys; out: d1 float, i1 int
// [B, n_rows]; d2 float, i2 int [B, n_cols]. Three launches: the keys to
// (inf, 0), the pairs, the unpack.
extern "C" int ppt_nn_worklist(const float* pp, const float* qp,
                               const int* codes, const int* count, int b,
                               int n_rows, int n_cols, int tn, int tm,
                               int k_max, unsigned long long* keys, float* d1,
                               int* i1, float* d2, int* i2,
                               cudaStream_t stream) {
  if (b == 0 || (n_rows == 0 && n_cols == 0)) return cudaSuccess;
  if (tn < 1 || tm < 1 || n_rows % tn || n_cols % tm || k_max < 1 ||
      b > 65535)
    return cudaErrorInvalidValue;
  const long long n1 = static_cast<long long>(b) * n_rows;
  const long long total = n1 + static_cast<long long>(b) * n_cols;
  fill_range(keys, 0, total, stream);
  if (n_rows > 0 && n_cols > 0) {
    const dim3 grid(k_max, b);
    unsigned long long* qkeys = keys + n1;
    if (tn <= 128)
      launch_pairs<1, 128>(grid, stream, pp, qp, codes, count, n_rows,
                           n_cols, tn, tm, k_max, keys, qkeys);
    else if (tn <= 256)
      launch_pairs<2, 128>(grid, stream, pp, qp, codes, count, n_rows,
                           n_cols, tn, tm, k_max, keys, qkeys);
    else if (tn <= 512)
      launch_pairs<4, 128>(grid, stream, pp, qp, codes, count, n_rows,
                           n_cols, tn, tm, k_max, keys, qkeys);
    else
      launch_pairs<16, 64>(grid, stream, pp, qp, codes, count, n_rows,
                           n_cols, tn, tm, k_max, keys, qkeys);
  }
  unpack_range(keys, 0, total, n1, d1, i1, d2, i2, stream);
  return cudaGetLastError();
}
