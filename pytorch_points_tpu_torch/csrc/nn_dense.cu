// Dense nearest neighbour, both directions in one pass (kernel K5) or one
// direction (K13): for each point of p, the squared distance to its nearest
// point of q and that point's index, and with both directions the same for
// each point of q over p; ties to the lowest index.
//
// Replaces the TPU kernels pytorch_points_tpu/kernels/distance_tiles.py::
// _nn_both_kernel (nn_both_directions, the dense chamfer scan) and ::
// _nn_kernel (nn_one_direction).
//
// Semantics: d in the reference's order ((dx*dx + dy*dy) + dz*dz), each
// operation rounded on its own (ppt::sqdist3); each p row gets the
// lexicographic minimum of (d, q index) and each q row the minimum of (d, p
// index), which is the reference's lowest-index tie; a row starts at (inf,
// 0), as the reference's accumulators do. Masked points arrive poisoned by
// the op; the kernel takes ragged N and M and bounds the tiles' edges
// itself (no padding).
//
// On the card: the worklist's pairs kernel (nn_pairs.cuh) with every tile
// pair a candidate and no list. The TPU kernel computes each distance tile
// once and reduces it along both axes, carrying direction 2 across its
// sequential grid; here each (p-tile, q-tile) pair is a block that computes
// its distances once and folds them into both directions, and blocks meet
// through 64-bit (d, index) keys merged by atomicMin, which is order free
// and so gives the same bits on every run. K13 is the same kernel with
// direction 2 turned off. The tile shape follows the grid: a p tile is one
// slab of the block's rows (1024 rows on 64 threads of 16 rows, even for
// small clouds: fewer rows a thread pay more for the column reduction), and
// q is cut into as many tiles as it takes to give about kTargetBlocks
// blocks. A direction that one block covers
// whole is written directly (direction 1 when q is one tile; direction 2
// when p is one tile), and the fill and unpack launches cover only the
// directions that go through keys. It is bound by instruction issue: 8
// rounded operations a distance (no FMA), a compare-and-select pair a
// direction, and a share of the warp's column reduction.
#include "nn_pairs.cuh"

namespace {

constexpr int kTargetBlocks = 792;  // about 6 blocks an SM on 132 SMs
constexpr int kRowsPerThread = 16;
constexpr int kThreads = 64;

cudaError_t launch_dense(const float* p, const float* q, int b, int n,
                         int m, bool both, unsigned long long* keys,
                         float* d1, int* i1, float* d2, int* i2,
                         cudaStream_t stream) {
  constexpr int tn = kRowsPerThread * kThreads;
  const int ni = (n + tn - 1) / tn;
  const long long want = (kTargetBlocks + static_cast<long long>(b) * ni - 1) /
                         (static_cast<long long>(b) * ni);
  const int max_nj = (m + 7) / 8;
  const int nj0 = static_cast<int>(want < max_nj ? want : max_nj);
  const int tm = ((m + nj0 - 1) / nj0 + 7) / 8 * 8;
  const int nj = (m + tm - 1) / tm;
  const bool direct1 = nj == 1;
  const bool direct2 = both && ni == 1;
  // keys: direction 1 at [0, n1), direction 2 at [n1, total)
  const long long n1 = static_cast<long long>(b) * n;
  const long long total = both ? n1 + static_cast<long long>(b) * m : n1;
  const long long lo = direct1 ? n1 : 0;
  const long long hi = both && !direct2 ? total : n1;
  fill_range(keys, lo, hi, stream);
  const dim3 grid(ni * nj, b);
  if (both)
    nn_pairs_kernel<kRowsPerThread, kThreads, true, true>
        <<<grid, kThreads, 0, stream>>>(
        p, q, nullptr, nullptr, n, m, tn, tm, nj, 0, keys, keys + n1,
        direct1 ? d1 : nullptr, direct1 ? i1 : nullptr,
        direct2 ? d2 : nullptr, direct2 ? i2 : nullptr);
  else
    nn_pairs_kernel<kRowsPerThread, kThreads, true, false>
        <<<grid, kThreads, 0, stream>>>(
        p, q, nullptr, nullptr, n, m, tn, tm, nj, 0, keys, nullptr,
        direct1 ? d1 : nullptr, direct1 ? i1 : nullptr, nullptr, nullptr);
  unpack_range(keys, lo, hi, n1, d1, i1, d2, i2, stream);
  return cudaGetLastError();
}

}  // namespace

// p: float [B, N, 3]; q: float [B, M, 3]; both: 1 for both directions (K5),
// 0 for p -> q only (K13); keys: scratch of B N 64-bit keys, B (N + M)
// with both; out: d1
// float, i1 int [B, N]; with both, d2 float, i2 int [B, M]. M >= 1, and N
// >= 1 with both. One to three launches: the keys to (inf, 0), the pairs,
// the unpack, the first and last only for a direction that needs keys.
extern "C" int ppt_nn_dense(const float* p, const float* q, int b, int n,
                            int m, int both, unsigned long long* keys,
                            float* d1, int* i1, float* d2, int* i2,
                            cudaStream_t stream) {
  if (m < 1 || (both && n < 1) || b > 65535) return cudaErrorInvalidValue;
  if (b == 0 || n == 0) return cudaSuccess;
  return launch_dense(p, q, b, n, m, both != 0, keys, d1, i1, d2, i2, stream);
}
