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
// pass, each distance computed once. A thread holds R rows of the p tile
// in registers (a warp 32 R consecutive rows; R = 16 on blocks of 64
// threads at the reference's p tiles of 1024 rows, fewer rows a thread on
// smaller tiles), and the q tile is staged in shared memory as float4,
// read as a broadcast. Per (row, column): the distance, the row's running
// minimum (strict <, columns ascending) and the thread's minimum over its
// rows for the column (strict <, rows ascending). The column minima of a
// group of 8 columns are then reduced across the warp together, a
// reduce-scatter by shuffles (9 exchanges of 64-bit keys for 8 columns,
// against 5 for each column alone), and across the block's warps by a
// shared-memory atomicMin. Blocks meet through device memory: each row's
// and each column's result is a 64-bit key (float bits of d << 32 |
// position), merged with a 64-bit atomicMin per row and column a pair,
// after a launch that sets every key to (inf, 0); a last launch unpacks
// the keys. d >= +0, so its bits order as an unsigned integer, and the
// minimum key is exactly the lexicographic minimum of (d, position): the
// same for any order in which blocks arrive, so the result has the same
// bits on every run. The determinism contract (ROADMAP) is about float
// sums, whose result depends on their order; a minimum of exact keys does
// not.
//
// What bounds it: issue, about 15 instructions a (row, column) pair (8
// rounded operations for the distance, two compare-and-selects of a value
// and an index, a share of the reduction), once a pair, where the earlier
// form computed every distance twice, once per direction.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kChunk = 512;  // q points staged at a time
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kNone = 0x7f800000ull << 32;  // (inf, 0)

__device__ __forceinline__ unsigned long long pack(float d, int i) {
  return (static_cast<unsigned long long>(__float_as_uint(d)) << 32) |
         static_cast<unsigned>(i);
}

__device__ __forceinline__ unsigned long long key_min(unsigned long long a,
                                                      unsigned long long b) {
  return a < b ? a : b;
}

__global__ void fill_keys(unsigned long long* __restrict__ keys,
                          long long total) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x)
    keys[i] = kNone;
}

// keys [B*N' + B*M'] -> (d1, i1) [B, N'], then (d2, i2) [B, M'].
__global__ void unpack_keys(const unsigned long long* __restrict__ keys,
                            long long n1, long long total,
                            float* __restrict__ d1, int* __restrict__ i1,
                            float* __restrict__ d2, int* __restrict__ i2) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const unsigned long long k = keys[i];
    const float d = __uint_as_float(static_cast<unsigned>(k >> 32));
    const int id = static_cast<int>(static_cast<unsigned>(k));
    if (i < n1) {
      d1[i] = d;
      i1[i] = id;
    } else {
      d2[i - n1] = d;
      i2[i - n1] = id;
    }
  }
}

// Reduce-scatter of a group of kGroup = 8 column keys across the warp:
// exchanges at lane distance 16, 8 and 4 halve the keys a lane holds, then
// two plain steps finish each column. Lane l returns the warp's minimum
// for column group_column(l) of the group.
constexpr int kGroup = 8;

__device__ __forceinline__ int group_column(int lane) {
  return ((lane >> 4) & 1) * 4 + ((lane >> 3) & 1) * 2 + ((lane >> 2) & 1);
}

__device__ __forceinline__ unsigned long long reduce_group(
    const unsigned long long (&key)[kGroup], int lane) {
  unsigned long long k4[4], k2[2];
  const bool h16 = lane & 16, h8 = lane & 8, h4 = lane & 4;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    k4[j] = key_min(h16 ? key[j + 4] : key[j],
                    __shfl_xor_sync(kFull, h16 ? key[j] : key[j + 4], 16));
#pragma unroll
  for (int j = 0; j < 2; ++j)
    k2[j] = key_min(h8 ? k4[j + 2] : k4[j],
                    __shfl_xor_sync(kFull, h8 ? k4[j] : k4[j + 2], 8));
  unsigned long long k1 = key_min(
      h4 ? k2[1] : k2[0], __shfl_xor_sync(kFull, h4 ? k2[0] : k2[1], 4));
  k1 = key_min(k1, __shfl_xor_sync(kFull, k1, 2));
  return key_min(k1, __shfl_xor_sync(kFull, k1, 1));
}

// One block a list entry e (blockIdx.x) of cloud b (blockIdx.y); R rows a
// thread, THREADS R rows of the p tile at a time; the q tile's points in
// chunks of kChunk, columns in groups of kGroup.
template <int R, int THREADS>
__global__ void __launch_bounds__(THREADS)
    nn_pairs_kernel(const float* __restrict__ pp,
                    const float* __restrict__ qp,
                    const int* __restrict__ codes,
                    const int* __restrict__ count, int n_rows, int n_cols,
                    int tn, int tm, int k_max,
                    unsigned long long* __restrict__ pkeys,
                    unsigned long long* __restrict__ qkeys) {
  __shared__ float4 cols[kChunk];
  __shared__ unsigned long long ckey[kChunk];
  const int b = blockIdx.y;
  const int e = blockIdx.x;
  if (e >= min(count[b], k_max)) return;
  const int code = codes[static_cast<size_t>(b) * k_max + e];
  const int nj = n_cols / tm;
  const int row0 = (code / nj) * tn;
  const int col0 = (code % nj) * tm;
  const float* pb = pp + static_cast<size_t>(b) * n_rows * 3;
  const float* qb = qp + static_cast<size_t>(b) * n_cols * 3;
  unsigned long long* pk = pkeys + static_cast<size_t>(b) * n_rows;
  unsigned long long* qk = qkeys + static_cast<size_t>(b) * n_cols;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int my_column = group_column(lane);

  for (int slab = 0; slab < tn; slab += THREADS * R) {
    // the thread's rows: warp_row + 32 k + lane, ascending in k
    const int warp_row = slab + warp * 32 * R;
    float px[R], py[R], pz[R], bd[R];
    int bi[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int r = warp_row + 32 * k + lane;
      px[k] = py[k] = pz[k] = NAN;  // past the tile: never a minimum
      if (r < tn) {
        const float* src = pb + 3 * static_cast<size_t>(row0 + r);
        px[k] = src[0];
        py[k] = src[1];
        pz[k] = src[2];
      }
      bd[k] = INFINITY;
      bi[k] = 0;
    }
    for (int c0 = 0; c0 < tm; c0 += kChunk) {
      const int len = min(kChunk, tm - c0);
      const int groups = (len + kGroup - 1) / kGroup;
      __syncthreads();  // the previous chunk is no longer read
      for (int t = threadIdx.x; t < groups * kGroup; t += THREADS) {
        float4 v = make_float4(NAN, NAN, NAN, NAN);  // past the tile
        if (t < len) {
          const float* src = qb + 3 * static_cast<size_t>(col0 + c0 + t);
          v = make_float4(src[0], src[1], src[2], 0.f);
        }
        cols[t] = v;
        ckey[t] = kNone;
      }
      __syncthreads();
      if (warp_row < tn) {
        for (int c = 0; c < groups * kGroup; c += kGroup) {
          unsigned long long key[kGroup];
#pragma unroll
          for (int j = 0; j < kGroup; ++j) {
            const float4 q = cols[c + j];
            const int col = col0 + c0 + c + j;
            // the thread's first row starts the fold: NaN only when all
            // its rows lie past the tile, and a NaN key loses every min
            float cd = 0.f;
            int ck = 0;
#pragma unroll
            for (int k = 0; k < R; ++k) {
              const float d =
                  ppt::sqdist3(q.x, q.y, q.z, px[k], py[k], pz[k]);
              if (d < bd[k]) {
                bd[k] = d;
                bi[k] = col;
              }
              if (k == 0) {
                cd = d;
              } else if (d < cd) {
                cd = d;
                ck = k;
              }
            }
            key[j] = pack(cd, row0 + warp_row + 32 * ck + lane);
          }
          const unsigned long long m = reduce_group(key, lane);
          if ((lane & 3) == 0 && m < kNone) atomicMin(&ckey[c + my_column], m);
        }
      }
      __syncthreads();
      for (int t = threadIdx.x; t < len; t += THREADS)
        if (ckey[t] != kNone) atomicMin(&qk[col0 + c0 + t], ckey[t]);
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int r = warp_row + 32 * k + lane;
      if (r < tn && bd[k] < INFINITY)
        atomicMin(&pk[row0 + r], pack(bd[k], bi[k]));
    }
  }
}

template <int R, int THREADS>
void launch_pairs(dim3 grid, cudaStream_t stream, const float* pp,
                  const float* qp, const int* codes, const int* count,
                  int n_rows, int n_cols, int tn, int tm, int k_max,
                  unsigned long long* pkeys, unsigned long long* qkeys) {
  nn_pairs_kernel<R, THREADS><<<grid, THREADS, 0, stream>>>(
      pp, qp, codes, count, n_rows, n_cols, tn, tm, k_max, pkeys, qkeys);
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
  const long long want = (total + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  fill_keys<<<blocks, 256, 0, stream>>>(keys, total);
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
  unpack_keys<<<blocks, 256, 0, stream>>>(keys, n1, total, d1, i1, d2, i2);
  return cudaGetLastError();
}
