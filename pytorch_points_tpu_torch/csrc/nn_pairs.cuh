// The nearest-neighbour pass over (p-tile, q-tile) pairs that the worklist
// NN (nn_worklist.cu) and the dense NN (nn_dense.cu, K5 and K13) share.
//
// A block takes one tile pair and computes each of its distances once, in
// the reference's arithmetic (ppt::sqdist3), folding it into the row's
// minimum (direction 1: each p row's lexicographic minimum of (d, q
// position)) and, with BOTH, into the column's (direction 2: each q row's
// minimum of (d, p position)). A thread holds R rows of the p tile in
// registers (a warp 32 R consecutive rows), and the q tile is staged in
// shared memory as float4, read as a broadcast. Per (row, column): the
// distance, the row's running minimum (strict <, columns ascending) and,
// with BOTH, the thread's minimum over its rows for the column (strict <,
// rows ascending). The column minima of a group of 8 columns are then
// reduced across the warp together, a reduce-scatter by shuffles (9
// exchanges of 64-bit keys for 8 columns, against 5 for each column alone),
// and across the block's warps by a shared-memory atomicMin.
//
// Blocks meet through device memory: each row's and each column's result is
// a 64-bit key (float bits of d << 32 | position), merged with a 64-bit
// atomicMin per row and column a pair, after a launch that sets the keys to
// (inf, 0); a last launch unpacks them. d >= +0, so its bits order as an
// unsigned integer, and the minimum key is exactly the lexicographic minimum
// of (d, position): the same for any order in which blocks arrive, so the
// result has the same bits on every run. A direction that one block covers
// whole (direction 1 when a block spans every column; direction 2 when it
// spans every row in one slab) is written directly, with no keys.
#pragma once

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kPairChunk = 512;  // q points staged at a time
constexpr unsigned kPairFull = 0xffffffffu;
constexpr unsigned long long kNoPair = 0x7f800000ull << 32;  // (inf, 0)

__device__ __forceinline__ unsigned long long pack(float d, int i) {
  return (static_cast<unsigned long long>(__float_as_uint(d)) << 32) |
         static_cast<unsigned>(i);
}

__device__ __forceinline__ float unpack_d(unsigned long long k) {
  return __uint_as_float(static_cast<unsigned>(k >> 32));
}

__device__ __forceinline__ int unpack_i(unsigned long long k) {
  return static_cast<int>(static_cast<unsigned>(k));
}

__device__ __forceinline__ unsigned long long key_min(unsigned long long a,
                                                      unsigned long long b) {
  return a < b ? a : b;
}

// keys[lo, hi) to (inf, 0).
__global__ void fill_keys(unsigned long long* __restrict__ keys, long long lo,
                          long long hi) {
  for (long long i = lo + static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < hi; i += static_cast<long long>(gridDim.x) * blockDim.x)
    keys[i] = kNoPair;
}

// keys [B*N' + B*M'] over [lo, hi) -> (d1, i1) [B, N'] below n1, then (d2,
// i2) [B, M'].
__global__ void unpack_keys(const unsigned long long* __restrict__ keys,
                            long long lo, long long hi, long long n1,
                            float* __restrict__ d1, int* __restrict__ i1,
                            float* __restrict__ d2, int* __restrict__ i2) {
  for (long long i = lo + static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < hi; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const unsigned long long k = keys[i];
    if (i < n1) {
      d1[i] = unpack_d(k);
      i1[i] = unpack_i(k);
    } else {
      d2[i - n1] = unpack_d(k);
      i2[i - n1] = unpack_i(k);
    }
  }
}

// The fill and unpack launches over keys[lo, hi), if that is not empty.
inline void fill_range(unsigned long long* keys, long long lo, long long hi,
                       cudaStream_t stream) {
  if (lo >= hi) return;
  const long long want = (hi - lo + 255) / 256;
  fill_keys<<<static_cast<int>(want < 4096 ? want : 4096), 256, 0, stream>>>(
      keys, lo, hi);
}

inline void unpack_range(const unsigned long long* keys, long long lo,
                         long long hi, long long n1, float* d1, int* i1,
                         float* d2, int* i2, cudaStream_t stream) {
  if (lo >= hi) return;
  const long long want = (hi - lo + 255) / 256;
  unpack_keys<<<static_cast<int>(want < 4096 ? want : 4096), 256, 0,
                stream>>>(keys, lo, hi, n1, d1, i1, d2, i2);
}

// Reduce-scatter of a group of kPairGroup = 8 column keys across the warp:
// exchanges at lane distance 16, 8 and 4 halve the keys a lane holds, then
// two plain steps finish each column. Lane l returns the warp's minimum
// for column group_column(l) of the group.
constexpr int kPairGroup = 8;

__device__ __forceinline__ int group_column(int lane) {
  return ((lane >> 4) & 1) * 4 + ((lane >> 3) & 1) * 2 + ((lane >> 2) & 1);
}

__device__ __forceinline__ unsigned long long reduce_group(
    const unsigned long long (&key)[kPairGroup], int lane) {
  unsigned long long k4[4], k2[2];
  const bool h16 = lane & 16, h8 = lane & 8, h4 = lane & 4;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    k4[j] = key_min(h16 ? key[j + 4] : key[j],
                    __shfl_xor_sync(kPairFull, h16 ? key[j] : key[j + 4], 16));
#pragma unroll
  for (int j = 0; j < 2; ++j)
    k2[j] = key_min(h8 ? k4[j + 2] : k4[j],
                    __shfl_xor_sync(kPairFull, h8 ? k4[j] : k4[j + 2], 8));
  unsigned long long k1 = key_min(
      h4 ? k2[1] : k2[0], __shfl_xor_sync(kPairFull, h4 ? k2[0] : k2[1], 4));
  k1 = key_min(k1, __shfl_xor_sync(kPairFull, k1, 2));
  return key_min(k1, __shfl_xor_sync(kPairFull, k1, 1));
}

// One block a tile pair of cloud b (blockIdx.y): with DENSE, pair blockIdx.x
// of the full nI x nJ grid (i-major); else list entry blockIdx.x of the
// i-major list `codes` (entries past min(count, k_max) exit). The code i *
// nj + j names p rows [i tn, i tn + tn) and q rows [j tm, j tm + tm), cut
// at the clouds' ends. R rows a thread, THREADS R rows of the p tile at a
// time; the q tile's points in chunks of kPairChunk, columns in groups of
// kPairGroup. Direction 1 goes to pkeys, or straight to (d1, i1) when d1
// is given (every column in this block); with BOTH, direction 2 to qkeys,
// or straight to (d2, i2) when d2 is given (every row in this block's one
// slab).
template <int R, int THREADS, bool DENSE, bool BOTH>
__global__ void __launch_bounds__(THREADS)
    nn_pairs_kernel(const float* __restrict__ pp,
                    const float* __restrict__ qp,
                    const int* __restrict__ codes,
                    const int* __restrict__ count, int n_rows, int n_cols,
                    int tn, int tm, int nj, int k_max,
                    unsigned long long* __restrict__ pkeys,
                    unsigned long long* __restrict__ qkeys,
                    float* __restrict__ d1, int* __restrict__ i1,
                    float* __restrict__ d2, int* __restrict__ i2) {
  __shared__ float4 cols[kPairChunk];
  __shared__ unsigned long long ckey[BOTH ? kPairChunk : 1];
  const int b = blockIdx.y;
  const int e = blockIdx.x;
  int code = e;
  if (!DENSE) {
    if (e >= min(count[b], k_max)) return;
    code = codes[static_cast<size_t>(b) * k_max + e];
  }
  const int row0 = (code / nj) * tn;
  const int col0 = (code % nj) * tm;
  const int rows = min(tn, n_rows - row0);
  const int ncols = min(tm, n_cols - col0);
  const float* pb = pp + static_cast<size_t>(b) * n_rows * 3;
  const float* qb = qp + static_cast<size_t>(b) * n_cols * 3;
  const size_t prow = static_cast<size_t>(b) * n_rows;
  const size_t qrow = static_cast<size_t>(b) * n_cols;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int my_column = group_column(lane);

  for (int slab = 0; slab < rows; slab += THREADS * R) {
    // the thread's rows: warp_row + 32 k + lane, ascending in k
    const int warp_row = slab + warp * 32 * R;
    float px[R], py[R], pz[R], bd[R];
    int bi[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int r = warp_row + 32 * k + lane;
      px[k] = py[k] = pz[k] = NAN;  // past the tile: never a minimum
      if (r < rows) {
        const float* src = pb + 3 * static_cast<size_t>(row0 + r);
        px[k] = src[0];
        py[k] = src[1];
        pz[k] = src[2];
      }
      bd[k] = INFINITY;
      bi[k] = 0;
    }
    for (int c0 = 0; c0 < ncols; c0 += kPairChunk) {
      const int len = min(kPairChunk, ncols - c0);
      const int groups = (len + kPairGroup - 1) / kPairGroup;
      __syncthreads();  // the previous chunk is no longer read
      for (int t = threadIdx.x; t < groups * kPairGroup; t += THREADS) {
        float4 v = make_float4(NAN, NAN, NAN, NAN);  // past the tile
        if (t < len) {
          const float* src = qb + 3 * static_cast<size_t>(col0 + c0 + t);
          v = make_float4(src[0], src[1], src[2], 0.f);
        }
        cols[t] = v;
        if (BOTH) ckey[t] = kNoPair;
      }
      __syncthreads();
      if (warp_row < rows) {
        for (int c = 0; c < groups * kPairGroup; c += kPairGroup) {
          unsigned long long key[kPairGroup];
#pragma unroll
          for (int j = 0; j < kPairGroup; ++j) {
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
              if (BOTH) {
                if (k == 0) {
                  cd = d;
                } else if (d < cd) {
                  cd = d;
                  ck = k;
                }
              }
            }
            if (BOTH) key[j] = pack(cd, row0 + warp_row + 32 * ck + lane);
          }
          if (BOTH) {
            const unsigned long long m = reduce_group(key, lane);
            if ((lane & 3) == 0 && m < kNoPair)
              atomicMin(&ckey[c + my_column], m);
          }
        }
      }
      if (BOTH) {
        __syncthreads();
        for (int t = threadIdx.x; t < len; t += THREADS) {
          const size_t at = qrow + col0 + c0 + t;
          if (d2 != nullptr) {
            d2[at] = unpack_d(ckey[t]);
            i2[at] = unpack_i(ckey[t]);
          } else if (ckey[t] != kNoPair) {
            atomicMin(&qkeys[at], ckey[t]);
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int r = warp_row + 32 * k + lane;
      if (r >= rows) continue;
      const size_t at = prow + row0 + r;
      if (d1 != nullptr) {
        d1[at] = bd[k];
        i1[at] = bi[k];
      } else if (bd[k] < INFINITY) {
        atomicMin(&pkeys[at], pack(bd[k], bi[k]));
      }
    }
  }
}

}  // namespace
