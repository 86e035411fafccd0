// Exact k nearest neighbours: (squared distance ascending, index), ties to
// the lowest support index.
//
// Replaces the TPU kernel pytorch_points_tpu/kernels/topk_scan.py::
// _knn_kernel (the streaming scan that knn() runs for Ns < 8192 or
// sorted_ok=False).
//
// Semantics: the k smallest (d, index) pairs in lexicographic order, d the
// diff^2 form summed over the channels in index order, each operation
// rounded alone. Masked support arrives poisoned by the caller, as the
// reference poisons it. The reference's Pallas scan reads three channels;
// a [B, N, C] cloud with C != 3 follows its documented [B, N, C] contract
// (the XLA path's all-channel distance) instead.
//
// On the card: one thread per query keeps a sorted list of the KMAX >= k
// best (d, index) pairs in registers (KMAX a compile-time 4..64, so the
// list is never indexed dynamically); the support streams through shared
// memory in tiles shared by a block of 128 queries, in index order. A
// candidate enters only when strictly closer than the list's last entry,
// and a later index never passes an equal distance, which gives the
// lowest-index ties. The first k entries of the top-KMAX list are the
// top-k. For k > 64 the scan runs in passes of 64: pass p keeps the 64
// smallest pairs lexicographically above the last pair of pass p - 1 (a
// floor in the entry test), so the passes emit entries 64 p .. 64 p + 63
// of the same sorted list. xyz clouds (C = 3) keep each query in registers;
// any other C computes a tile of 32 support rows at a time, the channels
// staged 32 at a time in shared memory, each pair's distance accumulated
// over the channels in order. It is bound by the distance arithmetic and
// the compare per candidate (about 3 C + 1 flops per query-support pair and
// pass), not by bytes.
#include <limits.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 512;  // xyz support rows staged a tile
constexpr int kPass = 64;   // pairs a pass extracts when k > 64
constexpr int kRows = 32;   // any C: support rows a tile, at most
constexpr int kChans = 32;  // any C: channels staged at a time

template <int KMAX>
__device__ __forceinline__ void insert(float (&td)[KMAX], int (&ti)[KMAX],
                                       float d, int i) {
  // Carry the new pair down the list; each slot keeps the lexicographically
  // smaller of (its pair, the carried pair).
#pragma unroll
  for (int s = 0; s < KMAX; ++s) {
    if (d < td[s] || (d == td[s] && i < ti[s])) {
      const float tv = td[s];
      const int tj = ti[s];
      td[s] = d;
      ti[s] = i;
      d = tv;
      i = tj;
    }
  }
}

// Is (d, i) lexicographically above the floor (fd, fi)?
__device__ __forceinline__ bool above(float d, int i, float fd, int fi) {
  return d > fd || (d == fd && i > fi);
}

// Offer candidate (d, i), which arrives after every index already listed.
template <int KMAX, bool PASSES>
__device__ __forceinline__ void offer(float (&td)[KMAX], int (&ti)[KMAX],
                                      float d, int i, float fd, int fi) {
  if (d < td[KMAX - 1] && (!PASSES || above(d, i, fd, fi)))
    insert<KMAX>(td, ti, d, i);
}

template <int KMAX>
__device__ __forceinline__ void reset(float (&td)[KMAX], int (&ti)[KMAX]) {
#pragma unroll
  for (int t = 0; t < KMAX; ++t) {
    td[t] = INFINITY;
    ti[t] = INT_MAX;
  }
}

// Write list entries k0 .. k0 + KMAX - 1 that are below k.
template <int KMAX>
__device__ __forceinline__ void store(const float (&td)[KMAX],
                                      const int (&ti)[KMAX], size_t row,
                                      int k, int k0, float* __restrict__ out_d,
                                      int* __restrict__ out_i) {
#pragma unroll
  for (int t = 0; t < KMAX; ++t) {
    if (k0 + t < k) {
      out_d[row * k + k0 + t] = td[t];
      out_i[row * k + k0 + t] = ti[t];
    }
  }
}

template <int KMAX, bool PASSES>
__global__ void __launch_bounds__(kThreads)
    knn_kernel(const float* __restrict__ qry, const float* __restrict__ sup,
               int nq, int ns, int k, float* __restrict__ out_d,
               int* __restrict__ out_i) {
  __shared__ float tile[kTile * 3];
  const int b = blockIdx.y;
  const int q = blockIdx.x * kThreads + threadIdx.x;
  const bool active = q < nq;
  const float* s = sup + static_cast<size_t>(b) * ns * 3;
  const size_t row = static_cast<size_t>(b) * nq + q;

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    qx = qry[3 * row];
    qy = qry[3 * row + 1];
    qz = qry[3 * row + 2];
  }
  float td[KMAX];
  int ti[KMAX];
  float fd = -INFINITY;  // the floor: the last pair of the previous pass
  int fi = -1;
  for (int k0 = 0; k0 < k; k0 += KMAX) {
    reset<KMAX>(td, ti);
    for (int base = 0; base < ns; base += kTile) {
      const int len = min(kTile, ns - base);
      __syncthreads();
      for (int t = threadIdx.x; t < 3 * len; t += kThreads)
        tile[t] = s[3 * static_cast<size_t>(base) + t];
      __syncthreads();
      if (active) {
        for (int t = 0; t < len; ++t) {
          const float d = ppt::sqdist3(tile[3 * t], tile[3 * t + 1],
                                       tile[3 * t + 2], qx, qy, qz);
          offer<KMAX, PASSES>(td, ti, d, base + t, fd, fi);
        }
      }
    }
    if (active) store<KMAX>(td, ti, row, k, k0, out_d, out_i);
    fd = td[KMAX - 1];
    fi = ti[KMAX - 1];
    if (!PASSES) break;
  }
}

// Any C: a block's 128 queries and a tile of R support rows (fewer beside
// a 64-entry list, which needs the registers), the channels staged kChans
// at a time (the queries once, when they fit one slice); acc[j] sums
// (s_j - q)^2 over the channels in order.
template <int KMAX, bool PASSES>
__global__ void __launch_bounds__(kThreads)
    knn_channels_kernel(const float* __restrict__ qry,
                        const float* __restrict__ sup, int nq, int ns, int c,
                        int k, float* __restrict__ out_d,
                        int* __restrict__ out_i) {
  constexpr int R = KMAX > 32 ? kRows / 2 : kRows;
  __shared__ float qs[kChans][kThreads];
  __shared__ float ss[R][kChans];
  __shared__ float dist[R][kThreads];  // a thread's tile of distances
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kThreads;
  const int q = q0 + threadIdx.x;
  const bool active = q < nq;
  const float* qb = qry + static_cast<size_t>(b) * nq * c;
  const float* sb = sup + static_cast<size_t>(b) * ns * c;
  const size_t row = static_cast<size_t>(b) * nq + q;

  float td[KMAX];
  int ti[KMAX];
  float fd = -INFINITY;
  int fi = -1;
  for (int k0 = 0; k0 < k; k0 += KMAX) {
    reset<KMAX>(td, ti);
    for (int base = 0; base < ns; base += R) {
      const int len = min(R, ns - base);
      float acc[R];
#pragma unroll
      for (int j = 0; j < R; ++j) acc[j] = 0.f;
      for (int c0 = 0; c0 < c; c0 += kChans) {
        const int cl = min(kChans, c - c0);
        __syncthreads();
        if (c > kChans || base == 0) {
          for (int e = threadIdx.x; e < kThreads * cl; e += kThreads) {
            const int t = e / cl;
            const int cc = e - t * cl;
            qs[cc][t] = q0 + t < nq
                            ? qb[static_cast<size_t>(q0 + t) * c + c0 + cc]
                            : 0.f;
          }
        }
        for (int e = threadIdx.x; e < len * cl; e += kThreads) {
          const int j = e / cl;
          const int cc = e - j * cl;
          ss[j][cc] = sb[static_cast<size_t>(base + j) * c + c0 + cc];
        }
        __syncthreads();
        for (int cc = 0; cc < cl; ++cc) {
          const float qv = qs[cc][threadIdx.x];
#pragma unroll
          for (int j = 0; j < R; ++j) {
            const float dv = __fsub_rn(ss[j][cc], qv);
            acc[j] = __fadd_rn(acc[j], __fmul_rn(dv, dv));
          }
        }
      }
      if (active) {
        // offered from shared memory by a loop that is not unrolled, so
        // the list's insert is compiled once, not once a row
#pragma unroll
        for (int j = 0; j < R; ++j) dist[j][threadIdx.x] = acc[j];
#pragma unroll 1
        for (int j = 0; j < len; ++j)
          offer<KMAX, PASSES>(td, ti, dist[j][threadIdx.x], base + j, fd,
                              fi);
      }
    }
    if (active) store<KMAX>(td, ti, row, k, k0, out_d, out_i);
    fd = td[KMAX - 1];
    fi = ti[KMAX - 1];
    if (!PASSES) break;
  }
}

template <int KMAX, bool PASSES>
cudaError_t launch(const float* qry, const float* sup, int b, int nq, int ns,
                   int c, int k, float* out_d, int* out_i,
                   cudaStream_t stream) {
  const dim3 grid((nq + kThreads - 1) / kThreads, b);
  if (c == 3) {
    knn_kernel<KMAX, PASSES><<<grid, kThreads, 0, stream>>>(qry, sup, nq, ns,
                                                           k, out_d, out_i);
  } else {
    knn_channels_kernel<KMAX, PASSES><<<grid, kThreads, 0, stream>>>(
        qry, sup, nq, ns, c, k, out_d, out_i);
  }
  return cudaGetLastError();
}

}  // namespace

// qry: float [B, Nq, C]; sup: float [B, Ns, C]; out_d, out_i: [B, Nq, k],
// 1 <= k <= Ns.
extern "C" int ppt_knn(const float* qry, const float* sup, int b, int nq,
                       int ns, int c, int k, float* out_d, int* out_i,
                       cudaStream_t stream) {
  if (k < 1 || k > ns || c < 1) return cudaErrorInvalidValue;
  if (b == 0 || nq == 0) return cudaSuccess;
  if (k <= 4)
    return launch<4, false>(qry, sup, b, nq, ns, c, k, out_d, out_i, stream);
  if (k <= 8)
    return launch<8, false>(qry, sup, b, nq, ns, c, k, out_d, out_i, stream);
  if (k <= 16)
    return launch<16, false>(qry, sup, b, nq, ns, c, k, out_d, out_i, stream);
  if (k <= 32)
    return launch<32, false>(qry, sup, b, nq, ns, c, k, out_d, out_i, stream);
  if (k <= kPass)
    return launch<kPass, false>(qry, sup, b, nq, ns, c, k, out_d, out_i,
                                stream);
  return launch<kPass, true>(qry, sup, b, nq, ns, c, k, out_d, out_i, stream);
}
