// Exact k nearest neighbours: (squared distance ascending, index), ties to
// the lowest support index.
//
// Replaces the TPU kernel pytorch_points_tpu/kernels/topk_scan.py::
// _knn_kernel (the streaming scan that knn() runs for Ns < 8192 or
// sorted_ok=False).
//
// Semantics: the k smallest (d, index) pairs in lexicographic order, d in
// the reference's diff^2 order. Masked support arrives poisoned by the
// caller, as the reference poisons it.
//
// On the card: one thread per query keeps a sorted list of the KMAX >= k
// best (d, index) pairs in registers (KMAX a compile-time 4..64, so the
// list is never indexed dynamically); the support streams through shared
// memory in tiles shared by a block of 128 queries, in index order. A
// candidate enters only when strictly closer than the list's last entry,
// and a later index never passes an equal distance, which gives the
// lowest-index ties. The first k entries of the top-KMAX list are the
// top-k. It is bound by the distance arithmetic and the compare per
// candidate (about 10 flops per query-support pair), not by bytes.
#include <limits.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 512;

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

template <int KMAX>
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
#pragma unroll
  for (int t = 0; t < KMAX; ++t) {
    td[t] = INFINITY;
    ti[t] = INT_MAX;
  }
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
        if (d < td[KMAX - 1]) insert<KMAX>(td, ti, d, base + t);
      }
    }
  }
  if (active) {
#pragma unroll
    for (int t = 0; t < KMAX; ++t) {
      if (t < k) {
        out_d[row * k + t] = td[t];
        out_i[row * k + t] = ti[t];
      }
    }
  }
}

template <int KMAX>
cudaError_t launch(const float* qry, const float* sup, int b, int nq, int ns,
                   int k, float* out_d, int* out_i, cudaStream_t stream) {
  const dim3 grid((nq + kThreads - 1) / kThreads, b);
  knn_kernel<KMAX><<<grid, kThreads, 0, stream>>>(qry, sup, nq, ns, k, out_d,
                                                  out_i);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ppt_knn(const float* qry, const float* sup, int b, int nq,
                       int ns, int k, float* out_d, int* out_i,
                       cudaStream_t stream) {
  if (k <= 4) return launch<4>(qry, sup, b, nq, ns, k, out_d, out_i, stream);
  if (k <= 8) return launch<8>(qry, sup, b, nq, ns, k, out_d, out_i, stream);
  if (k <= 16) return launch<16>(qry, sup, b, nq, ns, k, out_d, out_i, stream);
  if (k <= 32) return launch<32>(qry, sup, b, nq, ns, k, out_d, out_i, stream);
  if (k <= 64) return launch<64>(qry, sup, b, nq, ns, k, out_d, out_i, stream);
  return cudaErrorInvalidValue;
}
