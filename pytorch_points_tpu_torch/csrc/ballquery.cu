// Ball query: the first nsample support points, in index order, strictly
// within the radius of each centroid.
//
// Replaces the TPU kernels pytorch_points_tpu/kernels/ballquery.py::
// _bq_while_kernel (resident form, P <= 4096) and ::_bq_kernel (grid form);
// the two are bitwise equal, and this one kernel serves both.
//
// Semantics: hit = d2 < r2 (strict), d2 in the reference's diff^2 order and
// r2 = float32(radius**2 taken in double), as the Pallas path rounds it.
// A row keeps its first nsample hits in index order; the remaining slots
// repeat the first hit, and a zero-hit row is all 0. cnt = min(hits,
// nsample). Masked support arrives poisoned by the wrapper (sign -1), as
// the reference poisons it, so the kernel is mask-free.
//
// WITH_COORDS (ppt_ball_query_coords) replaces the same two TPU kernels run
// with with_coords=True (ball_query_and_group_coords): each hit also writes
// its coordinates centred on the centroid, (point - centroid) per
// coordinate, rounded once (__fsub_rn). Slots at or beyond cnt repeat the
// first hit's; a zero-hit row gets (raw point 0 - centroid), from the
// unpoisoned cloud's point 0, which the wrapper passes in. The K2 instance
// (WITH_COORDS false) is the kernel as it was.
//
// On the card: one thread per (cloud, centroid); a block of 128 centroids
// shares support tiles staged in shared memory and stops scanning once all
// of its centroids are full (__syncthreads_and), which is the reference's
// early exit. It is bound by the scan's distance arithmetic (about 10
// flops per support point per live centroid) and the serial per-thread
// hit loop, not by bytes: each support tile is read once per block. The
// coordinates add 12 bytes written per slot (25 MB at B=32 P=2048 ns=32),
// a thread's 12 ns bytes contiguous.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 512;

template <bool WITH_COORDS>
__global__ void __launch_bounds__(kThreads)
    ball_query_kernel(const float* __restrict__ sup,
                      const float* __restrict__ qry,
                      const float* __restrict__ p0, int n, int p, int ns,
                      float r2, int* __restrict__ out_idx,
                      int* __restrict__ out_cnt, float* __restrict__ out_g) {
  __shared__ float tile[kTile * 3];
  const int b = blockIdx.y;
  const int q = blockIdx.x * kThreads + threadIdx.x;
  const bool active = q < p;
  const float* s = sup + static_cast<size_t>(b) * n * 3;
  const size_t row = static_cast<size_t>(b) * p + q;

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    qx = qry[3 * row];
    qy = qry[3 * row + 1];
    qz = qry[3 * row + 2];
  }
  int* out = out_idx + row * ns;
  float* g = WITH_COORDS ? out_g + row * ns * 3 : nullptr;
  int cnt = 0, first = 0;
  for (int base = 0; base < n; base += kTile) {
    // Also the barrier that protects the previous tile until all used it.
    if (__syncthreads_and(!active || cnt >= ns)) break;
    const int len = min(kTile, n - base);
    for (int t = threadIdx.x; t < 3 * len; t += kThreads)
      tile[t] = s[3 * static_cast<size_t>(base) + t];
    __syncthreads();
    if (active && cnt < ns) {
      for (int t = 0; t < len; ++t) {
        const float d = ppt::sqdist3(tile[3 * t], tile[3 * t + 1],
                                     tile[3 * t + 2], qx, qy, qz);
        if (d < r2) {
          if (cnt == 0) first = base + t;
          if constexpr (WITH_COORDS) {
            g[3 * cnt] = __fsub_rn(tile[3 * t], qx);
            g[3 * cnt + 1] = __fsub_rn(tile[3 * t + 1], qy);
            g[3 * cnt + 2] = __fsub_rn(tile[3 * t + 2], qz);
          }
          out[cnt++] = base + t;
          if (cnt == ns) break;
        }
      }
    }
  }
  if (active) {
    for (int slot = cnt; slot < ns; ++slot) out[slot] = first;
    if constexpr (WITH_COORDS) {
      float fx, fy, fz;
      if (cnt > 0) {
        fx = g[0];
        fy = g[1];
        fz = g[2];
      } else {
        fx = __fsub_rn(p0[3 * b], qx);
        fy = __fsub_rn(p0[3 * b + 1], qy);
        fz = __fsub_rn(p0[3 * b + 2], qz);
      }
      for (int slot = cnt; slot < ns; ++slot) {
        g[3 * slot] = fx;
        g[3 * slot + 1] = fy;
        g[3 * slot + 2] = fz;
      }
    }
    out_cnt[row] = cnt;
  }
}

}  // namespace

extern "C" int ppt_ball_query(const float* sup, const float* qry, int b, int n,
                              int p, int nsample, float r2, int* out_idx,
                              int* out_cnt, cudaStream_t stream) {
  const dim3 grid((p + kThreads - 1) / kThreads, b);
  ball_query_kernel<false><<<grid, kThreads, 0, stream>>>(
      sup, qry, nullptr, n, p, nsample, r2, out_idx, out_cnt, nullptr);
  return cudaGetLastError();
}

// sup: float [B, N, 3] (poisoned); qry: float [B, P, 3]; p0: float [B, 3],
// each cloud's unpoisoned point 0; out_idx: int [B, P, nsample]; out_cnt:
// int [B, P]; out_g: float [B, P, nsample, 3].
extern "C" int ppt_ball_query_coords(const float* sup, const float* qry,
                                     const float* p0, int b, int n, int p,
                                     int nsample, float r2, int* out_idx,
                                     int* out_cnt, float* out_g,
                                     cudaStream_t stream) {
  const dim3 grid((p + kThreads - 1) / kThreads, b);
  ball_query_kernel<true><<<grid, kThreads, 0, stream>>>(
      sup, qry, p0, n, p, nsample, r2, out_idx, out_cnt, out_g);
  return cudaGetLastError();
}
