// Morton-pruned nearest neighbour (one direction per launch): the band pass
// that bounds each point's NN distance from above, and the NN scan over the
// candidate tile pairs that the bound leaves.
//
// Replaces the TPU kernels pytorch_points_tpu/kernels/nn_sorted.py::
// _band_kernel (band_min) and ::_nn_resident_kernel (_run_resident with
// tie_orig=True). Both clouds arrive Morton-sorted and padded by the
// wrapper (kernels/nn_sorted.py), which also builds the candidate mask
// from the band's bounds in torch ops, as the JAX package does in XLA.
//
// Band (nn_band_kernel). For p-tile i of tb sorted points, the minimum
// squared distance over three consecutive tiles of tbq points of the
// (stride-subsampled) sorted q, at q-tiles clamp(center + {-1, 0, +1}),
// with center = i * njq / ni or, for masked clouds (K7), a per-(b, i)
// centers array. The minimum over any subset of q is an upper bound on the
// NN distance, and it uses the scan's own arithmetic (ppt::sqdist3), so the
// bound can never undershoot the distance the scan computes for the true
// NN: a bound that disagreed with the kernel it prunes for would be
// unsound. One block per p-tile stages its three windows (9 tbq floats) in
// shared memory; bound by the distance arithmetic, 3 tbq pairs per point.
//
// Resident NN (nn_resident_kernel). One block per (cloud, p-tile of tn
// sorted rows), one thread per row. Warp 0 compacts the block's row of the
// [B, nI, nJ] candidate mask into a list of q-tiles (ascending j) in shared
// memory; the block then stages tn / tm candidate tiles at a time (coords
// and ORIGINAL index, a float4 per point) and each thread folds them with
// d < best || (d == best && id < best_id): the lexicographic minimum of
// (d, original index), the reference's lowest-original-index tie rule
// (nn_sorted.py:445-450). Every tile that holds a point at the NN distance
// passes the bound, so the result equals the dense scan (K5) on the
// original clouds, distances and indices bitwise. Rows with no candidate
// keep (inf, 2^30), the reference's sentinel; they are padding.
//
// No worklist budget. The TPU kernel runs a static fori_loop over a
// compacted pair list of static size (_compact_pairs, _BUDGET_FRAC), so it
// needs a budget and, past it, a lax.cond to the dense kernel. Reading the
// mask directly, a block visits exactly its own candidates, of any number,
// so neither the budget nor the fallback exists here.
//
// On the card: bound by the distance arithmetic of the candidate pairs
// (about a quarter of all pairs on uniform clouds); each staged tile is
// read by every thread as a shared-memory broadcast. Blocks of one cloud
// see different candidate counts, so the tail of a launch is uneven.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kBandThreads = 256;
constexpr int kSentinel = 1 << 30;

__global__ void __launch_bounds__(kBandThreads)
    nn_band_kernel(const float* __restrict__ ps, const float* __restrict__ qsub,
                   const int* __restrict__ centers, int n, int mq, int tb,
                   int tbq, float* __restrict__ out) {
  extern __shared__ float win[];  // 3 windows of tbq points, xyz
  const int ti = blockIdx.x;
  const int ni = gridDim.x;
  const int b = blockIdx.y;
  const int njq = mq / tbq;
  const int center =
      centers != nullptr
          ? centers[static_cast<size_t>(b) * ni + ti]
          : static_cast<int>(static_cast<long long>(ti) * njq / ni);
  const float* qb = qsub + static_cast<size_t>(b) * mq * 3;
  for (int w = 0; w < 3; ++w) {
    const int jt = min(max(center + w - 1, 0), njq - 1);
    const float* src = qb + static_cast<size_t>(jt) * tbq * 3;
    for (int t = threadIdx.x; t < 3 * tbq; t += blockDim.x)
      win[w * 3 * tbq + t] = src[t];
  }
  __syncthreads();
  for (int r = threadIdx.x; r < tb; r += blockDim.x) {
    const size_t row = static_cast<size_t>(b) * n +
                       static_cast<size_t>(ti) * tb + r;
    const float px = ps[3 * row], py = ps[3 * row + 1], pz = ps[3 * row + 2];
    float acc = INFINITY;
    for (int t = 0; t < 3 * tbq; ++t)
      acc = fminf(acc, ppt::sqdist3(win[3 * t], win[3 * t + 1],
                                    win[3 * t + 2], px, py, pz));
    out[row] = acc;
  }
}

__global__ void __launch_bounds__(1024)
    nn_resident_kernel(const float* __restrict__ ps,
                       const float* __restrict__ qs,
                       const int* __restrict__ qid,
                       const uint8_t* __restrict__ cand, int ni, int nj,
                       int tm, float* __restrict__ out_d,
                       int* __restrict__ out_i) {
  extern __shared__ float4 stage[];  // blockDim.x points, then the list
  int* list = reinterpret_cast<int*>(stage + blockDim.x);
  __shared__ int s_count;
  const int tn = blockDim.x;
  const int ti = blockIdx.x;
  const int b = blockIdx.y;
  const size_t mp = static_cast<size_t>(nj) * tm;
  const size_t row = (static_cast<size_t>(b) * ni + ti) * tn + threadIdx.x;
  const float px = ps[3 * row], py = ps[3 * row + 1], pz = ps[3 * row + 2];

  if (threadIdx.x < 32) {  // warp 0: candidate q-tiles, ascending j
    const uint8_t* crow = cand + (static_cast<size_t>(b) * ni + ti) * nj;
    const unsigned lane = threadIdx.x;
    int count = 0;
    for (int base = 0; base < nj; base += 32) {
      const int j = base + static_cast<int>(lane);
      const bool hit = j < nj && crow[j] != 0;
      const unsigned ballot = __ballot_sync(0xffffffffu, hit);
      if (hit) list[count + __popc(ballot & ((1u << lane) - 1u))] = j;
      count += __popc(ballot);
    }
    if (lane == 0) s_count = count;
  }
  __syncthreads();
  const int count = s_count;
  const int per_stage = tn / tm;
  const float* qb = qs + static_cast<size_t>(b) * mp * 3;
  const int* idb = qid + static_cast<size_t>(b) * mp;
  float best = INFINITY;
  int best_i = kSentinel;
  for (int s = 0; s < count; s += per_stage) {
    const int len = min(per_stage, count - s) * tm;
    if (static_cast<int>(threadIdx.x) < len) {
      const size_t src = static_cast<size_t>(list[s + threadIdx.x / tm]) * tm +
                         threadIdx.x % tm;
      stage[threadIdx.x] = make_float4(qb[3 * src], qb[3 * src + 1],
                                       qb[3 * src + 2],
                                       __int_as_float(idb[src]));
    }
    __syncthreads();
    for (int u = 0; u < len; ++u) {
      const float4 v = stage[u];
      const float d = ppt::sqdist3(v.x, v.y, v.z, px, py, pz);
      const int id = __float_as_int(v.w);
      if (d < best || (d == best && id < best_i)) {
        best = d;
        best_i = id;
      }
    }
    __syncthreads();
  }
  out_d[row] = best;
  out_i[row] = best_i;
}

cudaError_t set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// ps: float [B, ni*tb, 3]; qsub: float [B, mq, 3], mq a multiple of tbq;
// centers: int [B, ni] or null; out: float [B, ni*tb].
extern "C" int ppt_nn_band(const float* ps, const float* qsub,
                           const int* centers, int b, int ni, int mq, int tb,
                           int tbq, float* out, cudaStream_t stream) {
  if (b == 0 || ni == 0) return cudaSuccess;
  const size_t smem = static_cast<size_t>(9) * tbq * sizeof(float);
  const cudaError_t err =
      set_smem(reinterpret_cast<const void*>(nn_band_kernel), smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(ni, b);
  nn_band_kernel<<<grid, kBandThreads, smem, stream>>>(ps, qsub, centers,
                                                       ni * tb, mq, tb, tbq,
                                                       out);
  return cudaGetLastError();
}

// ps: float [B, ni*tn, 3]; qs: float [B, nj*tm, 3]; qid: int [B, nj*tm];
// cand: uint8 [B, ni, nj]; out_d: float [B, ni*tn]; out_i: int [B, ni*tn].
// tn <= 1024, a multiple of 32 and of tm.
extern "C" int ppt_nn_resident(const float* ps, const float* qs,
                               const int* qid, const uint8_t* cand, int b,
                               int ni, int nj, int tn, int tm, float* out_d,
                               int* out_i, cudaStream_t stream) {
  if (b == 0 || ni == 0) return cudaSuccess;
  const size_t smem = static_cast<size_t>(tn) * sizeof(float4) +
                      static_cast<size_t>(nj) * sizeof(int);
  const cudaError_t err =
      set_smem(reinterpret_cast<const void*>(nn_resident_kernel), smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(ni, b);
  nn_resident_kernel<<<grid, tn, smem, stream>>>(ps, qs, qid, cand, ni, nj,
                                                 tm, out_d, out_i);
  return cudaGetLastError();
}
