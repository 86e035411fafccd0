// Deterministic row scatter-add: out[b, r, :] = sum of updates[b, k, :] over
// the k with idx[b, k] == r, summed in ascending k, in float32.
//
// Replaces the TPU kernels pytorch_points_tpu/kernels/scatter.py::
// _scatter_kernel_t (scatter_add_csum_t) and ::_scatter_kernel
// (scatter_add_csum), which compute the same sum as one-hot MXU products
// because a TPU has neither atomics nor fast dynamic stores. Their bf16
// hi/lo split of the updates (about 2^-16 relative error at parts=2) is a
// device of the MXU and is not carried over: here every update enters in
// full float32, so a permutation write is exact and a sum is the f32 sum
// in ascending k.
//
// The wrapper does the glue: a stable sort of each cloud's updates by
// target row (order) and the row offsets into that order (offsets[r] ..
// offsets[r + 1]), as the JAX wrapper pads. No atomics: each output element
// belongs to one thread, which walks its row's run of the order in
// ascending k, so the result does not change from run to run. A row with
// no update gets 0.
//
// On the card: one thread per output element (b, r, c), neighbouring
// threads on neighbouring channels. It is bound by bytes: it reads each
// update once (4 C bytes plus its 4-byte order entry) and writes n C
// floats; the wrapper's sort of B K keys costs about as much again. The
// reads of narrow rows (C = 3) are scattered, so most of each sector is
// wasted, as in the gather.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    scatter_rows_kernel(const float* __restrict__ upd,
                        const int* __restrict__ order,
                        const int* __restrict__ offsets, int c,
                        long long total, float* __restrict__ out) {
  for (long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * kThreads) {
    const long long row = e / c;  // b * n + r
    const long long ch = e - row * c;
    const int lo = offsets[row];
    const int hi = offsets[row + 1];
    float acc = 0.f;
    for (int j = lo; j < hi; ++j)
      acc = __fadd_rn(acc, upd[static_cast<long long>(order[j]) * c + ch]);
    out[e] = acc;
  }
}

}  // namespace

// upd: float [B*K, C]; order: int [B*K], flat update indices sorted by
// (cloud, row), stable; offsets: int [B*n + 1]. out: float [B*n, C].
extern "C" int ppt_scatter_rows(const float* upd, const int* order,
                                const int* offsets, int rows, int c,
                                float* out, cudaStream_t stream) {
  const long long total = static_cast<long long>(rows) * c;
  if (total == 0) return cudaSuccess;
  const long long blocks = (total + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(blocks < 65536 ? blocks : 65536);
  scatter_rows_kernel<<<grid, kThreads, 0, stream>>>(upd, order, offsets, c,
                                                     total, out);
  return cudaGetLastError();
}
