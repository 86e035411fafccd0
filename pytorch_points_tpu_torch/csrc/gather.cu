// Row gather: out[b, k, :] = features[b, idx[b, k], :], exact in float32.
//
// Replaces the TPU kernels pytorch_points_tpu/kernels/gather.py::
// _gather_kernel_t (gather_rows_t) and ::_gather_kernel (gather_rows, the
// older layout of the same function), which build each row from one-hot MXU
// products because the TPU has no fast per-row dynamic load. On Hopper a
// plain indexed load is exact and cheap, so the port uses it for every
// channel count, not only the reference's C <= 16.
//
// On the card: one thread per output element, neighbouring threads on
// neighbouring channels of a row. It is bound by device-memory bytes
// (4 * (C + 1) read and 4 * C written per row); rows of a narrow C are
// scattered loads whose sectors are mostly wasted.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    gather_rows_kernel(const float* __restrict__ f, const int* __restrict__ idx,
                       int n, int k, int c, long long total,
                       float* __restrict__ out) {
  for (long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * kThreads) {
    const long long r = e / c;  // row of the output, b * k + kk
    const long long ch = e - r * c;
    const long long b = r / k;
    out[e] = f[(b * n + idx[r]) * c + ch];
  }
}

}  // namespace

extern "C" int ppt_gather_rows(const float* features, const int* idx, int b,
                               int n, int k, int c, float* out,
                               cudaStream_t stream) {
  const long long total = static_cast<long long>(b) * k * c;
  if (total == 0) return cudaSuccess;
  const long long blocks = (total + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(blocks < 65536 ? blocks : 65536);
  gather_rows_kernel<<<grid, kThreads, 0, stream>>>(features, idx, n, k, c,
                                                    total, out);
  return cudaGetLastError();
}
