// Row gather: out[b, k, :] = features[b, idx[b, k], :], exact: float32
// rows (ppt_gather_rows) and bfloat16 rows (ppt_gather_rows_bf16, the
// instance the bf16 feature paths take: a copy, so the element is moved as
// its 16 bits and no conversion happens).
//
// Replaces the TPU kernels pytorch_points_tpu/kernels/gather.py::
// _gather_kernel_t (gather_rows_t) and ::_gather_kernel (gather_rows, the
// older layout of the same function), which build each row from one-hot MXU
// products because the TPU has no fast per-row dynamic load. On Hopper a
// plain indexed load is exact and cheap, so the port uses it for every
// channel count, not only the reference's C <= 16.
//
// On the card it is bound by device-memory bytes (4 + s C read and s C
// written per row, s = 4 bytes an element for float32, 2 for bfloat16).
// The design keeps the per-element work to the copy:
//  * float32 C <= 4: a warp takes 32 consecutive rows of one cloud, loads
//    their 32 indices in one coalesced load, and copies the 32 C values
//    lane by lane (the row of value j is j / C, C a compile-time constant,
//    its index shuffled from the lane that loaded it), so the stores are
//    contiguous;
//  * other rows: tpr threads a row (tpr a power of two up to 32), each row's
//    index loaded once, 16-byte vectors where a row is a whole number of
//    them and the rows are 16-byte aligned (C = 128 at sa2 and fp: 32
//    float4 a row in float32, 16 in bfloat16), else element by element
//    (the bf16 paths give C = 128 and 256 only);
//  * a block covers a tile of rows of one cloud (one division per thread
//    finds it), and index arithmetic is 32-bit unless B N C or B K C
//    reaches 2^31.
// Rows of a narrow C are scattered loads whose sectors are mostly wasted.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// C <= 4 (float32 rows). Block `blockIdx.x` is tile t of cloud b (tiles =
// blocks a cloud), kThreads rows a tile, 32 rows a warp.
template <int C, typename Index>
__global__ void __launch_bounds__(kThreads)
    gather_narrow_kernel(const float* __restrict__ f,
                         const int* __restrict__ idx, int n, int k, int tiles,
                         float* __restrict__ out) {
  const int b = blockIdx.x / tiles;
  const int tile = blockIdx.x - b * tiles;
  const int lane = threadIdx.x & 31;
  const int row0 = tile * kThreads + (threadIdx.x & ~31);  // the warp's first
  if (row0 >= k) return;  // the whole warp
  const int rows = min(32, k - row0);
  const Index first = static_cast<Index>(b) * k + row0;
  const int src = lane < rows ? idx[first + lane] : 0;
  const float* fb = f + static_cast<Index>(b) * n * C;
  float* dst = out + first * C;
#pragma unroll
  for (int j = lane; j < 32 * C; j += 32) {
    const int r = j / C;
    const int s = __shfl_sync(kFull, src, r);
    if (r < rows) dst[j] = fb[static_cast<Index>(s) * C + (j - r * C)];
  }
}

// T: the unit of the copy (float or float4 for float32 rows; unsigned short
// or uint4 for bfloat16 rows), cv = units of T in a row. Block `blockIdx.x`
// is tile t of cloud b (tiles = blocks a cloud), kThreads >> log_tpr rows a
// tile.
template <typename T, typename Index>
__global__ void __launch_bounds__(kThreads)
    gather_rows_kernel(const T* __restrict__ f, const int* __restrict__ idx,
                       int n, int k, int cv, int log_tpr, int tiles,
                       T* __restrict__ out) {
  const int b = blockIdx.x / tiles;
  const int tile = blockIdx.x - b * tiles;
  const int kk = tile * (kThreads >> log_tpr) + (threadIdx.x >> log_tpr);
  if (kk >= k) return;
  const Index row = static_cast<Index>(b) * k + kk;
  const T* src = f + (static_cast<Index>(b) * n + idx[row]) * cv;
  T* dst = out + row * cv;
  for (int v = threadIdx.x & ((1 << log_tpr) - 1); v < cv; v += 1 << log_tpr)
    dst[v] = src[v];
}

bool fits_32_bit(int b, int n, int k, int c) {
  return static_cast<long long>(b) * (n > k ? n : k) * c < (1LL << 31);
}

template <int C>
cudaError_t launch_narrow(const float* f, const int* idx, int b, int n, int k,
                          float* out, cudaStream_t stream) {
  const int tiles = (k + kThreads - 1) / kThreads;
  const long long blocks = static_cast<long long>(b) * tiles;
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  if (fits_32_bit(b, n, k, C)) {
    gather_narrow_kernel<C, int><<<static_cast<unsigned>(blocks), kThreads, 0,
                                   stream>>>(f, idx, n, k, tiles, out);
  } else {
    gather_narrow_kernel<C, long long><<<static_cast<unsigned>(blocks),
                                         kThreads, 0, stream>>>(
        f, idx, n, k, tiles, out);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const T* f, const int* idx, int b, int n, int k, int cv,
                   int c, T* out, cudaStream_t stream) {
  int log_tpr = 0;
  while ((1 << log_tpr) < cv && log_tpr < 5) ++log_tpr;
  const int rows = kThreads >> log_tpr;
  const int tiles = (k + rows - 1) / rows;
  const long long blocks = static_cast<long long>(b) * tiles;
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  if (fits_32_bit(b, n, k, c)) {
    gather_rows_kernel<T, int><<<static_cast<unsigned>(blocks), kThreads, 0,
                                 stream>>>(f, idx, n, k, cv, log_tpr, tiles,
                                           out);
  } else {
    gather_rows_kernel<T, long long><<<static_cast<unsigned>(blocks),
                                       kThreads, 0, stream>>>(
        f, idx, n, k, cv, log_tpr, tiles, out);
  }
  return cudaGetLastError();
}

bool aligned(const void* a, const void* b, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(a) % bytes == 0 &&
         reinterpret_cast<uintptr_t>(b) % bytes == 0;
}

}  // namespace

// features: float [B, N, C]; idx: int [B, K], each in [0, N); out: float
// [B, K, C].
extern "C" int ppt_gather_rows(const float* features, const int* idx, int b,
                               int n, int k, int c, float* out,
                               cudaStream_t stream) {
  if (b < 0 || n < 0 || k < 0 || c < 0) return cudaErrorInvalidValue;
  if (b == 0 || k == 0 || c == 0) return cudaSuccess;
  switch (c) {
    case 1: return launch_narrow<1>(features, idx, b, n, k, out, stream);
    case 2: return launch_narrow<2>(features, idx, b, n, k, out, stream);
    case 3: return launch_narrow<3>(features, idx, b, n, k, out, stream);
    case 4: return launch_narrow<4>(features, idx, b, n, k, out, stream);
    default: break;
  }
  if (c % 4 == 0 && aligned(features, out, 16))
    return launch(reinterpret_cast<const float4*>(features), idx, b, n, k,
                  c / 4, c, reinterpret_cast<float4*>(out), stream);
  return launch(features, idx, b, n, k, c, c, out, stream);
}

// features: bfloat16 [B, N, C] (read as its 16-bit patterns); idx: int
// [B, K], each in [0, N); out: bfloat16 [B, K, C].
extern "C" int ppt_gather_rows_bf16(const void* features, const int* idx,
                                    int b, int n, int k, int c, void* out,
                                    cudaStream_t stream) {
  using E = unsigned short;
  if (b < 0 || n < 0 || k < 0 || c < 0) return cudaErrorInvalidValue;
  if (b == 0 || k == 0 || c == 0) return cudaSuccess;
  if (c % 8 == 0 && aligned(features, out, 16))
    return launch(static_cast<const uint4*>(features), idx, b, n, k, c / 8,
                  c, static_cast<uint4*>(out), stream);
  return launch(static_cast<const E*>(features), idx, b, n, k, c, c,
                static_cast<E*>(out), stream);
}
