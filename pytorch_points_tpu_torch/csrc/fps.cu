// Furthest point sampling with emitted coordinates.
//
// Replaces the TPU kernel pytorch_points_tpu/kernels/fps.py::_fps_kernel
// (called through furthest_point_sample(emit_coords=True)).
//
// Semantics: a serial k-step loop per cloud. Each point keeps its running
// min squared distance to the selected set; each step selects the argmax,
// ties to the lowest index. Valid points start at 1e10, masked points at
// -inf (never selected while a valid point is left), an optional seed at
// 2e10. Step 0 skips the min-fold, so it selects the first valid index (or
// the seed). With fewer valid points than k, later steps re-select
// duplicates, exactly as the reference does.
//
// On the card: the k steps are serial, so one block serves one cloud and
// each step costs one pass over the cloud plus one block-wide
// (max value, min index) reduction. It is bound by that per-step latency
// (two barriers and a shuffle tree), not by bytes or flops: the running
// min-distance (N*4 bytes) stays in shared memory when it fits, else in a
// scratch buffer from the wrapper, and the coordinates stream from L1/L2.
// With B blocks only B of the 132 SMs work; splitting a cloud over a
// cluster of blocks is later work.
#include <limits.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void warp_argmax(float& bv, int& bi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, bv, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    if (better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    fps_kernel(const float* __restrict__ xyz, const uint8_t* __restrict__ mask,
               const int* __restrict__ seed, int n, int k,
               int* __restrict__ out_idx, float* __restrict__ out_xyz,
               float* __restrict__ scratch) {
  extern __shared__ float smem_mind[];
  __shared__ float warp_v[kWarps];
  __shared__ int warp_i[kWarps];
  __shared__ float sel_xyz[3];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const float* p = xyz + static_cast<size_t>(b) * n * 3;
  float* mind = scratch ? scratch + static_cast<size_t>(b) * n : smem_mind;

  for (int i = tid; i < n; i += kThreads) {
    const bool valid = mask == nullptr || mask[static_cast<size_t>(b) * n + i];
    mind[i] = valid ? 1e10f : -INFINITY;
  }
  __syncthreads();
  if (seed != nullptr && tid == 0) mind[seed[b]] = 2e10f;
  __syncthreads();

  float sx = 0.f, sy = 0.f, sz = 0.f;
  for (int j = 0; j < k; ++j) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int i = tid; i < n; i += kThreads) {
      float m = mind[i];
      if (j > 0) {
        m = fminf(m, ppt::sqdist3(p[3 * i], p[3 * i + 1], p[3 * i + 2], sx,
                                  sy, sz));
        mind[i] = m;
      }
      if (better(m, i, bv, bi)) {
        bv = m;
        bi = i;
      }
    }
    warp_argmax(bv, bi);
    if ((tid & 31) == 0) {
      warp_v[tid >> 5] = bv;
      warp_i[tid >> 5] = bi;
    }
    __syncthreads();
    if (tid < 32) {
      bv = warp_v[tid];  // kWarps == 32
      bi = warp_i[tid];
      warp_argmax(bv, bi);
      if (tid == 0) {
        const size_t o = static_cast<size_t>(b) * k + j;
        out_idx[o] = bi;
        for (int c = 0; c < 3; ++c) {
          sel_xyz[c] = p[3 * bi + c];
          out_xyz[3 * o + c] = sel_xyz[c];
        }
      }
    }
    __syncthreads();
    sx = sel_xyz[0];
    sy = sel_xyz[1];
    sz = sel_xyz[2];
  }
}

}  // namespace

// mask (bool [B,N]) and seed (int32 [B]) may be null. scratch (float
// [B,N]) is null when the running min-distance fits in shared memory.
extern "C" int ppt_fps(const float* xyz, const uint8_t* mask, const int* seed,
                       int b, int n, int k, int* out_idx, float* out_xyz,
                       float* scratch, cudaStream_t stream) {
  const size_t smem = scratch ? 0 : static_cast<size_t>(n) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  fps_kernel<<<b, kThreads, smem, stream>>>(xyz, mask, seed, n, k, out_idx,
                                            out_xyz, scratch);
  return cudaGetLastError();
}
