// Shared helpers of the port's CUDA kernels.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ppt {

// Squared distance in the JAX reference's order, ((dx*dx + dy*dy) + dz*dz),
// with every operation rounded on its own. nvcc would otherwise contract
// a*b + c into an FMA, which rounds once and picks other winners on
// near-ties than the reference and the plain PyTorch versions.
__device__ __forceinline__ float sqdist3(float ax, float ay, float az,
                                         float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

}  // namespace ppt
