// Shared helpers of the tetranerf_torch kernels.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

// Maximum that propagates NaN from either side, as jnp.maximum and
// torch.maximum do (fmaxf would drop it).
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}
