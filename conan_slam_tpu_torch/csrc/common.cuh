// Helpers shared by the kernels of conan_slam_tpu_torch (one library, C ABI).
#pragma once

#include <cuda_runtime.h>

// Hopper: 227 KB of shared memory per block, above 48 KB only as dynamic
// shared memory after cudaFuncSetAttribute.
#define CSL_MAX_SMEM 232448

#define CSL_PI_F 3.14159265358979323846f
#define CSL_TWO_PI_F 6.28318530717958647692f

// Wrap to [-pi, pi) with the remainder convention of the reference
// (jnp.remainder / torch.remainder: the result takes the divisor's sign).
__device__ __forceinline__ float csl_wrap(float a) {
    float r = fmodf(a + CSL_PI_F, CSL_TWO_PI_F);
    if (r < 0.f) r += CSL_TWO_PI_F;
    return r - CSL_PI_F;
}

// Raise a kernel's dynamic shared-memory cap once; returns the CUDA error.
template <typename Kernel>
static cudaError_t csl_allow_smem(Kernel kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bytes);
}
