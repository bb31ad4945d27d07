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
// fmodf is exact: on (-2 pi, 2 pi) it returns t itself, and on
// [2 pi, 4 pi) t - 2 pi, which is exact there too (Sterbenz).  Those cases
// skip the fmodf call and give the same bits.
__device__ __forceinline__ float csl_wrap(float a) {
    const float t = a + CSL_PI_F;
    float r;
    if (t >= 0.f && t < CSL_TWO_PI_F) {
        r = t;
    } else if (t >= CSL_TWO_PI_F && t < 2.f * CSL_TWO_PI_F) {
        r = t - CSL_TWO_PI_F;
    } else if (t < 0.f && t > -CSL_TWO_PI_F) {
        r = t + CSL_TWO_PI_F;
    } else {
        r = fmodf(t, CSL_TWO_PI_F);
        if (r < 0.f) r += CSL_TWO_PI_F;
    }
    return r - CSL_PI_F;
}

// cp.async copies of 16 or 4 bytes from device to shared memory; with
// !in nothing is read and the destination is zero-filled.
__device__ __forceinline__ unsigned csl_smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void csl_cp_async16(float* dst, const float* src, bool in) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(csl_smem_addr(dst)),
                 "l"(src), "r"(in ? 16 : 0)
                 : "memory");
}

__device__ __forceinline__ void csl_cp_async4(float* dst, const float* src, bool in) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(csl_smem_addr(dst)),
                 "l"(src), "r"(in ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void csl_cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void csl_cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy n floats from device memory to shared memory with cp.async, the
// block's threads striding over them: 16-byte copies when both ends are
// 16-byte aligned and n % 4 == 0, 4-byte ones otherwise.  The caller
// commits and waits before a barrier.
__device__ __forceinline__ void csl_stage(float* dst, const float* src, int n) {
    const bool vec = ((reinterpret_cast<unsigned long long>(src) | csl_smem_addr(dst)) & 15u) == 0 &&
                     (n & 3) == 0;
    const int tid = threadIdx.x, nth = blockDim.x;
    if (vec) {
        for (int e = 4 * tid; e < n; e += 4 * nth) csl_cp_async16(dst + e, src + e, true);
    } else {
        for (int e = tid; e < n; e += nth) csl_cp_async4(dst + e, src + e, true);
    }
}

// A kernel's registers a thread and local-memory bytes a thread (spills and
// stack) as the runtime reports them (cudaFuncGetAttributes).
template <typename Kernel>
static cudaError_t csl_func_regs(Kernel kernel, int* regs, int* local) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    *regs = attr.numRegs;
    *local = (int)attr.localSizeBytes;
    return cudaSuccess;
}

// Raise a kernel's dynamic shared-memory cap once; returns the CUDA error.
template <typename Kernel>
static cudaError_t csl_allow_smem(Kernel kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bytes);
}
