// Every float x: csl_sincosf (csrc/coeff.cuh, the recursion's sine and
// cosine without local memory) against CUDA's sincosf, bit for bit.
// Prints the mismatches for |x| < 105,615, NaN and infinities (where the
// two must agree) and for larger finite |x| (where csl_sincosf reduces less
// accurately); exits non-zero on any of the first kind.
// Built and run by tests/test_torch_cuda.py:
//   nvcc -O3 -gencode arch=compute_90a,code=sm_90a -I conan_slam_tpu_torch/csrc ...
#include <cstdio>

#include "coeff.cuh"

__global__ void compare(unsigned long long* bad) {
    unsigned long long near = 0, far = 0;
    for (unsigned long long u = blockIdx.x * (unsigned long long)blockDim.x + threadIdx.x;
         u < (1ull << 32); u += (unsigned long long)gridDim.x * blockDim.x) {
        const float x = __uint_as_float((unsigned)u);
        float s0, c0, s1, c1;
        sincosf(x, &s0, &c0);
        csl_sincosf(x, &s1, &c1);
        const bool same =
            (__float_as_uint(s0) == __float_as_uint(s1) || (isnan(s0) && isnan(s1))) &&
            (__float_as_uint(c0) == __float_as_uint(c1) || (isnan(c0) && isnan(c1)));
        if (!same) {
            if (fabsf(x) < 105615.f || isnan(x) || isinf(x)) ++near;
            else ++far;
        }
    }
    atomicAdd(bad, near);
    atomicAdd(bad + 1, far);
}

int main() {
    unsigned long long* d;
    unsigned long long h[2] = {0, 0};
    cudaMalloc(&d, sizeof(h));
    cudaMemset(d, 0, sizeof(h));
    compare<<<132 * 8, 256>>>(d);
    cudaMemcpy(h, d, sizeof(h), cudaMemcpyDeviceToHost);
    const cudaError_t err = cudaGetLastError();
    printf("mismatches: %llu at |x| < 105615, NaN or inf; %llu at larger finite |x| (%s)\n", h[0],
           h[1], cudaGetErrorString(err));
    return h[0] != 0 || err != cudaSuccess;
}
