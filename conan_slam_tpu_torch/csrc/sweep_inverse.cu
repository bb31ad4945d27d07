// H1 sweep_inverse: S^-1 of an SPD matrix of size mp <= ~230 in ONE block.
//
// Replaces the TPU kernel conan_slam_tpu/ops/spd_inverse.py:135 spd_inverse
// (_sweep_pallas :114, kernel body _sweep_kernel :109 / sweep_ref_inverse
// :33) and the in-kernel conan_slam_tpu/ops/frame_kernel.py:192 _sweep_si
// of the chain kernel: on the port's frame path it is its own launch,
// between H2 (which writes S) and H3 (which reads S^-1).
//
// What bounds it on the card: latency, not bytes or FLOPs.  At the frame's
// shape (mp = 128, ~40 valid pivot blocks) the sweep is ~40 dependent
// rank-2 updates of a 64 KB matrix, each 2 x 16k FMAs; the whole input is
// 64 KB.  The design keeps S resident in shared memory (dynamic, above the
// 48 KB default) for the whole sweep so each pivot costs two block
// barriers and 32 shared-memory entries per thread, never a trip to device
// memory, and reads the bound nblk from device memory so the host never
// waits for it.
#include "common.cuh"

// The device routine: conan_slam_tpu/ops/spd_inverse.py:33 sweep_ref_inverse
// as wrapped by conan_slam_tpu/ops/frame_kernel.py:192 _sweep_si.
// Symmetrize, scale to a unit diagonal, sweep the first nblk 2x2 pivot
// blocks, unscale, symmetrize again, zero everything if anything is
// non-finite.  Both symmetrizations are load-bearing: the sweep reads pivot
// columns as rows, so an asymmetric S (from the row strips of an asymmetric
// P) would give an S^-1 whose asymmetry feeds back into P with gain every
// frame.
//
// A: (mp, mp) row-major in shared memory, holding S on entry and S^-1 on
// exit.  dsc, g0, g1, h0, h1: mp floats each of shared scratch.  All
// threads of the block must call it; blockDim.x is a multiple of 32.
static __device__ void csl_sweep_si(float* A, float* dsc, float* g0, float* g1, float* h0,
                                     float* h1, int mp, int nblk) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int nwarp = blockDim.x >> 5;

    // sym(S): each unordered pair once.
    for (int i = warp; i < mp; i += nwarp)
        for (int j = i + 1 + lane; j < mp; j += 32) {
            const float v = 0.5f * (A[i * mp + j] + A[j * mp + i]);
            A[i * mp + j] = v;
            A[j * mp + i] = v;
        }
    __syncthreads();
    for (int i = threadIdx.x; i < mp; i += blockDim.x)
        dsc[i] = rsqrtf(fmaxf(A[i * mp + i], 1e-30f));
    __syncthreads();
    for (int i = warp; i < mp; i += nwarp)
        for (int j = lane; j < mp; j += 32) A[i * mp + j] = A[i * mp + j] * dsc[i] * dsc[j];
    __syncthreads();

    // One pivot block per step, folded into one rank-2 update with shifted
    // factors (see sweep_ref_inverse):
    //   A <- A - (h0 g0 + h1 g1 + 2 [pivot diagonal])
    for (int k = 0; k < nblk; ++k) {
        const int k0 = 2 * k, k1 = k0 + 1;
        const float e00 = A[k0 * mp + k0], e01 = A[k0 * mp + k1], e11 = A[k1 * mp + k1];
        const float det = e00 * e11 - e01 * e01;
        const bool ok = det > 1e-30f && e00 > 1e-20f;
        const float idet = ok ? 1.0f / det : 0.0f;
        const float i00 = e11 * idet, i01 = -e01 * idet, i11 = e00 * idet;
        for (int j = threadIdx.x; j < mp; j += blockDim.x) {
            const float r0 = A[k0 * mp + j], r1 = A[k1 * mp + j];
            g0[j] = i00 * r0 + i01 * r1 - (j == k0 ? i00 : 0.f) - (j == k1 ? i01 : 0.f);
            g1[j] = i01 * r0 + i11 * r1 - (j == k0 ? i01 : 0.f) - (j == k1 ? i11 : 0.f);
            h0[j] = r0 - (j == k0 ? 1.f : 0.f);
            h1[j] = r1 - (j == k1 ? 1.f : 0.f);
        }
        __syncthreads();
        const float piv = ok ? 2.f : 0.f;
        for (int i = warp; i < mp; i += nwarp) {
            const float a0 = h0[i], a1 = h1[i];
            for (int j = lane; j < mp; j += 32) {
                float t = a0 * g0[j] + a1 * g1[j];
                if (i == j && (i == k0 || i == k1)) t += piv;
                A[i * mp + j] -= t;
            }
        }
        __syncthreads();
    }

    // S^-1 = -A, unscaled, then symmetrized; zero on any non-finite value.
    for (int i = warp; i < mp; i += nwarp)
        for (int j = lane; j < mp; j += 32) A[i * mp + j] = -A[i * mp + j] * dsc[i] * dsc[j];
    __syncthreads();
    int bad = 0;
    for (int i = warp; i < mp; i += nwarp)
        for (int j = i + lane; j < mp; j += 32) {
            const float v = 0.5f * (A[i * mp + j] + A[j * mp + i]);
            A[i * mp + j] = v;
            A[j * mp + i] = v;
            bad |= !isfinite(v);
        }
    if (__syncthreads_or(bad)) {
        for (int e = threadIdx.x; e < mp * mp; e += blockDim.x) A[e] = 0.f;
        __syncthreads();
    }
}


__global__ void __launch_bounds__(512)
sweep_inverse_kernel(const float* __restrict__ s, const int* __restrict__ nblk,
                     float* __restrict__ out, int mp) {
    extern __shared__ float smem[];
    float* A = smem;
    float* dsc = A + mp * mp;
    float* g0 = dsc + mp;
    float* g1 = g0 + mp;
    float* h0 = g1 + mp;
    float* h1 = h0 + mp;
    for (int e = threadIdx.x; e < mp * mp; e += blockDim.x) A[e] = s[e];
    __syncthreads();
    const int nb = min(max(nblk[0], 0), mp / 2);
    csl_sweep_si(A, dsc, g0, g1, h0, h1, mp, nb);
    for (int e = threadIdx.x; e < mp * mp; e += blockDim.x) out[e] = A[e];
}

extern "C" int csl_sweep_inverse(const float* s, const int* nblk, float* out, int mp,
                                 void* stream) {
    const size_t smem = (size_t)(mp * mp + 5 * mp) * sizeof(float);
    if (mp <= 0 || mp % 2 || smem > CSL_MAX_SMEM) return (int)cudaErrorInvalidValue;
    cudaError_t err = csl_allow_smem(sweep_inverse_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    sweep_inverse_kernel<<<1, 512, smem, (cudaStream_t)stream>>>(s, nblk, out, mp);
    return (int)cudaGetLastError();
}

extern "C" const char* csl_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
