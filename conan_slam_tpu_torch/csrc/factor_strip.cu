// H5 factor_strip: the frame factors of the gated path, P_frame = P0 +
// vtf^T B vtf, as the post-frame mean, the pose trace, the (NBP, D) factor
// strip vtf and the (NBP, NBP) middle matrix B.
//
// Replaces the TPU kernel conan_slam_tpu/ops/factor_kernel.py:266
// frame_factors_fused (pallas_call :316, body _factor_kernel :194), which
// ran the S-step coefficient recursion once and wrote the whole strip from
// VMEM.  Hopper blocks run in parallel and in no order, so there is no
// "once" to share: the grid runs over column panels of D and EVERY block
// reruns the recursion (csl_coeff_recursion, coeff.cuh, the routine H2
// runs too) on its first warp, a few hundred scalar operations, then
// writes its columns:
//
//   vtf[j, n] = p2[n] c_j[0] + e0[n] c_j[1] + e1[n] c_j[2] + e2[n] c_j[3]
//               for the NB coefficient columns c_j, zero for NB <= j < NBP
//   xf[n]     = pose[n] (n < 3), x0[n] + p2[n] corr0 (map lanes, with the
//               heading observation), x0[n] (without)
//
// with p2 = P0 e2 (row 2 of the symmetric P0).  Block 0 also writes the
// pose trace (S, 3) and B.
//
// What bounds it on the card: latency.  It moves ~(NBP + 3) D floats
// (~110 KB at D = 1024) and does no arithmetic to speak of; its time is
// the recursion (sinf/cosf and divisions in a dependent chain) plus one
// launch.  The design keeps that chain on one warp per block (its
// per-sub-step terms in shared memory, coeff.cuh), never waits on another block, and
// writes the strip with one thread per column so that every row store is
// a coalesced line per warp.  Columns past D are masked: any D works.
#include "coeff.cuh"

#define FS_THREADS 256

__global__ void __launch_bounds__(FS_THREADS)
factor_strip_kernel(const float* __restrict__ subs, const float* __restrict__ qc,
                    const float* __restrict__ x0, const float* __restrict__ p2,
                    float* __restrict__ xf, float* __restrict__ pt, float* __restrict__ vtf,
                    float* __restrict__ bm, int S, int nbp, int d, float wheel_base, float dt,
                    float sigma_heading, int use_heading) {
    extern __shared__ float coeff[];   // the recursion's (csl_coeff_smem_floats(S)), columns first
    __shared__ float scal[4];          // pose (3), corr0
    const float* cols = coeff;
    const bool heading = use_heading != 0;
    const float r_head = sigma_heading * sigma_heading;
    const int nb = csl_coeff_cols(S, heading);
    if (threadIdx.x < 32) {
        const float p2h[3] = {p2[0], p2[1], p2[2]};
        float pose[3] = {x0[0], x0[1], x0[2]};
        float corr0;
        csl_coeff_recursion(subs, S, qc, p2h, pose, wheel_base, dt, r_head, heading,
                            blockIdx.x == 0 ? pt : nullptr, &corr0, coeff);
        if (threadIdx.x == 0) {
            scal[0] = pose[0];
            scal[1] = pose[1];
            scal[2] = pose[2];
            scal[3] = corr0;
        }
    }
    __syncthreads();

    const int n = blockIdx.x * FS_THREADS + threadIdx.x;
    if (n < d) {
        const float p2n = p2[n];
        for (int j = 0; j < nb; ++j) {
            const float* c = cols + 4 * j;
            vtf[(size_t)j * d + n] = p2n * c[0] + (n < 3 ? c[1 + n] : 0.f);
        }
        for (int j = nb; j < nbp; ++j) vtf[(size_t)j * d + n] = 0.f;
        xf[n] = n < 3 ? scal[n] : (heading ? x0[n] + p2n * scal[3] : x0[n]);
    }

    if (blockIdx.x == 0) {
        const float p22 = p2[2];
        for (int e = threadIdx.x; e < nbp * nbp; e += FS_THREADS) {
            const int i = e / nbp, j = e % nbp;
            float v = 0.f;
            if (i == 0 && j == 0) v = p22;
            else if ((i == 0 && j == 1) || (i == 1 && j == 0)) v = 1.f;
            else if (i == j && i >= 2 && i < 2 + 2 * S) v = 1.f;
            else if (i == j && i >= 2 + 2 * S && i < nb) v = r_head;
            bm[e] = v;
        }
    }
}

extern "C" int csl_factor_strip(const float* subs, const float* qc, const float* x0,
                                const float* p2, float* xf, float* pt, float* vtf, float* bm,
                                int S, int nbp, int d, float wheel_base, float dt,
                                float sigma_heading, int use_heading, void* stream) {
    if (S <= 0 || S > CSL_MAX_STEPS || d < 3 || nbp < csl_coeff_cols(S, use_heading != 0))
        return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)csl_coeff_smem_floats(S) * sizeof(float);
    const cudaError_t err = csl_allow_smem(factor_strip_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((d + FS_THREADS - 1) / FS_THREADS);
    factor_strip_kernel<<<grid, FS_THREADS, smem, (cudaStream_t)stream>>>(
        subs, qc, x0, p2, xf, pt, vtf, bm, S, nbp, d, wheel_base, dt, sigma_heading,
        use_heading);
    return (int)cudaGetLastError();
}
