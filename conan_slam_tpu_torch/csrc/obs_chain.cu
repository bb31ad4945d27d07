// H7 obs_chain: the gated frame's measurement chain up to the innovation
// covariance S, in bands of measurement rows over many blocks, from no
// more of P than its gathered block.
//
// Replaces grid step 0 of the TPU kernel conan_slam_tpu/ops/frame_kernel.py
// :535 frame_update_obs (pallas_call :607, body _fullframe_kernel :402-447)
// on the split route: the observe, compact Hc, v and R, the frame-factor
// coupling and S (obs_band.cuh, which H10 obs_step.cu runs too):
//
//   hvb  = (Hc vrows^T) B                    (MP, NBP)
//   psub = Hc prc + hvb vrows                (MP, RP)   = (P' H^T)[rows]
//   S    = psub Hc^T + R                     (MP, MP)
//
// with P' = P + vtf^T B vtf, prc = P[rows][:, rows], vrows = vtf[:, rows].
// The sweep inverse of S that followed in the same grid step is H1
// (sweep_inverse.cu), and the panels (pht, gains, mean, NIS) are H8
// (obs_panels.cu).  On the TPU the later grid steps read hc, v and hvb from
// VMEM scratch; Hopper blocks run in no order, so this kernel writes them
// to device memory (rowc, hvb) for H8.
//
// What bounds it on the card: latency.  Its work is small (~5 MFLOP for
// psub and S at MP = 128, RP = 136, NBP = 24; ~175 KB read and written),
// so its time is its chain of dependent phases: the observe (atan2f,
// sqrtf, divisions), hvm, hvb, psub, S.  The design, as H2's: one block a
// band of one measurement (two rows; the wrapper's plan, ops/frame_kernel.py
// obs_chain_plan), each rerunning the observe of every slot (one thread a
// slot), so psub and S spread over MP / 2 blocks and no block waits on
// another.  A block stages prc rows 0, 1, 2 and its two slot rows, x[rows],
// zin and R with cp.async, and reads vrows and B through L1 (they are
// inputs of the launch).  Its shared memory grows with MP and RP, not with
// their product (csl_obs_smem_floats: 128 KB at MP 2048), so H7 takes every
// MP that H1's sweep takes.  No atomics: every output is one thread's
// fixed chain.
//
// Layouts (see conan_slam_tpu_torch/ops/frame_kernel.py): zin (3, NZL) rows
// [range, bearing, mask]; rsc (4,) R entries; xrows (RP,); prc (RP, RP);
// vrows (NBP, RP); bmat (NBP, NBP).  Outputs: s (MP, MP), rowc (MP, 8)
// [hc pose x, pose y, pose phi, slot x, slot y, 0, 0, v], hvb (MP, NBP).
#include "obs_band.cuh"

#define OC_THREADS 256

__global__ void __launch_bounds__(OC_THREADS)
obs_chain_kernel(const float* __restrict__ zin, const float* __restrict__ rsc,
                 const float* __restrict__ xrows, const float* __restrict__ prc,
                 const float* __restrict__ vrows, const float* __restrict__ bmat,
                 float* __restrict__ s_out, float* __restrict__ rowc_out,
                 float* __restrict__ hvb_out, int mp, int rp, int nbp, int band) {
    extern __shared__ __align__(16) float smem[];
    const CslObsSmem sm(smem, mp, rp, nbp, band);
    const int nzl = mp / 2;
    const int i0 = blockIdx.x * band;             // the band's first row (even)
    const int nb = min(band, mp - i0);            // its rows
    const int sr = max(0, min(rp - 3 - i0, nb));  // its slot rows inside prc

    // --- the band's inputs into shared memory ---
    for (int r = 0; r < 3 + sr; ++r)
        csl_stage(sm.prb + r * sm.rpa, prc + (size_t)(r < 3 ? r : i0 + r) * rp, rp);
    csl_stage(sm.xr, xrows, rp);
    csl_stage(sm.zs, zin, 3 * nzl);
    csl_stage(sm.rs, rsc, 4);
    csl_cp_async_commit();
    csl_cp_async_wait<0>();
    __syncthreads();

    // --- observe: compact Hc and v, one thread a slot ---
    csl_obs_observe(sm.xr, sm.zs, sm.hc, mp, rp);
    __syncthreads();

    // --- the band's rows of rowc, hvb, psub and S ---
    csl_obs_band(sm.prb, sm.rpa, sm.hc, sm.zs, sm.rs, sm.hvm, sm.hvb, sm.ps, i0, nb, mp, rp, nbp,
                 [&](int b, int c) { return __ldg(vrows + (size_t)b * rp + c); },
                 [&](int b, int c) { return __ldg(bmat + (size_t)b * nbp + c); }, s_out,
                 rowc_out, hvb_out);
}

extern "C" int csl_obs_chain(const float* zin, const float* rsc, const float* xrows,
                             const float* prc, const float* vrows, const float* bmat, float* s,
                             float* rowc, float* hvb, int mp, int rp, int nbp, int band,
                             void* stream) {
    if (mp <= 0 || mp % 2 || rp < 3 || nbp <= 0 || band <= 0 || band % 2)
        return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)csl_obs_smem_floats(mp, rp, nbp, band) * sizeof(float);
    if (smem > CSL_MAX_SMEM) return (int)cudaErrorInvalidValue;
    cudaError_t err = csl_allow_smem(obs_chain_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((mp + band - 1) / band);
    obs_chain_kernel<<<grid, OC_THREADS, smem, (cudaStream_t)stream>>>(
        zin, rsc, xrows, prc, vrows, bmat, s, rowc, hvb, mp, rp, nbp, band);
    return (int)cudaGetLastError();
}
