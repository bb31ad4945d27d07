// H2 frame_chain: the part of a known-association frame that needs no more
// of P than its gathered (RP, RP) block, up to the innovation covariance S,
// in bands of measurement rows over many blocks.
//
// Replaces grid step 0 of the TPU kernel conan_slam_tpu/ops/frame_kernel.py
// :1123 _chain_dispatch (pallas_call :1139, body _bigchain_kernel :910-1058):
// the S-step coefficient recursion (ops/factor_kernel.py:41 coeff_recursion,
// the routine of coeff.cuh, which H5 runs too), K4 = C B C^T, the
// range-bearing observe (_observe_core :266, with atan2f and the remainder
// wrap instead of the Mosaic workarounds) and
// S = Hc P' Hc^T + R.  The sweep inverse of S that followed in the same
// grid step is its own launch here (H1, sweep_inverse.cu), and the gains
// siv and the NIS move into the panel kernel (H3, frame_panels.cu).
//
// On the TPU the grid ran in order and the later panel steps read hc, hx,
// siv and the scalars from VMEM/SMEM scratch.  Hopper blocks run in
// parallel and in no order, so this kernel writes that state to device
// memory (rowc, ms) for H3.
//
// What bounds it on the card: latency.  Its work is small (~0.6 MFLOP for
// psub and S at MP = 128, RP = 136; ~75 KB of prc read, 64 KB of S
// written: 0.04 us of bytes), so its time is its chain of dependent
// phases: the coefficient recursion (sinf/cosf, divisions and wraps over S
// sub-steps), then the observe (atan2f, sqrtf), psub and S.  The design:
//   - Bands of `band` measurement rows (whole measurements; the wrapper's
//     plan, ops/frame_kernel.py frame_chain_plan) go to separate blocks, so
//     psub and S spread over the SMs.  A band needs prc rows 0, 1, 2 and
//     its own slot rows, over all RP columns, and the compact Hc of every
//     row.  Every block reruns the recursion and the observe, as H5 does:
//     both are scalar work of one warp and one thread a measurement, and
//     no block waits on another.
//   - At entry every thread issues cp.async copies of the band's prc rows,
//     x0rows, zin and R into shared memory; warp 0 then runs the recursion
//     while they are in flight.
//   - The recursion runs on one warp, its per-sub-step terms in shared
//     memory after the band's (coeff.cuh), so S is bounded by shared
//     memory only (CSL_MAX_STEPS): no local memory.  K4's 16 entries are
//     formed on 16 lanes.
//   - Compact Hc, hp2, hg and v are kept as structure of arrays in shared
//     memory, so the S phase reads consecutive words (no bank conflicts).
//   - Exactly one block (0) writes pt, k4 and ms; each band writes its rows
//     of S and rowc.  No atomics: every output is one thread's fixed chain.
//   - The phases after the staging are chain_band.cuh, which H9
//     (frame_step.cu) runs too.
//
// Layouts (see conan_slam_tpu_torch/ops/frame_kernel.py): subs (4, S) rows
// [vn, swan, phi_meas, active]; qc (3,) chol(Q) [l00, l10, l11]; zin
// (3, NZL) rows [range, bearing, mask]; rsc (4,) R entries; x0rows (RP,);
// prc (RP, RP).  Outputs: pt (S, 3), k4 (8, 8), s (MP, MP), rowc (MP, 8)
// [hc pose x, pose y, pose phi, slot x, slot y, hp2, hg, v], ms (32,)
// [pose (3), corr0, alpha, g (3), m3 (9), 0...].
#include "chain_band.cuh"

#define FC_THREADS 256

__global__ void __launch_bounds__(FC_THREADS)
frame_chain_kernel(const float* __restrict__ subs, const float* __restrict__ qc,
                   const float* __restrict__ zin, const float* __restrict__ rsc,
                   const float* __restrict__ x0rows, const float* __restrict__ prc,
                   float* __restrict__ pt_out, float* __restrict__ k4_out,
                   float* __restrict__ s_out, float* __restrict__ rowc_out,
                   float* __restrict__ ms_out, int S, int mp, int rp, int band,
                   float wheel_base, float dt, float sigma_heading, int use_heading) {
    extern __shared__ __align__(16) float smem[];
    __shared__ float ms[32];                      // frame scalars, as ms_out
    const int tid = threadIdx.x;
    const int nzl = mp / 2;
    const int rpa = (rp + 3) & ~3;                // 16-byte rows in shared memory
    const int i0 = blockIdx.x * band;             // the band's first row (even)
    const int nb = min(band, mp - i0);            // its rows
    const int sr = max(0, min(rp - 3 - i0, nb));  // its slot rows inside prc
    float* prb = smem;                            // (3 + band, rpa): prc rows 0, 1, 2, 3 + i0, ...
    float* xr = prb + (3 + band) * rpa;           // (rpa,) x0rows
    float* zs = xr + rpa;                         // (3, nzl) zin
    float* rs = zs + ((3 * nzl + 3) & ~3);        // (4,) rsc
    float* hc = rs + 4;                           // (8, mp) rowc as structure of arrays
    float* ps = hc + 8 * mp;                      // (band, rp) the band's rows of psub
    float* coeff = smem + csl_chain_smem_floats(mp, rp, band);   // the recursion's (coeff.cuh)

    // --- the band's inputs into shared memory, in flight during the recursion ---
    for (int r = 0; r < 3 + sr; ++r)
        csl_stage(prb + r * rpa, prc + (size_t)(r < 3 ? r : i0 + r) * rp, rp);
    csl_stage(xr, x0rows, rp);
    csl_stage(zs, zin, 3 * nzl);
    csl_stage(rs, rsc, 4);

    // --- coefficient recursion (warp 0) and K4 (16 lanes) ---
    if (tid < 32)
        csl_chain_scalars(subs, S, qc, prc + 2 * rp, x0rows, wheel_base, dt,
                          sigma_heading * sigma_heading, use_heading != 0,
                          blockIdx.x == 0 ? pt_out : nullptr, blockIdx.x == 0 ? k4_out : nullptr,
                          ms, coeff);
    csl_cp_async_commit();
    csl_cp_async_wait<0>();
    __syncthreads();
    if (blockIdx.x == 0 && tid < 32) ms_out[tid] = ms[tid];

    // --- observe against the post-frame mean at the gathered rows: compact
    //     Hc, hp2 = Hc p2[rows], hg = Hc[:, :3] g and v, one thread a slot ---
    csl_chain_observe(ms, xr, prb + 2 * rpa, zs, hc, mp, rp);
    __syncthreads();

    // --- the band's rows of rowc, psub and S ---
    csl_chain_band(prb, rpa, hc, ms, zs, rs, ps, i0, nb, mp, rp, s_out, rowc_out);
}

// Shared memory of one block: prc rows, x0rows, zin, R, rowc, psub, then
// the recursion's columns and per-sub-step terms.
static size_t frame_chain_smem(int mp, int rp, int band, int S) {
    return (size_t)(csl_chain_smem_floats(mp, rp, band) + csl_coeff_smem_floats(S)) * sizeof(float);
}

extern "C" int csl_frame_chain(const float* subs, const float* qc, const float* zin,
                               const float* rsc, const float* x0rows, const float* prc,
                               float* pt, float* k4, float* s, float* rowc, float* ms, int S,
                               int mp, int rp, int band, float wheel_base, float dt,
                               float sigma_heading, int use_heading, void* stream) {
    if (S <= 0 || S > CSL_MAX_STEPS || mp <= 0 || mp % 2 || rp < 3 || band <= 0 || band % 2)
        return (int)cudaErrorInvalidValue;
    const size_t smem = frame_chain_smem(mp, rp, band, S);
    if (smem > CSL_MAX_SMEM) return (int)cudaErrorInvalidValue;
    cudaError_t err = csl_allow_smem(frame_chain_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((mp + band - 1) / band);
    frame_chain_kernel<<<grid, FC_THREADS, smem, (cudaStream_t)stream>>>(
        subs, qc, zin, rsc, x0rows, prc, pt, k4, s, rowc, ms, S, mp, rp, band, wheel_base, dt,
        sigma_heading, use_heading);
    return (int)cudaGetLastError();
}
