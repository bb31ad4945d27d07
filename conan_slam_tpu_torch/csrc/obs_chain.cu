// H7 obs_chain: the gated frame's measurement chain up to the innovation
// covariance S, in ONE block, from no more of P than its gathered block.
//
// Replaces grid step 0 of the TPU kernel conan_slam_tpu/ops/frame_kernel.py
// :535 frame_update_obs (pallas_call :607, body _fullframe_kernel :402-447):
// the range-bearing observe against the post-factor mean at the gathered
// rows (_observe_core :266, with atan2f and the remainder wrap instead of
// the Mosaic workarounds), compact Hc, v and block-diagonal R (identity on
// masked rows), the frame-factor coupling and S:
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
// What bounds it on the card: latency.  One block on one SM, ~5 M FLOPs
// (psub and S) over ~190 KB of shared memory at MP = 128, RP = 136,
// NBP = 24 (prc 74 KB, psub 70 KB, vrows 13 KB, hvm and hvb 12 KB each);
// its time is the chain of dependent phases.  Hc stays compact, five
// nonzeros a row (the pose columns 0, 1, 2 and the slot's two columns
// 3 + 2l, 4 + 2l of measurement l = i / 2), so Hc products cost 5 FMAs per
// entry instead of RP; psub's coupling term costs NBP more.
//
// Layouts (see conan_slam_tpu_torch/ops/frame_kernel.py): zin (3, NZL) rows
// [range, bearing, mask]; rsc (4,) R entries; xrows (RP,); prc (RP, RP);
// vrows (NBP, RP); bmat (NBP, NBP).  Outputs: s (MP, MP), rowc (MP, 8)
// [hc pose x, pose y, pose phi, slot x, slot y, 0, 0, v], hvb (MP, NBP).
#include "common.cuh"

__global__ void __launch_bounds__(512)
obs_chain_kernel(const float* __restrict__ zin, const float* __restrict__ rsc,
                 const float* __restrict__ xrows_g, const float* __restrict__ prc_g,
                 const float* __restrict__ vrows_g, const float* __restrict__ bmat_g,
                 float* __restrict__ s_out, float* __restrict__ rowc_out,
                 float* __restrict__ hvb_out, int mp, int rp, int nbp) {
    extern __shared__ float smem[];
    float* prc = smem;                  // (rp, rp)
    float* psub = prc + rp * rp;        // (mp, rp)
    float* vrows = psub + mp * rp;      // (nbp, rp)
    float* hvm = vrows + nbp * rp;      // (mp, nbp)
    float* hvb = hvm + mp * nbp;        // (mp, nbp)
    float* bmat = hvb + mp * nbp;       // (nbp, nbp)
    float* rowc = bmat + nbp * nbp;     // (mp, 8)
    float* xrows = rowc + 8 * mp;       // (rp,)

    const int tid = threadIdx.x, nth = blockDim.x;
    const int lane = tid & 31, warp = tid >> 5, nwarp = nth >> 5;
    const int nzl = mp / 2;

    for (int e = tid; e < rp * rp; e += nth) prc[e] = prc_g[e];
    for (int e = tid; e < nbp * rp; e += nth) vrows[e] = vrows_g[e];
    for (int e = tid; e < nbp * nbp; e += nth) bmat[e] = bmat_g[e];
    for (int e = tid; e < rp; e += nth) xrows[e] = xrows_g[e];
    __syncthreads();

    // --- observe: compact Hc rows and the innovation (one thread a slot) ---
    for (int l = tid; l < nzl; l += nth) {
        const float m = zin[2 * nzl + l];
        const int cx = 3 + 2 * l, cy = cx + 1;
        const float fx = cx < rp ? xrows[cx] : 0.f;
        const float fy = cy < rp ? xrows[cy] : 0.f;
        const float dxl = fx - xrows[0], dyl = fy - xrows[1];
        const float d2 = fmaxf(dxl * dxl + dyl * dyl, 1e-12f);
        const float dist = sqrtf(d2);
        const float bpred = atan2f(dyl, dxl) - xrows[2];
        const float xd = dxl / dist * m, yd = dyl / dist * m;
        const float xd2 = dxl / d2 * m, yd2 = dyl / d2 * m;
        float* r0 = rowc + 8 * (2 * l);
        float* r1 = rowc + 8 * (2 * l + 1);
        r0[0] = -xd;  r0[1] = -yd;  r0[2] = 0.f;
        r0[3] = cx < rp ? xd : 0.f;  r0[4] = cy < rp ? yd : 0.f;
        r1[0] = yd2;  r1[1] = -xd2;  r1[2] = -m;
        r1[3] = cx < rp ? -yd2 : 0.f;  r1[4] = cy < rp ? xd2 : 0.f;
        r0[5] = r0[6] = r1[5] = r1[6] = 0.f;
        r0[7] = (zin[l] - dist) * m;
        r1[7] = csl_wrap(zin[nzl + l] - bpred) * m;
    }
    __syncthreads();

    // --- hvm = Hc vrows^T (MP, NBP) ---
    for (int e = tid; e < mp * nbp; e += nth) {
        const int i = e / nbp, b = e % nbp;
        const float* h = rowc + 8 * i;
        const float* vr = vrows + b * rp;
        const int cx = 3 + 2 * (i / 2), cy = cx + 1;
        float acc = h[0] * vr[0] + h[1] * vr[1] + h[2] * vr[2];
        if (cx < rp) acc += h[3] * vr[cx];
        if (cy < rp) acc += h[4] * vr[cy];
        hvm[e] = acc;
    }
    __syncthreads();

    // --- hvb = hvm B (MP, NBP) ---
    for (int e = tid; e < mp * nbp; e += nth) {
        const int i = e / nbp, c = e % nbp;
        float acc = 0.f;
        for (int b = 0; b < nbp; ++b) acc += hvm[i * nbp + b] * bmat[b * nbp + c];
        hvb[e] = acc;
    }
    __syncthreads();

    // --- psub = Hc prc + hvb vrows (MP, RP) ---
    for (int i = warp; i < mp; i += nwarp) {
        const float* h = rowc + 8 * i;
        const float* hb = hvb + i * nbp;
        const int cx = 3 + 2 * (i / 2), cy = cx + 1;
        for (int c = lane; c < rp; c += 32) {
            float acc = h[0] * prc[c] + h[1] * prc[rp + c] + h[2] * prc[2 * rp + c];
            if (cx < rp) acc += h[3] * prc[cx * rp + c];
            if (cy < rp) acc += h[4] * prc[cy * rp + c];
            float cpl = 0.f;
            for (int b = 0; b < nbp; ++b) cpl += hb[b] * vrows[b * rp + c];
            psub[i * rp + c] = acc + cpl;
        }
    }
    __syncthreads();

    // --- S = psub Hc^T + R (R block-diagonal, identity on masked slots) ---
    for (int i = warp; i < mp; i += nwarp) {
        const float* ps = psub + i * rp;
        for (int j = lane; j < mp; j += 32) {
            const float* h = rowc + 8 * j;
            const int cx = 3 + 2 * (j / 2), cy = cx + 1;
            float acc = ps[0] * h[0] + ps[1] * h[1] + ps[2] * h[2];
            if (cx < rp) acc += ps[cx] * h[3];
            if (cy < rp) acc += ps[cy] * h[4];
            if (i / 2 == j / 2) {
                const bool valid = zin[2 * nzl + i / 2] > 0.f;
                const int ri = i & 1, rj = j & 1;
                acc += valid ? rsc[2 * ri + rj] : (ri == rj ? 1.f : 0.f);
            }
            s_out[i * mp + j] = acc;
        }
    }
    for (int e = tid; e < mp * 8; e += nth) rowc_out[e] = rowc[e];
    for (int e = tid; e < mp * nbp; e += nth) hvb_out[e] = hvb[e];
}

extern "C" int csl_obs_chain(const float* zin, const float* rsc, const float* xrows,
                             const float* prc, const float* vrows, const float* bmat, float* s,
                             float* rowc, float* hvb, int mp, int rp, int nbp, void* stream) {
    const size_t smem =
        (size_t)(rp * rp + mp * rp + nbp * rp + 2 * mp * nbp + nbp * nbp + 8 * mp + rp) *
        sizeof(float);
    if (mp <= 0 || mp % 2 || rp < 3 || nbp <= 0 || smem > CSL_MAX_SMEM)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = csl_allow_smem(obs_chain_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    obs_chain_kernel<<<1, 512, smem, (cudaStream_t)stream>>>(zin, rsc, xrows, prc, vrows, bmat,
                                                             s, rowc, hvb, mp, rp, nbp);
    return (int)cudaGetLastError();
}
