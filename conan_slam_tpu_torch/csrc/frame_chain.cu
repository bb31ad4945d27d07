// H2 frame_chain: the part of a known-association frame that needs no more
// of P than its gathered (RP, RP) block, in ONE block, up to the innovation
// covariance S.
//
// Replaces grid step 0 of the TPU kernel conan_slam_tpu/ops/frame_kernel.py
// :1123 _chain_dispatch (pallas_call :1139, body _bigchain_kernel :937-1040):
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
// What bounds it on the card: latency.  It is one block on one SM; its
// work (~5 M FLOPs for psub and S, ~75 KB of prc, 64 KB of S written) is
// small, and its time is the chain of dependent phases, the first of them
// the serial coefficient recursion on one thread.  The design keeps psub
// in shared memory (70 KB at MP=128, RP=136) and Hc compact, five nonzeros
// a row, so psub and S cost 5 FMAs per entry instead of RP.
//
// Layouts (see conan_slam_tpu_torch/ops/frame_kernel.py): subs (4, S) rows
// [vn, swan, phi_meas, active]; qc (3,) chol(Q) [l00, l10, l11]; zin
// (3, NZL) rows [range, bearing, mask]; rsc (4,) R entries; x0rows (RP,);
// prc (RP, RP).  Outputs: pt (S, 3), k4 (8, 8), s (MP, MP), rowc (MP, 8)
// [hc pose x, pose y, pose phi, slot x, slot y, hp2, hg, v], ms (32,)
// [pose (3), corr0, alpha, g (3), m3 (9), 0...].
#include "coeff.cuh"

// K4 = C B C^T from the recursion's coefficient columns:
// p22 m m^T + m e^T + e m^T + sum f f^T + r_head sum w w^T, summed sub-step
// by sub-step.
static __device__ void coeff_k4(const float* cols, int S, float p22, float r_head,
                                bool use_heading, float k4[4][4]) {
    const float* m = cols;
    const float ep2[4] = {1.f, 0.f, 0.f, 0.f};
    for (int r = 0; r < 4; ++r)
        for (int c = 0; c < 4; ++c)
            k4[r][c] = p22 * m[r] * m[c] + m[r] * ep2[c] + ep2[r] * m[c];
    for (int k = 0; k < S; ++k) {
        for (int col = 0; col < 2; ++col) {
            const float* f = cols + 4 * (2 + 2 * k + col);
            for (int r = 0; r < 4; ++r)
                for (int c = 0; c < 4; ++c) k4[r][c] += f[r] * f[c];
        }
        if (use_heading) {
            const float* wp = cols + 4 * (2 + 2 * S + k);
            for (int r = 0; r < 4; ++r)
                for (int c = 0; c < 4; ++c) k4[r][c] += r_head * wp[r] * wp[c];
        }
    }
}


__global__ void __launch_bounds__(512)
frame_chain_kernel(const float* __restrict__ subs, const float* __restrict__ qc,
                   const float* __restrict__ zin, const float* __restrict__ rsc,
                   const float* __restrict__ x0rows, const float* __restrict__ prc,
                   float* __restrict__ pt_out, float* __restrict__ k4_out,
                   float* __restrict__ s_out, float* __restrict__ rowc_out,
                   float* __restrict__ ms_out, int S, int mp, int rp, float wheel_base,
                   float dt, float sigma_heading, int use_heading) {
    extern __shared__ float smem[];
    __shared__ float cols[4 * CSL_MAX_COLS];
    float* psub = smem;                 // (mp, rp)
    float* rowc = psub + mp * rp;       // (mp, 8)
    float* xrows = rowc + mp * 8;       // (rp,)
    float* p2r = xrows + rp;            // (rp,)
    float* ms = p2r + rp;               // (32,) frame scalars, as ms_out

    const int tid = threadIdx.x, nth = blockDim.x;
    const int lane = tid & 31, warp = tid >> 5, nwarp = nth >> 5;
    const int nzl = mp / 2;

    for (int c = tid; c < rp; c += nth) p2r[c] = prc[2 * rp + c];
    __syncthreads();

    // --- coefficient recursion and K4 (one thread) ---
    if (tid == 0) {
        float pose[3] = {x0rows[0], x0rows[1], x0rows[2]};
        const float r_head = sigma_heading * sigma_heading;
        float corr0, k4[4][4];
        csl_coeff_recursion(subs, S, qc, p2r, pose, wheel_base, dt, r_head, use_heading != 0,
                            pt_out, &corr0, cols);
        coeff_k4(cols, S, p2r[2], r_head, use_heading != 0, k4);
        for (int e = 0; e < 64; ++e) k4_out[e] = 0.f;
        for (int r = 0; r < 4; ++r)
            for (int c = 0; c < 4; ++c) k4_out[8 * r + c] = k4[r][c];
        for (int e = 0; e < 32; ++e) ms[e] = 0.f;
        ms[0] = pose[0];
        ms[1] = pose[1];
        ms[2] = pose[2];
        ms[3] = corr0;
        ms[4] = k4[0][0];
        for (int r = 0; r < 3; ++r) {
            ms[5 + r] = k4[r + 1][0];
            for (int c = 0; c < 3; ++c) ms[8 + 3 * r + c] = k4[r + 1][c + 1];
        }
    }
    __syncthreads();
    const float corr0 = ms[3], alpha = ms[4];
    const float g[3] = {ms[5], ms[6], ms[7]};

    // --- the post-frame mean at the gathered rows ---
    for (int c = tid; c < rp; c += nth)
        xrows[c] = c < 3 ? ms[c] : x0rows[c] + p2r[c] * corr0;
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
        r0[7] = (zin[l] - dist) * m;
        r1[7] = csl_wrap(zin[nzl + l] - bpred) * m;
    }
    __syncthreads();

    // --- hp2 = Hc p2[rows], hg = Hc[:, :3] g ---
    for (int i = tid; i < mp; i += nth) {
        const float* h = rowc + 8 * i;
        const int cx = 3 + 2 * (i / 2), cy = cx + 1;
        float hp2 = h[0] * p2r[0] + h[1] * p2r[1] + h[2] * p2r[2];
        if (cx < rp) hp2 += h[3] * p2r[cx];
        if (cy < rp) hp2 += h[4] * p2r[cy];
        rowc[8 * i + 5] = hp2;
        rowc[8 * i + 6] = h[0] * g[0] + h[1] * g[1] + h[2] * g[2];
    }
    __syncthreads();

    // --- psub = Hc P'[rows][:, rows], P' = P + U K4 U^T in factored form ---
    for (int i = warp; i < mp; i += nwarp) {
        const float* h = rowc + 8 * i;
        const int cx = 3 + 2 * (i / 2), cy = cx + 1;
        for (int c = lane; c < rp; c += 32) {
            float acc = h[0] * prc[c] + h[1] * prc[rp + c] + h[2] * prc[2 * rp + c];
            if (cx < rp) acc += h[3] * prc[cx * rp + c];
            if (cy < rp) acc += h[4] * prc[cy * rp + c];
            const float wr = alpha * p2r[c] + (c < 3 ? g[c] : 0.f);
            acc += h[5] * wr + h[6] * p2r[c];
            if (c < 3) acc += h[0] * ms[8 + c] + h[1] * ms[11 + c] + h[2] * ms[14 + c];
            psub[i * rp + c] = acc;
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
    for (int e = tid; e < 32; e += nth) ms_out[e] = ms[e];
}

extern "C" int csl_frame_chain(const float* subs, const float* qc, const float* zin,
                               const float* rsc, const float* x0rows, const float* prc,
                               float* pt, float* k4, float* s, float* rowc, float* ms, int S,
                               int mp, int rp, float wheel_base, float dt,
                               float sigma_heading, int use_heading, void* stream) {
    const size_t smem = (size_t)(mp * rp + 8 * mp + 2 * rp + 32) * sizeof(float);
    if (S <= 0 || S > CSL_MAX_STEPS || mp <= 0 || mp % 2 || rp < 3 || smem > CSL_MAX_SMEM)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = csl_allow_smem(frame_chain_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    frame_chain_kernel<<<1, 512, smem, (cudaStream_t)stream>>>(
        subs, qc, zin, rsc, x0rows, prc, pt, k4, s, rowc, ms, S, mp, rp, wheel_base, dt,
        sigma_heading, use_heading);
    return (int)cudaGetLastError();
}
