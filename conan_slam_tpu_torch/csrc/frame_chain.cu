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
//   - The recursion runs on one warp with a lane per sub-step holding its
//     terms in registers (coeff.cuh): no local memory.  K4's 16 entries
//     are formed on 16 lanes.
//   - Compact Hc, hp2, hg and v are kept as structure of arrays in shared
//     memory, so the S phase reads consecutive words (no bank conflicts).
//   - Exactly one block (0) writes pt, k4 and ms; each band writes its rows
//     of S and rowc.  No atomics: every output is one thread's fixed chain.
//
// Layouts (see conan_slam_tpu_torch/ops/frame_kernel.py): subs (4, S) rows
// [vn, swan, phi_meas, active]; qc (3,) chol(Q) [l00, l10, l11]; zin
// (3, NZL) rows [range, bearing, mask]; rsc (4,) R entries; x0rows (RP,);
// prc (RP, RP).  Outputs: pt (S, 3), k4 (8, 8), s (MP, MP), rowc (MP, 8)
// [hc pose x, pose y, pose phi, slot x, slot y, hp2, hg, v], ms (32,)
// [pose (3), corr0, alpha, g (3), m3 (9), 0...].
#include "coeff.cuh"

#define FC_THREADS 256

// K4 = C B C^T entry (r, c) from the recursion's coefficient columns:
// p22 m m^T + m e^T + e m^T + sum f f^T + r_head sum w w^T, summed sub-step
// by sub-step.
static __device__ __forceinline__ float coeff_k4_entry(const float* cols, int S, float p22,
                                                       float r_head, bool use_heading, int r,
                                                       int c) {
    const float er = r == 0 ? 1.f : 0.f, ec = c == 0 ? 1.f : 0.f;
    float k = p22 * cols[r] * cols[c] + cols[r] * ec + er * cols[c];
    for (int s = 0; s < S; ++s) {
        const float* f = cols + 4 * (2 + 2 * s);
        k += f[r] * f[c];
        k += f[4 + r] * f[4 + c];
        if (use_heading) {
            const float* wp = cols + 4 * (2 + 2 * S + s);
            k += r_head * wp[r] * wp[c];
        }
    }
    return k;
}

__global__ void __launch_bounds__(FC_THREADS)
frame_chain_kernel(const float* __restrict__ subs, const float* __restrict__ qc,
                   const float* __restrict__ zin, const float* __restrict__ rsc,
                   const float* __restrict__ x0rows, const float* __restrict__ prc,
                   float* __restrict__ pt_out, float* __restrict__ k4_out,
                   float* __restrict__ s_out, float* __restrict__ rowc_out,
                   float* __restrict__ ms_out, int S, int mp, int rp, int band,
                   float wheel_base, float dt, float sigma_heading, int use_heading) {
    extern __shared__ __align__(16) float smem[];
    __shared__ float cols[4 * CSL_MAX_COLS];
    __shared__ float ms[32];                      // frame scalars, as ms_out
    const int tid = threadIdx.x, nth = blockDim.x;
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

    // --- the band's inputs into shared memory, in flight during the recursion ---
    for (int r = 0; r < 3 + sr; ++r)
        csl_stage(prb + r * rpa, prc + (size_t)(r < 3 ? r : i0 + r) * rp, rp);
    csl_stage(xr, x0rows, rp);
    csl_stage(zs, zin, 3 * nzl);
    csl_stage(rs, rsc, 4);

    // --- coefficient recursion (warp 0) and K4 (16 lanes) ---
    const bool heading = use_heading != 0;
    const float r_head = sigma_heading * sigma_heading;
    if (tid < 32) {
        const float p2h[3] = {prc[2 * rp], prc[2 * rp + 1], prc[2 * rp + 2]};
        float pose[3] = {x0rows[0], x0rows[1], x0rows[2]};
        float corr0;
        csl_coeff_recursion(subs, S, qc, p2h, pose, wheel_base, dt, r_head, heading,
                            blockIdx.x == 0 ? pt_out : nullptr, &corr0, cols);
        const int r = (tid >> 2) & 3, c = tid & 3;
        const float k4 = coeff_k4_entry(cols, S, p2h[2], r_head, heading, r, c);
        if (tid < 16) {
            if (c == 0) ms[4 + r] = k4;                   // alpha, g
            if (r > 0 && c > 0) ms[4 + 3 * r + c] = k4;   // m3
        } else if (tid > 16) {
            ms[tid] = 0.f;
        }
        if (tid == 0) {
            ms[0] = pose[0];
            ms[1] = pose[1];
            ms[2] = pose[2];
            ms[3] = corr0;
        }
        if (blockIdx.x == 0) {
            if (tid < 16) k4_out[8 * r + c] = k4;
            for (int e = tid; e < 64; e += 32)
                if ((e >> 3) >= 4 || (e & 7) >= 4) k4_out[e] = 0.f;
        }
    }
    csl_cp_async_commit();
    csl_cp_async_wait<0>();
    __syncthreads();
    if (blockIdx.x == 0 && tid < 32) ms_out[tid] = ms[tid];
    const float px = ms[0], py = ms[1], phi = ms[2], corr0 = ms[3], alpha = ms[4];
    const float g0 = ms[5], g1 = ms[6], g2 = ms[7];
    const float* p2r = prb + 2 * rpa;

    // --- observe against the post-frame mean at the gathered rows: compact
    //     Hc, hp2 = Hc p2[rows], hg = Hc[:, :3] g and v, one thread a slot ---
    for (int l = tid; l < nzl; l += nth) {
        const float m = zs[2 * nzl + l];
        const int cx = 3 + 2 * l, cy = cx + 1;
        const float fx = cx < rp ? xr[cx] + p2r[cx] * corr0 : 0.f;
        const float fy = cy < rp ? xr[cy] + p2r[cy] * corr0 : 0.f;
        const float dxl = fx - px, dyl = fy - py;
        const float d2 = fmaxf(dxl * dxl + dyl * dyl, 1e-12f);
        const float dist = sqrtf(d2);
        const float bpred = atan2f(dyl, dxl) - phi;
        const float xd = dxl / dist * m, yd = dyl / dist * m;
        const float xd2 = dxl / d2 * m, yd2 = dyl / d2 * m;
        const float h[2][5] = {{-xd, -yd, 0.f, cx < rp ? xd : 0.f, cy < rp ? yd : 0.f},
                               {yd2, -xd2, -m, cx < rp ? -yd2 : 0.f, cy < rp ? xd2 : 0.f}};
        float hp2[2], hg[2];
        for (int q = 0; q < 2; ++q) {
            hp2[q] = h[q][0] * p2r[0] + h[q][1] * p2r[1] + h[q][2] * p2r[2];
            if (cx < rp) hp2[q] += h[q][3] * p2r[cx];
            if (cy < rp) hp2[q] += h[q][4] * p2r[cy];
            hg[q] = h[q][0] * g0 + h[q][1] * g1 + h[q][2] * g2;
        }
        float2* hc2 = reinterpret_cast<float2*>(hc) + l;
        const int step = mp / 2;                  // one SoA row, in float2
        for (int k = 0; k < 5; ++k) hc2[k * step] = make_float2(h[0][k], h[1][k]);
        hc2[5 * step] = make_float2(hp2[0], hp2[1]);
        hc2[6 * step] = make_float2(hg[0], hg[1]);
        hc2[7 * step] = make_float2((zs[l] - dist) * m, csl_wrap(zs[nzl + l] - bpred) * m);
    }
    __syncthreads();
    for (int e = tid; e < nb * 8; e += nth)
        rowc_out[(size_t)(i0 + (e >> 3)) * 8 + (e & 7)] = hc[(e & 7) * mp + i0 + (e >> 3)];

    // --- the band's psub = Hc P'[rows][:, rows], P' = P + U K4 U^T factored ---
    for (int e = tid; e < nb * rp; e += nth) {
        const int il = e / rp, c = e - il * rp, i = i0 + il;
        const int cx = 3 + 2 * (i / 2), cy = cx + 1;
        const float* sx = prb + (3 + (il & ~1)) * rpa;   // prc rows cx, cy
        const float h0 = hc[i], h1 = hc[mp + i], h2 = hc[2 * mp + i];
        float acc = h0 * prb[c] + h1 * prb[rpa + c] + h2 * p2r[c];
        if (cx < rp) acc += hc[3 * mp + i] * sx[c];
        if (cy < rp) acc += hc[4 * mp + i] * sx[rpa + c];
        const float wr = alpha * p2r[c] + (c == 0 ? g0 : c == 1 ? g1 : c == 2 ? g2 : 0.f);
        acc += hc[5 * mp + i] * wr + hc[6 * mp + i] * p2r[c];
        if (c < 3) acc += h0 * ms[8 + c] + h1 * ms[11 + c] + h2 * ms[14 + c];
        ps[il * rp + c] = acc;
    }
    __syncthreads();

    // --- the band's rows of S = psub Hc^T + R (R block-diagonal, identity on
    //     masked slots) ---
    for (int e = tid; e < nb * mp; e += nth) {
        const int il = e / mp, j = e - il * mp, i = i0 + il;
        const float* p = ps + il * rp;
        const int cx = 3 + 2 * (j / 2), cy = cx + 1;
        float acc = p[0] * hc[j] + p[1] * hc[mp + j] + p[2] * hc[2 * mp + j];
        if (cx < rp) acc += p[cx] * hc[3 * mp + j];
        if (cy < rp) acc += p[cy] * hc[4 * mp + j];
        if (i / 2 == j / 2) {
            const bool valid = zs[2 * nzl + i / 2] > 0.f;
            const int ri = i & 1, rj = j & 1;
            acc += valid ? rs[2 * ri + rj] : (ri == rj ? 1.f : 0.f);
        }
        s_out[(size_t)i * mp + j] = acc;
    }
}

// Shared memory of one block: prc rows, x0rows, zin, R, rowc, psub.
static size_t frame_chain_smem(int mp, int rp, int band) {
    const int rpa = (rp + 3) & ~3;
    return (size_t)((4 + band) * rpa + ((3 * (mp / 2) + 3) & ~3) + 4 + 8 * mp + band * rp) *
           sizeof(float);
}

extern "C" int csl_frame_chain(const float* subs, const float* qc, const float* zin,
                               const float* rsc, const float* x0rows, const float* prc,
                               float* pt, float* k4, float* s, float* rowc, float* ms, int S,
                               int mp, int rp, int band, float wheel_base, float dt,
                               float sigma_heading, int use_heading, void* stream) {
    if (S <= 0 || S > CSL_MAX_STEPS || mp <= 0 || mp % 2 || rp < 3 || band <= 0 || band % 2)
        return (int)cudaErrorInvalidValue;
    const size_t smem = frame_chain_smem(mp, rp, band);
    if (smem > CSL_MAX_SMEM) return (int)cudaErrorInvalidValue;
    cudaError_t err = csl_allow_smem(frame_chain_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((mp + band - 1) / band);
    frame_chain_kernel<<<grid, FC_THREADS, smem, (cudaStream_t)stream>>>(
        subs, qc, zin, rsc, x0rows, prc, pt, k4, s, rowc, ms, S, mp, rp, band, wheel_base, dt,
        sigma_heading, use_heading);
    return (int)cudaGetLastError();
}
