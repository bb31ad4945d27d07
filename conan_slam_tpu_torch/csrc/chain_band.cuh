// The phases of a known-association frame up to S that need no more of P
// than its gathered block: the recursion and K4, the observe, and a band of
// psub and S rows.  H2 (frame_chain.cu) and H9 (frame_step.cu) run them on
// staged shared memory; one routine for both.  See frame_chain.cu for the
// layouts and the design.
#pragma once

#include "coeff.cuh"

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

// Warp 0 (all 32 lanes): the coefficient recursion from the frame-start
// pose pose0 (3,) and p2h = (P e2)[0:3], then K4.  Writes the frame scalars
// ms (32,) [pose, corr0, alpha, g (3), m3 (9), 0...] to shared memory, and
// where non-null the pose trace pt_out (S, 3) and k4_out (8, 8) (K4 in the
// leading 4 x 4, zero elsewhere) to device memory.  coeff is the
// recursion's shared memory, csl_coeff_smem_floats(S) floats (its
// coefficient columns first).
static __device__ __forceinline__ void csl_chain_scalars(
    const float* subs, int S, const float* qc, const float* p2h, const float* pose0,
    float wheel_base, float dt, float r_head, bool heading, float* pt_out, float* k4_out,
    float* ms, float* coeff) {
    const float* cols = coeff;
    const int tid = threadIdx.x;
    const float p2[3] = {p2h[0], p2h[1], p2h[2]};
    float pose[3] = {pose0[0], pose0[1], pose0[2]};
    float corr0;
    csl_coeff_recursion(subs, S, qc, p2, pose, wheel_base, dt, r_head, heading, pt_out, &corr0,
                        coeff);
    const int r = (tid >> 2) & 3, c = tid & 3;
    const float k4 = coeff_k4_entry(cols, S, p2[2], r_head, heading, r, c);
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
    if (k4_out) {
        if (tid < 16) k4_out[8 * r + c] = k4;
        for (int e = tid; e < 64; e += 32)
            if ((e >> 3) >= 4 || (e & 7) >= 4) k4_out[e] = 0.f;
    }
}

// Every thread of the block: the observe against the post-frame mean at the
// gathered rows, one thread a slot: compact Hc, hp2 = Hc p2[rows],
// hg = Hc[:, :3] g and v into hc (8, mp) as structure of arrays.  xr (rp,)
// is x0rows, p2r (rp,) prc row 2, zs (3, mp / 2) zin, ms the frame scalars.
static __device__ __forceinline__ void csl_chain_observe(const float* ms, const float* xr,
                                                         const float* p2r, const float* zs,
                                                         float* hc, int mp, int rp) {
    const int tid = threadIdx.x, nth = blockDim.x;
    const int nzl = mp / 2;
    const float px = ms[0], py = ms[1], phi = ms[2], corr0 = ms[3];
    const float g0 = ms[5], g1 = ms[6], g2 = ms[7];
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
}

// Every thread of the block: the band of rows i0 .. i0 + nb - 1 (nb even,
// whole measurements): its rows of rowc_out (mp, 8), psub = Hc P'[rows][:,
// rows] with P' = P + U K4 U^T factored (into ps, (nb, rp) shared), and its
// rows of s_out = psub Hc^T + R (mp, mp).  prb (3 + nb, rpa) holds prc rows
// 0, 1, 2 and then the band's slot rows 3 + i0, ...; rs (4,) R's entries.
// The observe's hc must be complete (a barrier before the call).
static __device__ __forceinline__ void csl_chain_band(const float* prb, int rpa, const float* hc,
                                                      const float* ms, const float* zs,
                                                      const float* rs, float* ps, int i0, int nb,
                                                      int mp, int rp, float* s_out,
                                                      float* rowc_out) {
    const int tid = threadIdx.x, nth = blockDim.x;
    const int nzl = mp / 2;
    const float alpha = ms[4], g0 = ms[5], g1 = ms[6], g2 = ms[7];
    const float* p2r = prb + 2 * rpa;
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

// Shared memory of one chain block (floats): prc rows 0-2 and a band of
// slot rows, x0rows, zin, R, rowc as structure of arrays, psub; the
// recursion's (csl_coeff_smem_floats) follows it.
__host__ __device__ __forceinline__ int csl_chain_smem_floats(int mp, int rp, int band) {
    const int rpa = (rp + 3) & ~3;
    return (4 + band) * rpa + ((3 * (mp / 2) + 3) & ~3) + 4 + 8 * mp + band * rp;
}
