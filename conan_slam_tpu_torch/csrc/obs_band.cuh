// The gated frame's chain up to S in bands of measurement rows: the
// observe, compact Hc, v, the frame-factor coupling hvb and a band's rows
// of psub and S.  H7 (obs_chain.cu, one block a band) and H10 (obs_step.cu,
// its phase 1) run it on staged shared memory; one routine for both.
//
// Port of grid step 0 of conan_slam_tpu/ops/frame_kernel.py:381
// _fullframe_kernel (:402-447): the range-bearing observe against the
// post-factor mean at the gathered rows (_observe_core :266, with atan2f
// and the remainder wrap instead of the Mosaic workarounds), compact Hc,
// v and block-diagonal R (identity on masked rows), then
//
//   hvm  = Hc vrows^T                        (MP, NBP)
//   hvb  = hvm B                             (MP, NBP)
//   psub = Hc prc + hvb vrows                (MP, RP)   = (P' H^T)[rows]
//   S    = psub Hc^T + R                     (MP, MP)
//
// with P' = P + vtf^T B vtf, prc = P[rows][:, rows], vrows = vtf[:, rows].
//
// A band of rows i0 .. i0 + nb - 1 (whole measurements) needs little of
// the frame: the compact Hc of every row (five nonzeros a row: the pose
// columns 0, 1, 2 and the slot's columns 3 + 2l, 4 + 2l of measurement
// l = i / 2; every block reruns the observe, one thread a slot), prc rows
// 0, 1, 2 and its own slot rows 3 + i0 .. (which Hc's rows touch), and
// vrows and B, read where they lie (through L1: inputs of the launch) as
// the caller's accessors give them.  So psub and S spread over many
// blocks, as H2's chain does (chain_band.cuh), and no block holds more
// than a band of the (MP, RP) products: the shared memory of a block grows
// with MP and RP, not with MP x RP.
#pragma once

#include "common.cuh"

// Shared memory of one band block (floats): x[rows], zin, R, compact Hc
// and v as structure of arrays (6, mp), prc rows 0-2 and the band's slot
// rows (3 + band, rpa), hvm and hvb of the band (band, nbp) each, and the
// band's psub (band, rp).
__host__ __device__ __forceinline__ int csl_obs_smem_floats(int mp, int rp, int nbp, int band) {
    const int rpa = (rp + 3) & ~3;
    return rpa + ((3 * (mp / 2) + 3) & ~3) + 4 + 6 * mp + (3 + band) * rpa + 2 * band * nbp +
           band * rp;
}

// The block's pieces of that shared memory, in that order.
struct CslObsSmem {
    float *xr, *zs, *rs, *hc, *prb, *hvm, *hvb, *ps;
    int rpa;
    __device__ __forceinline__ CslObsSmem(float* smem, int mp, int rp, int nbp, int band) {
        rpa = (rp + 3) & ~3;
        xr = smem;
        zs = xr + rpa;
        rs = zs + ((3 * (mp / 2) + 3) & ~3);
        hc = rs + 4;
        prb = hc + 6 * mp;
        hvm = prb + (3 + band) * rpa;
        hvb = hvm + band * nbp;
        ps = hvb + band * nbp;
    }
};

// Every thread of the block: the observe against the mean at the gathered
// rows xr (rp,), one thread a slot, from zs (3, mp / 2) = zin: compact Hc
// rows into hc rows 0-4 and v into hc row 5 (structure of arrays, (6, mp)).
static __device__ __forceinline__ void csl_obs_observe(const float* xr, const float* zs,
                                                       float* hc, int mp, int rp) {
    const int nzl = mp / 2;
    for (int l = threadIdx.x; l < nzl; l += blockDim.x) {
        const float m = zs[2 * nzl + l];
        const int cx = 3 + 2 * l, cy = cx + 1;
        const float fx = cx < rp ? xr[cx] : 0.f;
        const float fy = cy < rp ? xr[cy] : 0.f;
        const float dxl = fx - xr[0], dyl = fy - xr[1];
        const float d2 = fmaxf(dxl * dxl + dyl * dyl, 1e-12f);
        const float dist = sqrtf(d2);
        const float bpred = atan2f(dyl, dxl) - xr[2];
        const float xd = dxl / dist * m, yd = dyl / dist * m;
        const float xd2 = dxl / d2 * m, yd2 = dyl / d2 * m;
        const int i0 = 2 * l, i1 = i0 + 1;
        hc[i0] = -xd;
        hc[mp + i0] = -yd;
        hc[2 * mp + i0] = 0.f;
        hc[3 * mp + i0] = cx < rp ? xd : 0.f;
        hc[4 * mp + i0] = cy < rp ? yd : 0.f;
        hc[5 * mp + i0] = (zs[l] - dist) * m;
        hc[i1] = yd2;
        hc[mp + i1] = -xd2;
        hc[2 * mp + i1] = -m;
        hc[3 * mp + i1] = cx < rp ? -yd2 : 0.f;
        hc[4 * mp + i1] = cy < rp ? xd2 : 0.f;
        hc[5 * mp + i1] = csl_wrap(zs[nzl + l] - bpred) * m;
    }
}

// Every thread of the block: the band of rows i0 .. i0 + nb - 1 (nb even):
// its hvm and hvb (into the block's shared hvm, hvb), its psub (into ps)
// and its rows of s_out (mp, mp), rowc_out (mp, 8) [hc (5), 0, 0, v] and
// hvb_out (mp, nbp) in device memory.  prb (3 + nb, rpa) holds prc rows
// 0, 1, 2 and then the band's slot rows 3 + i0, ...; rs (4,) R's entries;
// vr(b, c) = vrows[b, c] and bm(b, c) = B[b, c].  The observe's hc must be
// complete (a barrier before the call).  Each sum runs in the order of
// H7's one-block form, one thread's chain an output.
template <typename VRow, typename BMat>
static __device__ __forceinline__ void csl_obs_band(const float* prb, int rpa, const float* hc,
                                                    const float* zs, const float* rs,
                                                    float* hvm, float* hvb, float* ps, int i0,
                                                    int nb, int mp, int rp, int nbp, VRow vr,
                                                    BMat bm, float* s_out, float* rowc_out,
                                                    float* hvb_out) {
    const int tid = threadIdx.x, nth = blockDim.x;
    const int nzl = mp / 2;
    for (int e = tid; e < nb * 8; e += nth) {
        const int i = i0 + (e >> 3), k = e & 7;
        rowc_out[(size_t)i * 8 + k] = k < 5 ? hc[k * mp + i] : k == 7 ? hc[5 * mp + i] : 0.f;
    }

    // --- the band's hvm = Hc vrows^T ---
    for (int e = tid; e < nb * nbp; e += nth) {
        const int il = e / nbp, b = e - il * nbp, i = i0 + il;
        const int cx = 3 + 2 * (i / 2), cy = cx + 1;
        float acc = hc[i] * vr(b, 0) + hc[mp + i] * vr(b, 1) + hc[2 * mp + i] * vr(b, 2);
        if (cx < rp) acc += hc[3 * mp + i] * vr(b, cx);
        if (cy < rp) acc += hc[4 * mp + i] * vr(b, cy);
        hvm[e] = acc;
    }
    __syncthreads();

    // --- the band's hvb = hvm B ---
    for (int e = tid; e < nb * nbp; e += nth) {
        const int il = e / nbp, c = e - il * nbp;
        float acc = 0.f;
        for (int b = 0; b < nbp; ++b) acc += hvm[il * nbp + b] * bm(b, c);
        hvb[e] = acc;
        hvb_out[(size_t)(i0 + il) * nbp + c] = acc;
    }
    __syncthreads();

    // --- the band's psub = Hc prc + hvb vrows ---
    const float* p2r = prb + 2 * rpa;
    for (int e = tid; e < nb * rp; e += nth) {
        const int il = e / rp, c = e - il * rp, i = i0 + il;
        const int cx = 3 + 2 * (i / 2), cy = cx + 1;
        const float* sx = prb + (3 + (il & ~1)) * rpa;   // prc rows cx, cy
        float acc = hc[i] * prb[c] + hc[mp + i] * prb[rpa + c] + hc[2 * mp + i] * p2r[c];
        if (cx < rp) acc += hc[3 * mp + i] * sx[c];
        if (cy < rp) acc += hc[4 * mp + i] * sx[rpa + c];
        const float* hb = hvb + il * nbp;
        float cpl = 0.f;
        for (int b = 0; b < nbp; ++b) cpl += hb[b] * vr(b, c);
        ps[il * rp + c] = acc + cpl;
    }
    __syncthreads();

    // --- the band's rows of S = psub Hc^T + R (R block-diagonal, identity
    //     on masked slots) ---
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
