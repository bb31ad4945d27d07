// One column of the frame's pht = Hc P'[rows] (MP, D): the column panel of
// H3 (frame_panels.cu), shared with H9 (frame_step.cu); one routine for
// both.
//
//   pht[i, n] = sum_{a in nz(i)} Hc[i, a] prows[a, n] + hp2_i wrow[n]
//               + hg_i p2[n] + sum_{r<3} Hc[i, r] m3[r, n]   (n < 3 only)
//
// with wrow = alpha p2 + g (first 3 lanes) and nz(i) the five nonzero
// columns of compact Hc row i; rowc and ms as in frame_chain.cu.
#pragma once

#include "common.cuh"

// The column's constants: wrow[n] and m3[:, n] (zero past column 2), from
// the frame scalars ms and the column's p2[n].
struct CslPanelColumn {
    float p0, p1, p2;   // prows[0..2, n]
    float wrow;
    float m3n[3];
};

__device__ __forceinline__ CslPanelColumn csl_panel_column(const float* ms, float p0, float p1,
                                                          float p2, int n) {
    CslPanelColumn col;
    col.p0 = p0;
    col.p1 = p1;
    col.p2 = p2;
    col.wrow = ms[4] * p2 + (n < 3 ? ms[5 + n] : 0.f);
    col.m3n[0] = col.m3n[1] = col.m3n[2] = 0.f;
    if (n < 3)
        for (int r = 0; r < 3; ++r) col.m3n[r] = ms[8 + 3 * r + n];
    return col;
}

// pht[i, n] for row i of measurement l = i / 2, from rowc row i (8 floats,
// 16-byte aligned) and the slot rows sx = prows[3 + 2 l, n],
// sy = prows[4 + 2 l, n] (used only when inside the gathered rows: hx, hy).
__device__ __forceinline__ float csl_pht_entry(const float* rc_i, const CslPanelColumn& col,
                                               float sx, float sy, bool hx, bool hy) {
    const float4 ha = *reinterpret_cast<const float4*>(rc_i);
    const float4 hb = *reinterpret_cast<const float4*>(rc_i + 4);
    float acc = ha.x * col.p0 + ha.y * col.p1 + ha.z * col.p2;
    if (hx) acc += ha.w * sx;
    if (hy) acc += hb.x * sy;
    acc += hb.y * col.wrow + hb.z * col.p2;
    acc += ha.x * col.m3n[0] + ha.y * col.m3n[1] + ha.z * col.m3n[2];
    return acc;
}

// Stage a panel of the gathered rows: pan[r * ld + c] = row(r)[c0 + c] for
// r < rp, c < w (w % 4 == 0), zero past column d, by the block's threads
// with cp.async (16-byte copies when vec: d % 4 == 0 and 16-byte aligned
// rows).  row(r) is the address of gathered row r's first element; the rows
// are inputs of the launch (the copies may go through L1).  The caller
// commits and waits before a barrier.
template <typename RowPtr>
__device__ __forceinline__ void csl_stage_panel(float* pan, RowPtr row, int rp, int w, int ld,
                                                int c0, int d, bool vec) {
    const int tid = threadIdx.x, nth = blockDim.x;
    if (vec) {
        for (int e = tid; e < rp * (w / 4); e += nth) {
            const int r = e / (w / 4), c = 4 * (e % (w / 4));
            const bool in = c0 + c < d;    // D % 4 == 0: four columns are all in or all out
            const float* src = row(r);
            csl_cp_async16(pan + r * ld + c, in ? src + c0 + c : src, in);
        }
    } else {
        for (int e = tid; e < rp * w; e += nth) {
            const int r = e / w, c = e % w;
            const bool in = c0 + c < d;
            const float* src = row(r);
            csl_cp_async4(pan + r * ld + c, in ? src + c0 + c : src, in);
        }
    }
}
