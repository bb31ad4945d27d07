// H3 frame_panels: the gains siv = v^T S^-1, pht = Hc P'[rows] (MP, D) and
// the updated mean xn (D,), one column panel of D per block; block 0 also
// writes the NIS v^T S^-1 v.
//
// Replaces the per-step body of the TPU kernel conan_slam_tpu/ops/
// frame_kernel.py:1123 _chain_dispatch (pallas_call :1139, body
// _bigchain_kernel :1060-1104), which produced one (MP, tc) panel per grid
// step from the state grid step 0 left in scratch.  Here that state comes
// from device memory (rowc and ms from H2, S^-1 from H1), so the panels are
// independent blocks and run in parallel.  Each block forms siv itself
// (an MP x MP matvec, 16k FMAs, from L2) rather than wait on another
// launch.
//
//   pht[i, n] = sum_{a in nz(i)} Hc[i, a] prows[a, n] + hp2_i wrow[n]
//               + hg_i p2[n] + sum_{r<3} Hc[i, r] m3[r, n]   (n < 3 only)
//   xn[n]     = base[n] + sum_i siv_i pht[i, n],  heading (n = 2) wrapped
//
// with wrow = alpha p2 + g (first 3 lanes), base = pose (n < 3) or
// x + corr0 p2, and nz(i) the five nonzero columns of compact Hc row i.
//
// What bounds it on the card: bytes.  It reads the (RP, D) gathered rows
// (1.25 MB at RP=136, D=2304) and writes the (MP, D) pht (1.18 MB) with
// ~10 FLOPs per output, far below the FLOP/byte ridge; each block's siv
// adds 64 KB of S^-1 read from L2.  The design gives
// each thread one column and walks the rows, so every row read and every
// pht write is a coalesced 128-byte line per warp; Hc stays compact (five
// coefficients a row, in shared memory), and the xn reduction over rows
// happens in shared memory, so pht is never read back.  Columns past D
// are masked: any D works.
#include "common.cuh"

#define PANEL_W 32
#define PANEL_H 8

__global__ void __launch_bounds__(PANEL_W * PANEL_H)
frame_panels_kernel(const float* __restrict__ rowc_g, const float* __restrict__ ms_g,
                    const float* __restrict__ si, const float* __restrict__ prows,
                    const float* __restrict__ x, float* __restrict__ pht,
                    float* __restrict__ xn, float* __restrict__ nis, int mp, int rp, int d) {
    extern __shared__ float smem[];
    float* rowc = smem;                      // (mp, 8): col 7 = v
    float* ms = rowc + 8 * mp;               // (32,)
    float* part = ms + 32;                   // (PANEL_H, PANEL_W)
    float* siv = part + PANEL_H * PANEL_W;   // (mp,)
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int tid = ty * PANEL_W + tx;
    const int nth = PANEL_W * PANEL_H;
    for (int e = tid; e < 8 * mp; e += nth) rowc[e] = rowc_g[e];
    if (tid < 32) ms[tid] = ms_g[tid];
    __syncthreads();
    for (int j = tid; j < mp; j += nth) {
        float acc = 0.f;
        for (int i = 0; i < mp; ++i) acc += rowc[8 * i + 7] * si[(size_t)i * mp + j];
        siv[j] = acc;
    }
    __syncthreads();
    if (blockIdx.x == 0 && ty == 0) {
        float s = 0.f;
        for (int j = tx; j < mp; j += PANEL_W) s += siv[j] * rowc[8 * j + 7];
        for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
        if (tx == 0) nis[0] = s;
    }

    const int n = blockIdx.x * PANEL_W + tx;
    const bool live = n < d;
    const int nc = live ? n : 0;             // a safe column for masked lanes
    const float p0 = prows[nc], p1 = prows[d + nc], p2 = prows[2 * d + nc];
    const float wrow = ms[4] * p2 + (n < 3 ? ms[5 + n] : 0.f);
    float m3n[3] = {0.f, 0.f, 0.f};
    if (n < 3)
        for (int r = 0; r < 3; ++r) m3n[r] = ms[8 + 3 * r + n];

    float xsum = 0.f;
    for (int i = ty; i < mp; i += PANEL_H) {
        const float* h = rowc + 8 * i;
        const int cx = 3 + 2 * (i / 2), cy = cx + 1;
        float acc = h[0] * p0 + h[1] * p1 + h[2] * p2;
        if (cx < rp) acc += h[3] * prows[(size_t)cx * d + nc];
        if (cy < rp) acc += h[4] * prows[(size_t)cy * d + nc];
        acc += h[5] * wrow + h[6] * p2;
        acc += h[0] * m3n[0] + h[1] * m3n[1] + h[2] * m3n[2];
        if (live) pht[(size_t)i * d + n] = acc;
        xsum += siv[i] * acc;
    }
    part[ty * PANEL_W + tx] = xsum;
    __syncthreads();
    if (ty == 0 && live) {
        float s = 0.f;
        for (int r = 0; r < PANEL_H; ++r) s += part[r * PANEL_W + tx];
        const float base = n < 3 ? ms[n] : x[n] + p2 * ms[3];
        const float v = base + s;
        xn[n] = n == 2 ? csl_wrap(v) : v;
    }
}

extern "C" int csl_frame_panels(const float* rowc, const float* ms, const float* si,
                                const float* prows, const float* x, float* pht, float* xn,
                                float* nis, int mp, int rp, int d, void* stream) {
    const size_t smem = (size_t)(9 * mp + 32 + PANEL_W * PANEL_H) * sizeof(float);
    if (mp <= 0 || mp % 2 || rp < 3 || d < 3 || smem > CSL_MAX_SMEM)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = csl_allow_smem(frame_panels_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 block(PANEL_W, PANEL_H);
    const dim3 grid((d + PANEL_W - 1) / PANEL_W);
    frame_panels_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(rowc, ms, si, prows, x,
                                                                      pht, xn, nis, mp, rp, d);
    return (int)cudaGetLastError();
}
