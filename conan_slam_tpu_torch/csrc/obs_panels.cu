// H8 obs_panels: the gated frame's row strips pht = P' H^T (MP, D), the
// gains siv = v^T S^-1, the updated mean xn (D,) and the NIS, one column
// panel of D per block: the gated frame's split route (its default route
// is H10, obs_step.cu).
//
// Replaces the panel work of the TPU kernel conan_slam_tpu/ops/
// frame_kernel.py:535 frame_update_obs (pallas_call :607, body
// _fullframe_kernel :422-467), which formed the whole (MP, D) pht and the
// mean in grid step 0 and kept pht in VMEM for the row panels of the P
// pass.  Here the P pass is H4 (rank_update.cu) and reads pht from device
// memory, so this kernel writes it:
//
//   pht[i, n] = sum_{a in nz(i)} Hc[i, a] prows[a, n] + sum_b hvb[i, b] vtf[b, n]
//   xn[n]     = x[n] + sum_i siv_i pht[i, n],  heading (n = 2) wrapped
//
// with x the post-factor mean, nz(i) the five nonzero columns of compact Hc
// row i, and rowc, hvb from H7 and S^-1 from H1.  Each block forms siv
// itself (an MP x MP matvec from L2) rather than wait on another launch.
//
// What bounds it on the card: bytes.  It reads the (RP, D) gathered rows
// and the (NBP, D) factor strip and writes the (MP, D) pht, 1.2 MB at
// D = 1024 (26 MB at D = 20,224), with 5 + NBP FMAs per output.  The
// design gives each thread one column and walks the rows, so every row
// read and every pht write is a coalesced line per warp; the block's
// (NBP, 32) panel of vtf sits in shared memory, and a warp (one row i)
// reads hvb[i, b] as a broadcast through L1, so the block's shared memory
// does not grow with MP x NBP (it holds MP 2048 at NBP 776, S = 256); the
// xn reduction over rows happens in shared memory, so pht is never read
// back.  Columns past D are masked: any D works.
#include "common.cuh"

#define OP_W 32
#define OP_H 8

__global__ void __launch_bounds__(OP_W * OP_H)
obs_panels_kernel(const float* __restrict__ rowc_g, const float* __restrict__ hvb_g,
                  const float* __restrict__ si, const float* __restrict__ prows,
                  const float* __restrict__ vtf, const float* __restrict__ x,
                  float* __restrict__ pht, float* __restrict__ xn, float* __restrict__ nis,
                  int mp, int rp, int nbp, int d) {
    extern __shared__ float smem[];
    float* rowc = smem;                  // (mp, 8): col 7 = v
    float* vpan = rowc + 8 * mp;         // (nbp, OP_W) this block's columns of vtf
    float* part = vpan + nbp * OP_W;     // (OP_H, OP_W)
    float* siv = part + OP_H * OP_W;     // (mp,)
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int tid = ty * OP_W + tx;
    const int nth = OP_W * OP_H;
    const int n = blockIdx.x * OP_W + tx;
    const bool live = n < d;
    const int nc = live ? n : 0;         // a safe column for masked lanes

    for (int e = tid; e < 8 * mp; e += nth) rowc[e] = rowc_g[e];
    for (int b = ty; b < nbp; b += OP_H) vpan[b * OP_W + tx] = vtf[(size_t)b * d + nc];
    __syncthreads();
    for (int j = tid; j < mp; j += nth) {
        float acc = 0.f;
        for (int i = 0; i < mp; ++i) acc += rowc[8 * i + 7] * si[(size_t)i * mp + j];
        siv[j] = acc;
    }
    __syncthreads();
    if (blockIdx.x == 0 && ty == 0) {
        float s = 0.f;
        for (int j = tx; j < mp; j += OP_W) s += siv[j] * rowc[8 * j + 7];
        for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
        if (tx == 0) nis[0] = s;
    }

    const float p0 = prows[nc], p1 = prows[d + nc], p2 = prows[2 * d + nc];
    float xsum = 0.f;
    for (int i = ty; i < mp; i += OP_H) {
        const float* h = rowc + 8 * i;
        const float* hb = hvb_g + (size_t)i * nbp;
        const int cx = 3 + 2 * (i / 2), cy = cx + 1;
        float acc = h[0] * p0 + h[1] * p1 + h[2] * p2;
        if (cx < rp) acc += h[3] * prows[(size_t)cx * d + nc];
        if (cy < rp) acc += h[4] * prows[(size_t)cy * d + nc];
        float cpl = 0.f;
        for (int b = 0; b < nbp; ++b) cpl += __ldg(hb + b) * vpan[b * OP_W + tx];
        acc += cpl;
        if (live) pht[(size_t)i * d + n] = acc;
        xsum += siv[i] * acc;
    }
    part[ty * OP_W + tx] = xsum;
    __syncthreads();
    if (ty == 0 && live) {
        float s = 0.f;
        for (int r = 0; r < OP_H; ++r) s += part[r * OP_W + tx];
        const float v = x[n] + s;
        xn[n] = n == 2 ? csl_wrap(v) : v;
    }
}

extern "C" int csl_obs_panels(const float* rowc, const float* hvb, const float* si,
                              const float* prows, const float* vtf, const float* x, float* pht,
                              float* xn, float* nis, int mp, int rp, int nbp, int d,
                              void* stream) {
    const size_t smem =
        (size_t)(9 * mp + nbp * OP_W + OP_H * OP_W) * sizeof(float);
    if (mp <= 0 || mp % 2 || rp < 3 || nbp <= 0 || d < 3 || smem > CSL_MAX_SMEM)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = csl_allow_smem(obs_panels_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 block(OP_W, OP_H);
    const dim3 grid((d + OP_W - 1) / OP_W);
    obs_panels_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
        rowc, hvb, si, prows, vtf, x, pht, xn, nis, mp, rp, nbp, d);
    return (int)cudaGetLastError();
}
