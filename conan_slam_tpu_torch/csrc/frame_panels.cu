// H3 frame_panels: the gains siv = v^T S^-1, pht = Hc P'[rows] (MP, D) and
// the updated mean xn (D,), one 16-column panel of D per block; block 0
// also writes the NIS v^T S^-1 v.
//
// Replaces the per-step body of the TPU kernel conan_slam_tpu/ops/
// frame_kernel.py:1123 _chain_dispatch (pallas_call :1139, body
// _bigchain_kernel :1060-1104), which produced one (MP, tc) panel per grid
// step from the state grid step 0 left in scratch (siv formed once, in
// order, before the panels).  Here that state comes from device memory
// (rowc and ms from H2, S^-1 from H1), and the panels are blocks that run
// in parallel and in no order.
//
//   pht[i, n] = sum_{a in nz(i)} Hc[i, a] prows[a, n] + hp2_i wrow[n]
//               + hg_i p2[n] + sum_{r<3} Hc[i, r] m3[r, n]   (n < 3 only)
//   xn[n]     = base[n] + sum_i siv_i pht[i, n],  heading (n = 2) wrapped
//
// with wrow = alpha p2 + g (first 3 lanes), base = pose (n < 3) or
// x + corr0 p2, and nz(i) the five nonzero columns of compact Hc row i.
//
// What bounds it on the card: bytes.  It reads the (RP, D) gathered rows
// (1.25 MB at RP = 136, D = 2304) and writes the (MP, D) pht (1.18 MB) with
// ~10 FLOPs per output, far below the FLOP/byte ridge: 0.75 us at
// 3.35 TB/s.  At that size its time is latency (one round of loads, then
// the stores), so the design keeps every block's loads in flight at once
// and fills the card:
//   - 16-column panels: 144 blocks at D = 2304 for 132 SMs, 256 threads
//     each (16 columns x 16 row groups, a row group one measurement's two
//     rows at a time, so its two slot rows are read once).
//   - At entry every thread issues cp.async copies of its block's panel of
//     prows (all RP rows, zero past D), rowc and ms into shared memory;
//     they are in flight while siv is formed.
//   - siv is split over a cluster of 8 blocks: each forms MP / 8 of its
//     entries with all 256 threads (a fixed row split, then a fixed-order
//     sum of the partials), and every block reads the whole siv from the
//     cluster's blocks through distributed shared memory.  So each block
//     reads 1/8 of S^-1 from L2, not all of it, and no block waits on a
//     block outside its cluster.  The grid is rounded up to whole
//     clusters; blocks past the last panel only form their siv part.
//   - The xn reduction over rows runs in shared memory in a fixed order,
//     so pht is never read back; no atomics, and two calls are bit for bit
//     equal.  Columns past D are masked: any D works.
//   - The column's pht and the panel staging are panel.cuh, which H9
//     (frame_step.cu) runs too.
#include <cooperative_groups.h>

#include "panel.cuh"

namespace cg = cooperative_groups;

#define PANEL_W 16          // columns of D a block
#define PANEL_H 16          // row groups: PANEL_W x PANEL_H threads
#define PANEL_LD 24         // panel row stride in shared memory: 16-byte rows, and two
                            // measurements' slot rows fall on disjoint banks
#define PANEL_CLUSTER 8     // blocks that share one siv
#define PANEL_THREADS (PANEL_W * PANEL_H)

__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__global__ void __cluster_dims__(PANEL_CLUSTER, 1, 1) __launch_bounds__(PANEL_THREADS)
frame_panels_kernel(const float* __restrict__ rowc_g, const float* __restrict__ ms_g,
                    const float* __restrict__ si, const float* __restrict__ prows,
                    const float* __restrict__ x, float* __restrict__ pht,
                    float* __restrict__ xn, float* __restrict__ nis, int mp, int rp, int d,
                    int npanel) {
    extern __shared__ __align__(16) float smem[];
    const int tid = threadIdx.x, tx = tid % PANEL_W, ty = tid / PANEL_W;
    const int nzl = mp / 2;
    const int q = (mp + PANEL_CLUSTER - 1) / PANEL_CLUSTER;   // siv entries a block forms
    const int groups = PANEL_THREADS / q;                    // row groups forming them
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    float* rc = smem;                      // (mp, 8) rowc: col 7 = v
    float* msh = rc + 8 * mp;              // (32,)
    float* pan = msh + 32;                 // (rp, PANEL_LD) prows[:, c0 : c0 + PANEL_W]
    float* part = pan + rp * PANEL_LD;     // (PANEL_THREADS,) partial sums
    float* siv = part + PANEL_THREADS;     // (mp,)
    float* own = siv + ((mp + 3) & ~3);    // (q,) this block's siv entries

    // --- stage rowc, ms and the panel, in flight while siv is formed ---
    const int c0 = blockIdx.x * PANEL_W;
    const int n = c0 + tx;
    const float xv = ty == 0 && n < d ? x[n] : 0.f;
    csl_stage(rc, rowc_g, 8 * mp);
    csl_stage(msh, ms_g, 32);
    csl_stage_panel(pan, [&](int r) { return prows + (size_t)r * d; }, rp, PANEL_W, PANEL_LD, c0,
                    d, (d & 3) == 0 && (reinterpret_cast<unsigned long long>(prows) & 15u) == 0);

    // --- this block's siv entries: rows split over `groups`, then summed
    //     in a fixed order ---
    {
        const int jl = tid % q, g = tid / q, j = rank * q + jl;
        float acc = 0.f;
        if (g < groups && j < mp)
            for (int i = g; i < mp; i += groups) acc += rowc_g[8 * i + 7] * si[(size_t)i * mp + j];
        part[tid] = acc;
    }
    csl_cp_async_commit();
    csl_cp_async_wait<0>();
    __syncthreads();
    if (tid < q) {
        float s = 0.f;
        for (int g = 0; g < groups; ++g) s += part[g * q + tid];
        own[tid] = s;
    }
    cluster_arrive();
    cluster_wait();                        // every block of the cluster holds its entries
    for (int j = tid; j < mp; j += PANEL_THREADS) siv[j] = *cluster.map_shared_rank(own + j % q, j / q);
    cluster_arrive();                      // no more reads of the cluster's memory
    __syncthreads();

    if (blockIdx.x == 0 && tid < 32) {
        float s = 0.f;
        for (int j = tid; j < mp; j += 32) s += siv[j] * rc[8 * j + 7];
        for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
        if (tid == 0) nis[0] = s;
    }

    // --- pht and the row group's share of siv pht ---
    const bool panel = blockIdx.x < npanel, live = n < d;
    const float p0 = pan[tx], p1 = pan[PANEL_LD + tx], p2 = pan[2 * PANEL_LD + tx];
    if (panel) {
        const CslPanelColumn col = csl_panel_column(msh, p0, p1, p2, n);
        float xsum = 0.f;
        for (int l = ty; l < nzl; l += PANEL_H) {
            const int cx = 3 + 2 * l, cy = cx + 1;
            const float sx = cx < rp ? pan[cx * PANEL_LD + tx] : 0.f;
            const float sy = cy < rp ? pan[cy * PANEL_LD + tx] : 0.f;
            for (int k = 0; k < 2; ++k) {
                const int i = 2 * l + k;
                const float acc = csl_pht_entry(rc + 8 * i, col, sx, sy, cx < rp, cy < rp);
                if (live) pht[(size_t)i * d + n] = acc;
                xsum += siv[i] * acc;
            }
        }
        part[tid] = xsum;
    }
    __syncthreads();
    if (panel && ty == 0 && live) {
        float s = 0.f;
        for (int r = 0; r < PANEL_H; ++r) s += part[r * PANEL_W + tx];
        const float base = n < 3 ? msh[n] : xv + p2 * msh[3];
        const float v = base + s;
        xn[n] = n == 2 ? csl_wrap(v) : v;
    }
    cluster_wait();                        // the cluster's blocks are done reading this one
}

// Shared memory of one block: rowc, ms, the panel, partials, siv.
static size_t frame_panels_smem(int mp, int rp) {
    const int q = (mp + PANEL_CLUSTER - 1) / PANEL_CLUSTER;
    return (size_t)(8 * mp + 32 + rp * PANEL_LD + PANEL_THREADS + ((mp + 3) & ~3) + q) *
           sizeof(float);
}

extern "C" int csl_frame_panels(const float* rowc, const float* ms, const float* si,
                                const float* prows, const float* x, float* pht, float* xn,
                                float* nis, int mp, int rp, int d, int panel_w, int grid,
                                void* stream) {
    const int npanel = (d + PANEL_W - 1) / PANEL_W;
    // The plan (ops/frame_kernel.py frame_panels_plan): PANEL_W-column
    // panels, the grid rounded up to whole clusters.
    if (mp <= 0 || mp % 2 || mp > PANEL_CLUSTER * PANEL_THREADS || rp < 3 || d < 3 ||
        panel_w != PANEL_W || grid % PANEL_CLUSTER || grid < npanel ||
        grid >= npanel + PANEL_CLUSTER)
        return (int)cudaErrorInvalidValue;
    const size_t smem = frame_panels_smem(mp, rp);
    if (smem > CSL_MAX_SMEM) return (int)cudaErrorInvalidValue;
    cudaError_t err = csl_allow_smem(frame_panels_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    frame_panels_kernel<<<grid, PANEL_THREADS, smem, (cudaStream_t)stream>>>(
        rowc, ms, si, prows, x, pht, xn, nis, mp, rp, d, npanel);
    return (int)cudaGetLastError();
}
