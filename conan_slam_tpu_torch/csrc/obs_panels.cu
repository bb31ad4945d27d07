// H8 obs_panels: the gated frame's row strips pht = P' H^T (MP, D), the
// gains siv = v^T S^-1, the updated mean xn (D,) and the NIS, one column
// panel of D per block: the gated frame's split route (its default route
// is H10, obs_step.cu), and its only route from MP 226 to 2048.
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
// row i, and rowc, hvb from H7 and S^-1 from H1.
//
// What bounds it on the card: bytes.  It reads the (RP, D) gathered rows
// and the (NBP, D) factor strip and writes the (MP, D) pht, 1.27 MB at
// D = 1024 (23.5 MB at D = 20,224), with 5 + NBP FMAs per output.  At
// config 2 its time is latency (one round of loads, then the stores), so
// the design is H3's (frame_panels.cu), which keeps every block's loads in
// flight at once and fills the card:
//   - Narrow column panels (the plan: make_plan, mirrored by
//     obs_panels_plan in ops/frame_kernel.py): 8 columns while one block a
//     panel stays within the SMs' threads (128 blocks at D = 1024), else
//     16.  Blocks of 128 threads (4 column threads by 32 row groups), so
//     an SM holds up to six at the 85 registers a thread the launch bounds
//     allow.  When one round of resident blocks (the SMs' threads and
//     shared memory decide how many) does not cover the panels, a block
//     walks k of them, p, p + grid, ..., its fixed work (its siv part,
//     rowc and hvb) done once for them, up to OP_WALK columns (1,264
//     panels of 16 on 632 blocks at D = 20,224).
//   - At entry every thread issues cp.async copies of the block's first
//     panel of the gathered rows (panel.cuh, as H3 and H9), its (NBP, W)
//     panel of vtf and of x, and the first chunk of rowc and hvb rows;
//     they are in flight while siv is formed and shared.  A block that
//     walks several panels stages each next one once it has formed the
//     last (one buffer: the other blocks on its SM hide the wait, and a
//     second buffer would cost the shared memory that lets one round hold
//     them).
//   - siv is split over a cluster of 8 blocks: each forms MP / 8 of its
//     entries (rounded up to whole quads) with all its threads, four
//     entries a 16-byte read of S^-1, its first operands issued before the
//     staging copies (a fixed row split, then a fixed-order sum of the
//     partials), and every block reads the whole siv through distributed
//     shared memory while its staging copies land.  So each block reads
//     1/8 of S^-1 from L2, not all of it.  Blocks past the last panel only
//     form their siv part.
//   - Each thread holds a register tile of two measurements' four rows by
//     W / 4 columns: hvb is staged transposed, so a b step is one read of
//     the tile's four hvb entries and one of its W / 4 vtf columns for W
//     FMAs, and each slot row is read once.
//   - hvb and rowc are staged in chunks of 8 rows when all MP rows do not
//     fit beside the panel (MP 2048 at NBP 776, S = 256), so a block's
//     shared memory grows with MP + NBP, never MP x NBP.
//   - The xn reduction over rows runs in shared memory and warp shuffles
//     in a fixed order, so pht is never read back; no atomics, and two
//     calls are bit for bit equal.  Columns past D are masked: any D works.
#include <cooperative_groups.h>

#include "panel.cuh"

namespace cg = cooperative_groups;

#define OP_TX 4             // column threads: W / 4 columns each
#define OP_TY 32            // row groups: a tile of two measurements (four rows) at a time
#define OP_THREADS (OP_TX * OP_TY)
#define OP_CLUSTER 8        // blocks that share one siv
#define OP_MAX_MP 2048      // the largest S H1 inverts
#define OP_SM_THREADS 768   // threads an SM holds at the 85 registers a thread the kernel keeps to
#define OP_SM_SMEM 233472   // shared memory of an SM (bytes); each block also takes 1 KB of it
#define OP_WALK 32          // the most columns a block walks
#define OP_PLAN 10          // values csl_obs_panels_plan reports

namespace {

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// siv entries a block of a cluster forms: MP / OP_CLUSTER in whole quads.
__host__ __device__ constexpr int siv_block(int mp) {
    return round4((mp + OP_CLUSTER - 1) / OP_CLUSTER);
}
static_assert(siv_block(OP_MAX_MP) / 4 <= OP_THREADS, "a thread a quad of siv entries at least");

// Row stride of a chunk of hvb staged transposed, (NBP rounded up to 4,
// ldm): its rows rounded up to 8, plus 4, so a thread's four rows are one
// 16-byte read and the staging's writes (consecutive b) fall at most 4 to a
// bank.
__host__ __device__ constexpr int hvb_ldm(int rows) { return ((rows + 7) & ~7) + 4; }

// The shared memory of one block, in floats, for panels of w columns and
// chunks of `rows` rowc and hvb rows: siv, this block's siv entries, the
// partial sums (siv's, then the mean's), the chunk (rowc, hvb transposed),
// the panel buffer (a prows panel, a vtf panel and the panel's x).
size_t smem_floats(int mp, int rp, int nbp, int w, int rows) {
    const int part = OP_TY * (w + 1) > 4 * OP_THREADS ? OP_TY * (w + 1) : 4 * OP_THREADS;
    return (size_t)round4(mp) + siv_block(mp) + round4(part) + (size_t)rows * 8 +
           (rows ? (size_t)round4(nbp) * hvb_ldm(rows) : 0) + (size_t)rp * (w + 4) +
           (size_t)round4(nbp) * w + w;
}

struct Plan {
    int width;    // columns of D a panel
    int panels;   // panels of D
    int grid;     // blocks launched: whole clusters
    int rows;     // rowc and hvb rows a chunk (MP: all in one)
    size_t smem;  // bytes a block
};

int whole_clusters(int blocks) { return (blocks + OP_CLUSTER - 1) / OP_CLUSTER * OP_CLUSTER; }

// 8-column panels while one block a panel stays within the SMs' threads,
// else 16, if all MP rows of rowc and hvb fit beside the panel; else 8
// columns and the most rows a chunk that fit, a multiple of 8.  Then the
// fewest panels a block, k, that one round of resident blocks covers (the
// SMs' threads and shared memory decide how many an SM holds), but no more
// than OP_WALK columns a block, and the grid ceil(panels / k) in whole
// clusters.
bool make_plan(int d, int mp, int rp, int nbp, int sms, Plan* p) {
    const size_t floats = CSL_MAX_SMEM / sizeof(float);
    const int by_threads = OP_SM_THREADS / OP_THREADS;
    const int w0 = (d + 7) / 8 <= by_threads * sms ? 8 : 16;
    for (int w = w0;; w = 8) {
        const size_t fixed = smem_floats(mp, rp, nbp, w, 0) + 4 * round4(nbp);
        long long rows = fixed > floats ? 0 : (long long)((floats - fixed) / (8 + round4(nbp)));
        rows = rows & ~7LL;
        if (rows >= mp) rows = smem_floats(mp, rp, nbp, w, mp) <= floats ? mp : mp & ~7;
        if (rows != mp && w != 8) continue;
        if (rows < 8 && rows != mp) return false;
        const int panels = (d + w - 1) / w;
        const size_t smem = smem_floats(mp, rp, nbp, w, (int)rows) * sizeof(float);
        const int by_smem = (int)(OP_SM_SMEM / (smem + 1024));
        const int resident = (by_smem < by_threads ? by_smem : by_threads) * sms;
        const int k_round = resident > 0 ? (panels + resident - 1) / resident : panels;
        const int k = k_round < OP_WALK / w ? k_round : OP_WALK / w;
        *p = Plan{w, panels, whole_clusters((panels + k - 1) / k), (int)rows, smem};
        return true;
    }
}

bool shapes_ok(int d, int mp, int rp, int nbp) {
    return mp > 0 && mp % 4 == 0 && mp <= OP_MAX_MP && rp >= 3 && nbp > 0 && d >= 3;
}

// Phase stamps of a diagnostic build (-DOP_STAMPS): thread 0 of block b
// writes its %globaltimer (ns) into g_op_stamps[b][k] at the kernel's
// phase boundaries (see the calls of op_stamp), and its SM into [b][9].
#ifdef OP_STAMPS
#define OP_NSTAMP 10
#define OP_STAMP_BLOCKS 4096
__device__ unsigned long long g_op_stamps[OP_STAMP_BLOCKS * OP_NSTAMP];

__device__ __forceinline__ void op_stamp(int k) {
    if (threadIdx.x == 0 && blockIdx.x < OP_STAMP_BLOCKS) {
        unsigned long long t;
        unsigned sm;
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
        asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
        g_op_stamps[blockIdx.x * OP_NSTAMP + k] = t;
        g_op_stamps[blockIdx.x * OP_NSTAMP + 9] = sm;
    }
}
#else
__device__ __forceinline__ void op_stamp(int) {}
#endif

__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// C consecutive floats of shared memory (8C-byte aligned) into registers.
template <int C>
__device__ __forceinline__ void load_cols(const float* s, float (&v)[C]) {
    if constexpr (C == 2) {
        const float2 a = *reinterpret_cast<const float2*>(s);
        v[0] = a.x;
        v[1] = a.y;
    } else {
        const float4 a = *reinterpret_cast<const float4*>(s);
        v[0] = a.x;
        v[1] = a.y;
        v[2] = a.z;
        v[3] = a.w;
    }
}

// Row i of pht at columns n .. n + C - 1: one vector when every column is
// inside D and the row is 16-byte aligned (vec: D % 4 == 0), else column by
// column, masked at D.
template <int C>
__device__ __forceinline__ void store_cols(float* row, int n, int d, bool vec,
                                           const float (&v)[C]) {
    if (vec && n + C <= d) {
        if constexpr (C == 2)
            *reinterpret_cast<float2*>(row + n) = make_float2(v[0], v[1]);
        else
            *reinterpret_cast<float4*>(row + n) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
        for (int c = 0; c < C; ++c)
            if (n + c < d) row[n + c] = v[c];
    }
}

// Stage rows r0 .. r0 + n - 1 of rowc (8 floats a row) and of hvb,
// transposed: hT[b * ldm + r] = hvb[r0 + r, b], zero for NBP <= b < NBP
// rounded up to 4, with cp.async; the caller commits and waits.
__device__ __forceinline__ void stage_chunk(float* rc, float* ht, const float* rowc_g,
                                            const float* hvb_g, int r0, int n, int nbp) {
    const int ldm = hvb_ldm(n), nb4 = round4(nbp), tid = threadIdx.x;
    csl_stage(rc, rowc_g + 8 * (size_t)r0, 8 * n);
    const float* src = hvb_g + (size_t)r0 * nbp;
    for (int e = tid; e < n * nb4; e += OP_THREADS) {
        const int r = e / nb4, b = e % nb4;
        const bool in = b < nbp;
        csl_cp_async4(ht + b * ldm + r, in ? src + (size_t)r * nbp + b : src, in);
    }
}

template <int W>
__global__ void __cluster_dims__(OP_CLUSTER, 1, 1)
__launch_bounds__(OP_THREADS, OP_SM_THREADS / OP_THREADS)
obs_panels_kernel(const float* __restrict__ rowc_g, const float* __restrict__ hvb_g,
                  const float* __restrict__ si, const float* __restrict__ prows,
                  const float* __restrict__ vtf, const float* __restrict__ x,
                  float* __restrict__ pht, float* __restrict__ xn, float* __restrict__ nis,
                  int mp, int rp, int nbp, int d, int npanel, int rows) {
    constexpr int C = W / OP_TX;   // a thread's columns
    constexpr int LD = W + 4;      // panel row stride: 16-byte rows, the slot rows of a warp's
                                   // tiles on as few bank rounds as their bytes need
    constexpr int PW = W + 1;      // the mean's partial sums' row stride: a warp's column reads
                                   // conflict-free
    extern __shared__ __align__(16) float smem[];
    const int tid = threadIdx.x, tx = tid % OP_TX, ty = tid / OP_TX;
    const int q = siv_block(mp), quads = q / 4;              // siv entries a block forms
    const int groups = OP_THREADS / quads;                   // row groups forming them
    const int nb4 = round4(nbp);
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    float* siv = smem;                       // (mp,)
    float* own = siv + round4(mp);           // (q,) this block's siv entries
    float* part = own + q;                   // partial sums: siv's (groups, q), the mean's
                                             // (OP_TY, PW)
    float* rc = part + round4(OP_TY * PW > 4 * OP_THREADS ? OP_TY * PW : 4 * OP_THREADS);
                                             // (rows, 8) a chunk of rowc: col 7 = v
    float* ht = rc + 8 * rows;               // (nb4, hvb_ldm(rows)) the chunk's hvb, transposed
    float* pan = ht + nb4 * hvb_ldm(rows);   // (rp, LD) prows[:, p W : (p + 1) W]
    float* vp = pan + rp * LD;               // (nb4, W) vtf's columns, zero past NBP
    float* xp = vp + nb4 * W;                // (W,) x's columns
    const bool vec = (d & 3) == 0;
    const bool pvec = vec && (reinterpret_cast<unsigned long long>(prows) & 15u) == 0;
    const bool vvec = vec && (reinterpret_cast<unsigned long long>(vtf) & 15u) == 0;
    const bool xvec = vec && (reinterpret_cast<unsigned long long>(x) & 15u) == 0;
    // Panel p's columns of prows, vtf and x.
    auto stage_panel = [&](int p) {
        csl_stage_panel(pan, [&](int r) { return prows + (size_t)r * d; }, rp, W, LD, p * W, d,
                        pvec);
        csl_stage_panel(vp, [&](int r) { return vtf + (size_t)r * d; }, nbp, W, W, p * W, d, vvec);
        csl_stage_panel(xp, [&](int) { return x; }, 1, W, W, p * W, d, xvec);
    };

    op_stamp(0);
    // --- siv's first operands (four rows a thread: all of them at MP 128),
    //     issued first, so that they lead the memory queue ---
    const int jq = tid % quads, g = tid / quads, j = rank * q + 4 * jq;
    const bool forms = g < groups && j < mp;   // MP % 4 == 0: a quad is all in or all out
    float v_pre[4];
    float4 s_pre[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
        const int i = g + t * groups;
        const bool in = forms && i < mp;
        v_pre[t] = in ? rowc_g[8 * i + 7] : 0.f;
        s_pre[t] = in ? *reinterpret_cast<const float4*>(si + (size_t)i * mp + j)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }

    // --- stage the first panel and chunk, in flight while siv is formed and shared ---
    int p = blockIdx.x;
    int staged = 0;                          // the first row of the chunk in shared memory
    if (p < npanel) {
        for (int e = tid; e < (nb4 - nbp) * W; e += OP_THREADS) vp[nbp * W + e] = 0.f;
        stage_panel(p);
        stage_chunk(rc, ht, rowc_g, hvb_g, 0, rows < mp ? rows : mp, nbp);
    }
    csl_cp_async_commit();

    // --- this block's siv entries, a quad of them a 16-byte read of S^-1:
    //     rows split over `groups`, then summed in a fixed order ---
    {
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
            acc.x += v_pre[t] * s_pre[t].x;
            acc.y += v_pre[t] * s_pre[t].y;
            acc.z += v_pre[t] * s_pre[t].z;
            acc.w += v_pre[t] * s_pre[t].w;
        }
        if (forms) {
#pragma unroll 8
            for (int i = g + 4 * groups; i < mp; i += groups) {
                const float v = rowc_g[8 * i + 7];
                const float4 s4 = *reinterpret_cast<const float4*>(si + (size_t)i * mp + j);
                acc.x += v * s4.x;
                acc.y += v * s4.y;
                acc.z += v * s4.z;
                acc.w += v * s4.w;
            }
        }
        *reinterpret_cast<float4*>(part + 4 * tid) = acc;
    }
    __syncthreads();
    for (int e = tid; e < q; e += OP_THREADS) {
        float s = 0.f;
        for (int gr = 0; gr < groups; ++gr) s += part[4 * (gr * quads) + e];
        own[e] = s;
    }
    op_stamp(1);
    // The exchange runs while the staging copies are still in flight.
    cluster_arrive();
    cluster_wait();                        // every block of the cluster holds its entries
    for (int j = tid; j < mp; j += OP_THREADS)
        siv[j] = *cluster.map_shared_rank(own + j % q, j / q);
    cluster_arrive();                      // no more reads of the cluster's memory
    csl_cp_async_wait<0>();
    __syncthreads();
    op_stamp(2);

    if (blockIdx.x == 0 && tid < 32) {
        float s = 0.f;
        for (int j = tid; j < mp; j += 32) s += siv[j] * rowc_g[8 * j + 7];
        for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
        if (tid == 0) nis[0] = s;
    }

    // --- the block's panels p, p + grid, ...: pht, a tile of two
    //     measurements' four rows by C columns a thread, and the row
    //     group's share of siv pht ---
    const int cl = tx * C;
    for (int k = 0; p < npanel; p += gridDim.x, ++k) {
        const int n = p * W + cl;
        if (k > 0) {                       // the panel buffer is free: stage this panel
            stage_panel(p);
            csl_cp_async_commit();
            csl_cp_async_wait<0>();
            __syncthreads();
        }
        float p0[C], p1[C], p2[C], xs[C];
        load_cols<C>(pan + cl, p0);
        load_cols<C>(pan + LD + cl, p1);
        load_cols<C>(pan + 2 * LD + cl, p2);
#pragma unroll
        for (int c = 0; c < C; ++c) xs[c] = 0.f;
        for (int r0 = 0; r0 < mp; r0 += rows) {
            const int nr = mp - r0 < rows ? mp - r0 : rows;
            const int ldm = hvb_ldm(nr);
            if (r0 != staged) {            // the chunk, once the last one is consumed
                __syncthreads();
                stage_chunk(rc, ht, rowc_g, hvb_g, r0, nr, nbp);
                csl_cp_async_commit();
                csl_cp_async_wait<0>();
                __syncthreads();
                staged = r0;
            }
            for (int li = 4 * ty; li < nr; li += 4 * OP_TY) {
                // Rows i .. i + 3: measurements i / 2 and i / 2 + 1, whose
                // slot rows are the gathered rows 3 + i .. 6 + i.
                const int i = r0 + li;
                float acc[4][C];
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                    for (int c = 0; c < C; ++c) acc[r][c] = 0.f;
#pragma unroll 4
                for (int b = 0; b < nb4; ++b) {
                    const float4 u = *reinterpret_cast<const float4*>(ht + b * ldm + li);
                    float v[C];
                    load_cols<C>(vp + b * W + cl, v);
#pragma unroll
                    for (int c = 0; c < C; ++c) {
                        acc[0][c] += u.x * v[c];
                        acc[1][c] += u.y * v[c];
                        acc[2][c] += u.z * v[c];
                        acc[3][c] += u.w * v[c];
                    }
                }
#pragma unroll
                for (int m = 0; m < 2; ++m) {
                    const int cx = 3 + i + 2 * m, cy = cx + 1;
                    float sx[C] = {}, sy[C] = {};
                    if (cx < rp) load_cols<C>(pan + cx * LD + cl, sx);
                    if (cy < rp) load_cols<C>(pan + cy * LD + cl, sy);
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const int r = 2 * m + h;
                        const float4 ha = *reinterpret_cast<const float4*>(rc + 8 * (li + r));
                        const float hb = rc[8 * (li + r) + 4];
                        const float s = siv[i + r];
                        float a[C];
#pragma unroll
                        for (int c = 0; c < C; ++c) {
                            a[c] = ha.x * p0[c] + ha.y * p1[c] + ha.z * p2[c];
                            if (cx < rp) a[c] += ha.w * sx[c];
                            if (cy < rp) a[c] += hb * sy[c];
                            a[c] += acc[r][c];
                            xs[c] += s * a[c];
                        }
                        store_cols<C>(pht + (size_t)(i + r) * d, n, d, vec, a);
                    }
                }
            }
        }
#pragma unroll
        for (int c = 0; c < C; ++c) part[ty * PW + cl + c] = xs[c];
        __syncthreads();
        if (k < 2) op_stamp(3 + 2 * k);

        // xn: warp w sums columns w, w + OP_THREADS / 32, ... over the row
        // groups, lanes then a shuffle tree: a fixed order.
        const int lane = tid & 31;
        for (int col = tid >> 5; col < W; col += OP_THREADS / 32) {
            float s = 0.f;
            for (int r = lane; r < OP_TY; r += 32) s += part[r * PW + col];
            for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
            const int nx = p * W + col;
            if (lane == 0 && nx < d) {
                const float v = xp[col] + s;
                xn[nx] = nx == 2 ? csl_wrap(v) : v;
            }
        }
        __syncthreads();                   // part and the panel buffer are free
        if (k < 2) op_stamp(4 + 2 * k);
    }
    op_stamp(7);
    cluster_wait();                        // the cluster's blocks are done reading this one
    op_stamp(8);
}

template <int W>
cudaError_t launch(const Plan& p, const float* rowc, const float* hvb, const float* si,
                   const float* prows, const float* vtf, const float* x, float* pht, float* xn,
                   float* nis, int mp, int rp, int nbp, int d, cudaStream_t st) {
    const cudaError_t err = csl_allow_smem(obs_panels_kernel<W>, p.smem);
    if (err != cudaSuccess) return err;
    obs_panels_kernel<W><<<p.grid, OP_THREADS, p.smem, st>>>(rowc, hvb, si, prows, vtf, x, pht,
                                                             xn, nis, mp, rp, nbp, d, p.panels,
                                                             p.rows);
    return cudaGetLastError();
}

constexpr int MAX_DEVICES = 64;
int g_sms[MAX_DEVICES] = {};

// The current device's SMs (cached) into *sms.
cudaError_t device_sms(int* sms) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
    if (g_sms[dev] == 0) {
        err = cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount, dev);
        if (err != cudaSuccess) return err;
    }
    *sms = g_sms[dev];
    return cudaSuccess;
}

// The kernel's registers and local bytes a thread, and the clusters of
// its plan that the card holds at once (cudaOccupancyMaxActiveClusters).
template <int W>
cudaError_t attributes(const Plan& p, int* regs, int* local, int* clusters) {
    cudaError_t err = csl_func_regs(obs_panels_kernel<W>, regs, local);
    if (err == cudaSuccess) err = csl_allow_smem(obs_panels_kernel<W>, p.smem);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(p.grid);
    cfg.blockDim = dim3(OP_THREADS);
    cfg.dynamicSmemBytes = p.smem;
    return cudaOccupancyMaxActiveClusters(clusters, obs_panels_kernel<W>, &cfg);
}

}  // namespace

// The plan at (d, mp, rp, nbp) on the current device, as OP_PLAN ints: the
// panel width, the panels, the grid, the cluster, the block, the rowc/hvb
// rows a chunk, the dynamic shared memory (bytes), the kernel's registers
// and local bytes a thread, and the clusters the card holds at once.
// Launches nothing.
extern "C" int csl_obs_panels_plan(int d, int mp, int rp, int nbp, int* out) {
    int sms = 0;
    cudaError_t err = device_sms(&sms);
    if (err != cudaSuccess) return (int)err;
    Plan p;
    if (!shapes_ok(d, mp, rp, nbp) || !make_plan(d, mp, rp, nbp, sms, &p))
        return (int)cudaErrorInvalidValue;
    int regs = 0, local = 0, clusters = 0;
    err = p.width == 8 ? attributes<8>(p, &regs, &local, &clusters)
                       : attributes<16>(p, &regs, &local, &clusters);
    if (err != cudaSuccess) return (int)err;
    const int vals[OP_PLAN] = {p.width, p.panels, p.grid, OP_CLUSTER, OP_THREADS, p.rows,
                               (int)p.smem, regs, local, clusters};
    for (int k = 0; k < OP_PLAN; ++k) out[k] = vals[k];
    return (int)cudaSuccess;
}

#ifdef OP_STAMPS
// The diagnostic build's stamps of the last launch: n values of
// g_op_stamps ((block, OP_NSTAMP) row-major) into host memory.
extern "C" int csl_obs_panels_stamps(unsigned long long* out, int n) {
    if (n < 0 || n > OP_STAMP_BLOCKS * OP_NSTAMP) return (int)cudaErrorInvalidValue;
    return (int)cudaMemcpyFromSymbol(out, g_op_stamps, (size_t)n * sizeof(unsigned long long));
}
#endif

// One call: si 16-byte aligned (four siv entries a read); any D, MP % 4 == 0.
extern "C" int csl_obs_panels(const float* rowc, const float* hvb, const float* si,
                              const float* prows, const float* vtf, const float* x, float* pht,
                              float* xn, float* nis, int mp, int rp, int nbp, int d,
                              void* stream) {
    int sms = 0;
    const cudaError_t err = device_sms(&sms);
    if (err != cudaSuccess) return (int)err;
    Plan p;
    if (!shapes_ok(d, mp, rp, nbp) || !make_plan(d, mp, rp, nbp, sms, &p) ||
        (reinterpret_cast<unsigned long long>(si) & 15u))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    if (p.width == 8)
        return (int)launch<8>(p, rowc, hvb, si, prows, vtf, x, pht, xn, nis, mp, rp, nbp, d, st);
    return (int)launch<16>(p, rowc, hvb, si, prows, vtf, x, pht, xn, nis, mp, rp, nbp, d, st);
}
