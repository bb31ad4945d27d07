// H9 frame_step: the whole known-association frame in ONE cooperative
// launch: the packing, the S-step recursion, observe, S, the sweep inverse,
// the gains, the updated mean, the NIS and the P pass.
//
// Replaces the TPU kernel conan_slam_tpu/ops/frame_kernel.py:1312
// frame_step (pallas_call :1399, body _framestep_kernel :655-907), the
// reference's one-dispatch resident schedule.  On the TPU its grid ran in
// order: grid step 0 formed the chain, S^-1, siv, xn and the NIS into VMEM
// scratch, and every step then wrote one row panel of
// P + p2 (x) wrow - (pht^T_panel S^-1) pht plus the 3-row border.  Hopper
// blocks run in no order, so the phases here are separated by grid
// barriers (cooperative_groups grid sync; the launch is cooperative, one
// block an SM, every block resident), and what the TPU kept in scratch goes
// through device memory (L2) between phases:
//
//   1. Chain.  Each block that owns a band of measurement rows (the plan of
//      H2, ops/frame_kernel.py frame_chain_plan) packs the frame's raw
//      inputs itself (the gathered rows [0, 1, 2, 3 + 2 s, 4 + 2 s] from the
//      slots clamped to the capacity, zin, R, the controls and chol(Q) in
//      closed form, as ops/frame_kernel.py _pack_meas, _pack_ctrl), gathers
//      the band's rows of P[rows][:, rows] and x[rows] from P and x, runs the
//      recursion on one warp, the observe, and its rows of psub and S
//      (chain_band.cuh, H2's phases).  Block 0 writes the pose trace and the
//      frame scalars.
//   2. Block 0 inverts S by H1's register-resident sweep (sweep.cuh) over
//      nblk = last valid slot + 1 pivots and forms siv = v^T S^-1 and the
//      NIS.  Meanwhile the other blocks form pht = Hc P'[rows] in 16-column
//      panels (panel.cuh, H3's column) into the strip G.
//   3. Every block takes 16-column panels of the strips: -S^-1 pht into MG,
//      the K4 rows of G = [pht; p2; e0; e1; e2; 0] and MG = [-S^-1 pht;
//      wrow; border; 0] (the closed form U K4 U^T, U = [p2, e0, e1, e2]),
//      and the mean xn = base + siv pht, heading wrapped.
//   4. The P pass: out = P + G^T MG = P + p2 (x) wrow + border
//      - pht^T S^-1 pht, over H4's upper-triangle tiles of 32
//      (rank_tile.cuh), each mirrored: P comes out exactly symmetric
//      whenever it goes in exactly symmetric.  A block runs 8 tiles at a
//      time, one on each group of 2 warps with its own named barrier.
//
// What bounds it on the card: at the bench shape (D = 2304, MP = 128) P's
// bytes, 2 D^2 x 4 B = 42.5 MB (12.7 us at 3.35 TB/s), against ~0.7 GFLOP
// of the P pass (10.8 us at 67 TFLOP/s fp32); in practice the serial sweep
// (phase 2, one block) and the P pass.  fp32 FMA only (TF32 off, no tensor
// cores).  No atomics: every sum is one thread's fixed chain or a
// fixed-order reduction, so two calls are bit for bit equal.
//
// Block size: 512 threads for every phase, the sweep's 16 warps (H1's
// register layout needs them); the panels take 16 columns x 32 row groups,
// the P pass 8 groups of H4's 64-thread 32-tile.  Shared memory is the
// largest of the phases' needs, not their sum.  Data written during the
// launch is read with __ldcg or cp.async.cg (through L2, never from a
// stale L1 line or the read-only path).
//
// The C entry launches on the stream it is given, allocates nothing (the
// caller hands it one scratch buffer), and
// returns cudaGetLastError(), so the launch can be captured in a CUDA graph.
#include <cooperative_groups.h>

#include <algorithm>

#include "chain_band.cuh"
#include "panel.cuh"
#include "rank_tile.cuh"
#include "sweep.cuh"

namespace cg = cooperative_groups;

#define FS_THREADS 512      // 16 warps: H1's sweep layout (csl_sweep::NT)
#define FS_W 16             // columns of a panel (H3's PANEL_W)
#define FS_LD 24            // row stride of a gathered panel (H3's PANEL_LD)
#define FS_TILE 32          // the P pass's tile edge (H4's small tile)
#define FS_GROUP 64         // threads of one P-pass tile (csl_rank::Cfg<32>::NT)
#define FS_MAX_MP 224       // H1's register limit: 7 x 7 elements a thread
#define FS_MAX_RP 232       // gathered rows at MP = 224

namespace {

static_assert(FS_THREADS == csl_sweep::NT, "one block size for every phase");
static_assert(FS_GROUP == csl_rank::Cfg<FS_TILE>::NT, "the P pass's tile group");
constexpr int FS_GROUPS = FS_THREADS / FS_GROUP;     // tiles a block runs at once
constexpr int FS_ROWG = FS_THREADS / FS_W;           // row groups of a panel
constexpr int FS_COLG = FS_W / 4;                    // 4-column groups of a panel

// The frame: inputs, outputs, the scratch carved by the host, strides (in
// elements) of the 1-D inputs, shapes and scalars.
struct Frame {
    const float* p;                 // (d, d)
    const float* x;                 // (d,)
    const long long* slots;         // (nz,)
    const float* vns;               // (S,)
    const float* swans;             // (S,)
    const float* phis;              // (S,)
    const unsigned char* actives;   // (S,) bool
    const float* q_cov;             // (2, 2)
    const float* zr;                // (nz,)
    const float* zb;                // (nz,)
    const unsigned char* mask;      // (nz,) bool
    const float* r_cov;             // (2, 2)
    float* p_out;                   // (d, d)
    float* xn;                      // (d,)
    float* pt;                      // (S, 3)
    float* nis;                     // (1,)
    float* s;                       // (mp, mp)  S
    float* si;                      // (mp, mp)  S^-1
    float* rowc;                    // (mp, 8)   the chain's per-row coefficients
    float* ms;                      // (32,)     the frame scalars
    float* siv;                     // (mp,)
    float* g;                       // (mp + 8, ldg)  G
    float* mg;                      // (mp + 8, ldg)  M G
    unsigned long long* stamps;     // (grid, 8) phase boundary times, or null
    int slots_st, vns_st, swans_st, phis_st, actives_st, zr_st, zb_st, mask_st;
    int d, nz, S, cap, mp, rp, ldg, band;
    int vecp;                       // P's rows take 16-byte accesses
    float wheel_base, dt, sigma_heading;
    int use_heading;
};

// Gathered row a: [0, 1, 2, 3 + 2 s_0, 4 + 2 s_0, ...] with the slots
// clamped to [0, cap - 1]; pad rows past 3 + 2 nz re-read row 0 (their Hc
// columns are zero).
__device__ __forceinline__ int gathered_row(const Frame& f, int a) {
    if (a < 3) return a;
    const int l = (a - 3) >> 1;
    if (l >= f.nz) return 0;
    long long s = f.slots[(size_t)l * f.slots_st];
    s = s < 0 ? 0 : (s >= f.cap ? f.cap - 1 : s);
    return 3 + 2 * (int)s + ((a - 3) & 1);
}

// Block b's %globaltimer (ns) into stamps[b, k] when the caller asked for
// them: k = 0 the start, 1 the chain done, 2 past barrier 1, 3 the sweep or
// the pht panels done, 4 past barrier 2, 5 the gains done, 6 past barrier 3,
// 7 the P pass done.  A "done" stamp waits for the whole block first.
__device__ __forceinline__ void stamp(const Frame& f, int k, bool done) {
    if (f.stamps == nullptr) return;
    if (done) __syncthreads();
    if (threadIdx.x == 0) {
        unsigned long long t;
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
        f.stamps[(size_t)blockIdx.x * 8 + k] = t;
    }
}

// n floats (n % 4 == 0, 16-byte aligned ends) written earlier in this
// launch, into shared memory through L2 (cp.async.cg).
__device__ __forceinline__ void stage_cg(float* dst, const float* src, int n) {
    for (int e = 4 * threadIdx.x; e < n; e += 4 * FS_THREADS) csl_cp_async16(dst + e, src + e, true);
}

// --- phase 1: the chain, one band of measurement rows a block ---
__device__ __forceinline__ void chain_phase(const Frame& f, float* smem, const int* rows,
                                            float* qc, float* ms) {
    const int tid = threadIdx.x;
    const int mp = f.mp, rp = f.rp, nzl = mp / 2, band = f.band;
    const int nbands = (mp + band - 1) / band;
    const int rpa = (rp + 3) & ~3;
    float* prb = smem;                            // (3 + band, rpa): prc rows 0, 1, 2, then the band's
    float* xr = prb + (3 + band) * rpa;           // (rpa,) x0rows
    float* zs = xr + rpa;                         // (3, nzl) zin
    float* rs = zs + ((3 * nzl + 3) & ~3);        // (4,) R
    float* hc = rs + 4;                           // (8, mp) rowc as structure of arrays
    float* ps = hc + 8 * mp;                      // (band, rp) the band's rows of psub
    float* subs = smem + csl_chain_smem_floats(mp, rp, band);   // (4, S) the controls
    float* coeff = subs + 4 * f.S;                // the recursion's (coeff.cuh)

    // The packing of ops/frame_kernel.py _pack_ctrl and _pack_meas.
    for (int k = tid; k < f.S; k += FS_THREADS) {
        subs[k] = f.vns[(size_t)k * f.vns_st];
        subs[f.S + k] = f.swans[(size_t)k * f.swans_st];
        subs[2 * f.S + k] = f.phis[(size_t)k * f.phis_st];
        subs[3 * f.S + k] = f.actives[(size_t)k * f.actives_st] ? 1.f : 0.f;
    }
    if (tid == 0) {   // chol(Q) in closed form; the intrinsics keep l10^2 unfused
        const float l00 = sqrtf(f.q_cov[0]);
        const float l10 = f.q_cov[2] / l00;
        qc[0] = l00;
        qc[1] = l10;
        qc[2] = sqrtf(fmaxf(__fsub_rn(f.q_cov[3], __fmul_rn(l10, l10)), 0.f));
    }
    for (int l = tid; l < nzl; l += FS_THREADS) {
        const bool m = l < f.nz && f.mask[(size_t)l * f.mask_st];
        zs[l] = m ? f.zr[(size_t)l * f.zr_st] : 0.f;
        zs[nzl + l] = m ? f.zb[(size_t)l * f.zb_st] : 0.f;
        zs[2 * nzl + l] = m ? 1.f : 0.f;
    }
    if (tid < 4) rs[tid] = f.r_cov[tid];
    __syncthreads();      // rows, subs and qc are complete

    // prc rows 0, 1, 2, x0rows and a band's slot rows, gathered from P and x
    // (inputs of the launch), in flight during the recursion.
    auto stage_slot_rows = [&](int b) {
        const int i0 = b * band, nb = min(band, mp - i0);
        const int sr = max(0, min(rp - 3 - i0, nb));
        for (int e = tid; e < sr * rp; e += FS_THREADS) {
            const int r = e / rp, c = e - r * rp;
            csl_cp_async4(prb + (3 + r) * rpa + c, f.p + (size_t)rows[3 + i0 + r] * f.d + rows[c], true);
        }
    };
    for (int e = tid; e < 3 * rp; e += FS_THREADS) {
        const int r = e / rp, c = e - r * rp;
        csl_cp_async4(prb + r * rpa + c, f.p + (size_t)r * f.d + rows[c], true);
    }
    for (int c = tid; c < rp; c += FS_THREADS) csl_cp_async4(xr + c, f.x + rows[c], true);
    stage_slot_rows(blockIdx.x);

    // The recursion and K4 on warp 0: p2h = P[2, 0:3], the pose = x[0:3].
    if (tid < 32)
        csl_chain_scalars(subs, f.S, qc, f.p + 2 * (size_t)f.d, f.x, f.wheel_base, f.dt,
                          f.sigma_heading * f.sigma_heading, f.use_heading != 0,
                          blockIdx.x == 0 ? f.pt : nullptr, nullptr, ms, coeff);
    csl_cp_async_commit();
    csl_cp_async_wait<0>();
    __syncthreads();
    if (blockIdx.x == 0 && tid < 32) f.ms[tid] = ms[tid];
    csl_chain_observe(ms, xr, prb + 2 * rpa, zs, hc, mp, rp);
    __syncthreads();
    for (int b = blockIdx.x; b < nbands; b += gridDim.x) {
        if (b != (int)blockIdx.x) {   // a grid smaller than the bands: the next band's rows
            __syncthreads();
            stage_slot_rows(b);
            csl_cp_async_commit();
            csl_cp_async_wait<0>();
            __syncthreads();
        }
        const int i0 = b * band;
        csl_chain_band(prb, rpa, hc, ms, zs, rs, ps, i0, min(band, mp - i0), mp, rp, f.s, f.rowc);
    }
}

// --- phase 2, block 0: S^-1 by the sweep, siv = v^T S^-1 and the NIS ---
template <int RX>
__device__ __forceinline__ void sweep_phase(const Frame& f, float* smem, int* wmax) {
    const int tid = threadIdx.x, mp = f.mp;
    // nblk = last valid slot + 1 (ops/frame_kernel.py _pack_meas).
    int nb = 0;
    for (int l = tid; l < f.nz; l += FS_THREADS)
        if (f.mask[(size_t)l * f.mask_st]) nb = l + 1;
    nb = __reduce_max_sync(0xffffffffu, nb);
    if ((tid & 31) == 0) wmax[tid >> 5] = nb;
    __syncthreads();
    nb = 0;
    for (int w = 0; w < FS_THREADS / 32; ++w) nb = max(nb, wmax[w]);
    csl_sweep::inverse<RX, true>(f.s, nb, f.si, mp, smem);
    __syncthreads();      // S^-1 is stored; the sweep's shared memory is free

    float* v = smem;      // (mp,) the innovation
    float* sv = v + mp;   // (mp,) siv
    for (int i = tid; i < mp; i += FS_THREADS) v[i] = __ldcg(f.rowc + 8 * i + 7);
    __syncthreads();
    for (int j = tid; j < mp; j += FS_THREADS) {
        float acc = 0.f;
#pragma unroll 8
        for (int i = 0; i < mp; ++i) acc += v[i] * __ldcg(f.si + (size_t)i * mp + j);
        sv[j] = acc;
        f.siv[j] = acc;
    }
    __syncthreads();
    if (tid < 32) {
        float s = 0.f;
        for (int j = tid; j < mp; j += 32) s += sv[j] * v[j];
        for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
        if (tid == 0) f.nis[0] = s;
    }
}

// --- phase 2, the other blocks: one 16-column panel of pht into G ---
__device__ __forceinline__ void pht_panel(const Frame& f, float* smem, const int* rows, int panel) {
    const int tid = threadIdx.x, mp = f.mp, rp = f.rp, nzl = mp / 2;
    float* rc = smem;                  // (mp, 8) rowc
    float* msh = rc + 8 * mp;          // (32,)
    float* pan = msh + 32;             // (rp, FS_LD) P[rows][:, c0 : c0 + FS_W]
    const int c0 = panel * FS_W;
    __syncthreads();                   // the shared memory's earlier readers are done
    stage_cg(rc, f.rowc, 8 * mp);
    stage_cg(msh, f.ms, 32);
    csl_stage_panel(pan, [&](int r) { return f.p + (size_t)rows[r] * f.d; }, rp, FS_W, FS_LD, c0,
                    f.d, f.vecp != 0);
    csl_cp_async_commit();
    csl_cp_async_wait<0>();
    __syncthreads();
    const int tx = tid % FS_W, ty = tid / FS_W, n = c0 + tx;
    const CslPanelColumn col = csl_panel_column(msh, pan[tx], pan[FS_LD + tx], pan[2 * FS_LD + tx], n);
    if (n >= f.ldg) return;
    for (int l = ty; l < nzl; l += FS_ROWG) {
        const int cx = 3 + 2 * l, cy = cx + 1;
        const float sx = cx < rp ? pan[cx * FS_LD + tx] : 0.f;
        const float sy = cy < rp ? pan[cy * FS_LD + tx] : 0.f;
        for (int k = 0; k < 2; ++k) {
            const int i = 2 * l + k;
            const float acc = csl_pht_entry(rc + 8 * i, col, sx, sy, cx < rp, cy < rp);
            f.g[(size_t)i * f.ldg + n] = n < f.d ? acc : 0.f;
        }
    }
}

// --- phase 3: the gains of 16-column panels: MG's -S^-1 pht, the K4 rows
//     of G and MG, and the mean ---
template <int RX>
__device__ __forceinline__ void gain_phase(const Frame& f, float* smem) {
    constexpr int KR = (32 * RX + FS_THREADS / FS_COLG - 1) / (FS_THREADS / FS_COLG);
    const int tid = threadIdx.x, mp = f.mp, ldg = f.ldg, sl = mp + 4;
    const int npanel = (ldg + FS_W - 1) / FS_W;
    if ((int)blockIdx.x >= npanel) return;
    float* si_s = smem;                // (mp, mp + 4) S^-1: rows 4 floats apart in the banks
    float* pht_s = si_s + mp * sl;     // (mp, FS_W) the panel of pht
    float* part = pht_s + mp * FS_W;   // (FS_THREADS,) partial sums
    float* siv_s = part + FS_THREADS;  // (mp,)
    float* msh = siv_s + mp;           // (32,)
    for (int e = tid; e < mp * (mp / 4); e += FS_THREADS) {
        const int i = e / (mp / 4), c = 4 * (e % (mp / 4));
        csl_cp_async16(si_s + i * sl + c, f.si + (size_t)i * mp + c, true);
    }
    stage_cg(siv_s, f.siv, mp);
    stage_cg(msh, f.ms, 32);
    for (int panel = blockIdx.x; panel < npanel; panel += gridDim.x) {
        const int c0 = panel * FS_W;
        __syncthreads();               // the last panel's readers are done
        for (int e = tid; e < mp * FS_COLG; e += FS_THREADS) {
            const int i = e / FS_COLG, c = 4 * (e % FS_COLG);
            const bool in = c0 + c < ldg;   // ldg % 4 == 0: four columns all in or all out
            csl_cp_async16(pht_s + i * FS_W + c, in ? f.g + (size_t)i * ldg + c0 + c : f.g, in);
        }
        csl_cp_async_commit();
        csl_cp_async_wait<0>();
        __syncthreads();

        // MG rows k = rg + 128 m: -sum_i S^-1[k, i] pht[i, c0 + 4 cg + (0..3)],
        // one fmaf chain over i in order.
        {
            const int cg4 = tid % FS_COLG, rg = tid / FS_COLG;
            float acc[KR][4];
            int krow[KR];
#pragma unroll
            for (int m = 0; m < KR; ++m) {
                krow[m] = min(rg + m * (FS_THREADS / FS_COLG), mp - 1);
#pragma unroll
                for (int q = 0; q < 4; ++q) acc[m][q] = 0.f;
            }
#pragma unroll 4
            for (int i = 0; i < mp; ++i) {
                const float4 pv = *reinterpret_cast<const float4*>(pht_s + i * FS_W + 4 * cg4);
#pragma unroll
                for (int m = 0; m < KR; ++m) {
                    const float sv = si_s[krow[m] * sl + i];
                    acc[m][0] = fmaf(sv, pv.x, acc[m][0]);
                    acc[m][1] = fmaf(sv, pv.y, acc[m][1]);
                    acc[m][2] = fmaf(sv, pv.z, acc[m][2]);
                    acc[m][3] = fmaf(sv, pv.w, acc[m][3]);
                }
            }
            const int n4 = c0 + 4 * cg4;
#pragma unroll
            for (int m = 0; m < KR; ++m) {
                const int k = rg + m * (FS_THREADS / FS_COLG);
                if (k < mp && n4 < ldg)
                    *reinterpret_cast<float4*>(f.mg + (size_t)k * ldg + n4) =
                        make_float4(-acc[m][0], -acc[m][1], -acc[m][2], -acc[m][3]);
            }
        }

        const int tx = tid % FS_W, ty = tid / FS_W, n = c0 + tx;
        float xs = 0.f;
        for (int i = ty; i < mp; i += FS_ROWG) xs += siv_s[i] * pht_s[i * FS_W + tx];
        part[tid] = xs;
        const float p2 = n < f.d ? f.p[2 * (size_t)f.d + n] : 0.f;
        // G rows mp .. mp + 7 = [p2; e0; e1; e2; 0], MG's = K4 [p2; e0; e1; e2]
        // = [wrow; g_r p2 + m3[r, :]; 0].
        if (ty < 8 && n < ldg) {
            float gv = 0.f, mv = 0.f;
            if (ty == 0) {
                gv = p2;
                mv = csl_panel_column(msh, 0.f, 0.f, p2, n).wrow;
            } else if (ty < 4) {
                const int r = ty - 1;
                gv = n == r ? 1.f : 0.f;
                mv = msh[5 + r] * p2 + (n < 3 ? msh[8 + 3 * r + n] : 0.f);
            }
            f.g[(size_t)(mp + ty) * ldg + n] = gv;
            f.mg[(size_t)(mp + ty) * ldg + n] = mv;
        }
        __syncthreads();
        if (ty == 0 && n < f.d) {
            float s = 0.f;
            for (int r = 0; r < FS_ROWG; ++r) s += part[r * FS_W + tx];
            const float base = n < 3 ? msh[n] : f.x[n] + p2 * msh[3];
            const float v = base + s;
            f.xn[n] = n == 2 ? csl_wrap(v) : v;
        }
    }
}

// --- phase 4: out = P + G^T MG over the upper-triangle tiles, mirrored ---
template <bool VECP>
__device__ __forceinline__ void p_pass(const Frame& f, float* smem) {
    const int group = threadIdx.x / FS_GROUP, gtid = threadIdx.x % FS_GROUP;
    float* ring = smem + group * csl_rank::Cfg<FS_TILE>::SMEM_FLOATS;
    const int nt = (f.d + FS_TILE - 1) / FS_TILE, ntiles = nt * (nt + 1) / 2;
    const csl_rank::GroupSync sync{1 + group, FS_GROUP};
    for (int t = blockIdx.x * FS_GROUPS + group; t < ntiles; t += gridDim.x * FS_GROUPS) {
        int ti, tj;
        csl_rank::tile_ij(t, nt, &ti, &tj);
        csl_rank::tile<FS_TILE, true, VECP>(f.p, f.g, f.mg, f.p_out, f.d, f.ldg, f.mp + 8,
                                           ti * FS_TILE, tj * FS_TILE, ring, gtid, sync);
    }
}

template <int RX>
__global__ void __launch_bounds__(FS_THREADS, 1)
frame_step_kernel(const __grid_constant__ Frame f) {
    extern __shared__ __align__(16) float smem[];
    __shared__ int rows[FS_MAX_RP];
    __shared__ float qc[4];
    __shared__ float ms[32];
    __shared__ int wmax[FS_THREADS / 32];
    cg::grid_group grid = cg::this_grid();
    stamp(f, 0, false);
    for (int a = threadIdx.x; a < f.rp; a += FS_THREADS) rows[a] = gathered_row(f, a);

    // Every block reaches every grid barrier: no phase returns from the kernel.
    if ((int)blockIdx.x < (f.mp + f.band - 1) / f.band) chain_phase(f, smem, rows, qc, ms);
    stamp(f, 1, true);
    grid.sync();
    stamp(f, 2, false);

    if (blockIdx.x == 0) sweep_phase<RX>(f, smem, wmax);
    if (blockIdx.x > 0 || gridDim.x == 1) {
        const int workers = gridDim.x > 1 ? gridDim.x - 1 : 1;
        const int first = gridDim.x > 1 ? blockIdx.x - 1 : 0;
        for (int panel = first; panel < (f.ldg + FS_W - 1) / FS_W; panel += workers)
            pht_panel(f, smem, rows, panel);
    }
    stamp(f, 3, true);
    grid.sync();
    stamp(f, 4, false);

    gain_phase<RX>(f, smem);
    stamp(f, 5, true);
    grid.sync();
    stamp(f, 6, false);

    if (f.vecp) p_pass<true>(f, smem);
    else p_pass<false>(f, smem);
    stamp(f, 7, true);
}

// Dynamic shared memory (bytes): the largest of the phases' needs (the
// chain's with the controls and the recursion's, sized by S).
size_t smem_bytes(int mp, int rp, int band, int S) {
    const int w = 32 * ((mp + 31) / 32);
    size_t fl = (size_t)(csl_chain_smem_floats(mp, rp, band) + 4 * S + csl_coeff_smem_floats(S));
    fl = std::max(fl, csl_sweep::smem_bytes(mp, w) / sizeof(float));
    fl = std::max(fl, (size_t)(8 * mp + 32 + rp * FS_LD));
    fl = std::max(fl, (size_t)(mp * (mp + 4) + mp * FS_W + FS_THREADS + mp + 32));
    fl = std::max(fl, (size_t)FS_GROUPS * csl_rank::Cfg<FS_TILE>::SMEM_FLOATS);
    return fl * sizeof(float);
}

constexpr int MAX_DEVICES = 64;
constexpr int VARIANTS = FS_MAX_MP / 32;      // RX = 1 .. 7

// Per device, cached on first use: the SM count, and each variant's static
// shared memory (its dynamic cap raised once) and its last occupancy query.
struct DeviceInfo {
    int sms = 0;
    int static_bytes[VARIANTS + 1] = {};
    bool raised[VARIANTS + 1] = {};
    size_t occ_smem[VARIANTS + 1] = {};
    int occ[VARIANTS + 1] = {};
};
DeviceInfo g_info[MAX_DEVICES];

// The grid of variant RX at `smem` dynamic bytes: one block an SM, after
// checking that a block of FS_THREADS fits an SM at all (the cooperative
// launch needs every block resident).
template <int RX>
cudaError_t plan(size_t smem, int* grid) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
    DeviceInfo& info = g_info[dev];
    if (info.sms == 0) {
        int coop = 0;
        err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
        if (err == cudaSuccess && !coop) err = cudaErrorCooperativeLaunchTooLarge;
        if (err == cudaSuccess) err = cudaDeviceGetAttribute(&info.sms, cudaDevAttrMultiProcessorCount, dev);
        if (err != cudaSuccess) return err;
    }
    const auto fn = frame_step_kernel<RX>;
    if (!info.raised[RX]) {
        cudaFuncAttributes attr;
        err = cudaFuncGetAttributes(&attr, fn);
        if (err != cudaSuccess) return err;
        info.static_bytes[RX] = (int)attr.sharedSizeBytes;
        err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   CSL_MAX_SMEM - (int)attr.sharedSizeBytes);
        if (err != cudaSuccess) return err;
        info.raised[RX] = true;
    }
    if (smem + info.static_bytes[RX] > CSL_MAX_SMEM) return cudaErrorInvalidValue;
    if (info.occ_smem[RX] != smem) {
        int occ = 0;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, FS_THREADS, smem);
        if (err != cudaSuccess) return err;
        info.occ[RX] = occ;
        info.occ_smem[RX] = smem;
    }
    if (info.occ[RX] < 1) return cudaErrorCooperativeLaunchTooLarge;
    *grid = info.sms;
    return cudaSuccess;
}

template <int RX>
cudaError_t launch(const Frame& f, cudaStream_t stream) {
    const size_t smem = smem_bytes(f.mp, f.rp, f.band, f.S);
    int grid = 0;
    cudaError_t err = plan<RX>(smem, &grid);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(FS_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, frame_step_kernel<RX>, f);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

template <int RX>
cudaError_t plan_only(int mp, int rp, int band, int S, int* grid, int* smem) {
    const size_t bytes = smem_bytes(mp, rp, band, S);
    *smem = (int)bytes;
    return plan<RX>(bytes, grid);
}

}  // namespace

// The grid, block and dynamic shared memory of a launch at (mp, rp, band,
// S) on the current device; launches nothing.
extern "C" int csl_frame_step_plan(int mp, int rp, int band, int S, int* grid, int* block,
                                   int* smem) {
    if (mp <= 0 || mp % 32 || mp > FS_MAX_MP || rp < 3 || rp > FS_MAX_RP || band <= 0 ||
        band % 2 || S <= 0 || S > CSL_MAX_STEPS)
        return (int)cudaErrorInvalidValue;
    *block = FS_THREADS;
    switch (mp / 32) {
        case 1: return (int)plan_only<1>(mp, rp, band, S, grid, smem);
        case 2: return (int)plan_only<2>(mp, rp, band, S, grid, smem);
        case 3: return (int)plan_only<3>(mp, rp, band, S, grid, smem);
        case 4: return (int)plan_only<4>(mp, rp, band, S, grid, smem);
        case 5: return (int)plan_only<5>(mp, rp, band, S, grid, smem);
        case 6: return (int)plan_only<6>(mp, rp, band, S, grid, smem);
        default: return (int)plan_only<7>(mp, rp, band, S, grid, smem);
    }
}

// One frame: see the top of this file.  slots int64, actives and mask bool
// (one byte); the 1-D inputs with their strides in elements; q_cov, r_cov
// (2, 2), p (d, d) and x (d,) contiguous; scratch of 2 mp^2 + 9 mp + 32 +
// 2 (mp + 8) ldg floats, 16-byte aligned: S, S^-1, rowc, ms, siv, G, MG
// (ops/frame_kernel.py _frame_step_scratch_floats); stamps null, or
// (grid, 8) for each block's phase times (see stamp()).  mp =
// 2 nz rounded up to 32, rp = 3 + 2 nz rounded up to 8, ldg = d rounded up
// to 4, band = the chain plan's rows a block.
extern "C" int csl_frame_step(const float* p, const float* x, const long long* slots,
                              const float* vns, const float* swans, const float* phis,
                              const unsigned char* actives, const float* q_cov, const float* zr,
                              const float* zb, const unsigned char* mask, const float* r_cov,
                              float* p_out, float* xn, float* pt, float* nis, float* scratch,
                              unsigned long long* stamps, int slots_st, int vns_st,
                              int swans_st, int phis_st, int actives_st, int zr_st, int zb_st, int mask_st, int d, int nz, int S, int cap,
                              int mp, int rp, int ldg, int band, float wheel_base, float dt,
                              float sigma_heading, int use_heading, void* stream) {
    if (d < 3 || nz <= 0 || S <= 0 || S > CSL_MAX_STEPS || cap <= 0 || mp % 32 || mp < 2 * nz ||
        mp > FS_MAX_MP || rp < 3 + 2 * nz || rp > FS_MAX_RP || ldg < d || ldg % 4 || band <= 0 ||
        band % 2 || (reinterpret_cast<size_t>(scratch) & 15u))
        return (int)cudaErrorInvalidValue;
    Frame f;
    f.p = p;
    f.x = x;
    f.slots = slots;
    f.vns = vns;
    f.swans = swans;
    f.phis = phis;
    f.actives = actives;
    f.q_cov = q_cov;
    f.zr = zr;
    f.zb = zb;
    f.mask = mask;
    f.r_cov = r_cov;
    f.p_out = p_out;
    f.xn = xn;
    f.pt = pt;
    f.nis = nis;
    f.s = scratch;
    f.si = f.s + (size_t)mp * mp;
    f.rowc = f.si + (size_t)mp * mp;
    f.ms = f.rowc + 8 * (size_t)mp;
    f.siv = f.ms + 32;
    f.g = f.siv + mp;
    f.mg = f.g + (size_t)(mp + 8) * ldg;
    f.stamps = stamps;
    f.slots_st = slots_st;
    f.vns_st = vns_st;
    f.swans_st = swans_st;
    f.phis_st = phis_st;
    f.actives_st = actives_st;
    f.zr_st = zr_st;
    f.zb_st = zb_st;
    f.mask_st = mask_st;
    f.d = d;
    f.nz = nz;
    f.S = S;
    f.cap = cap;
    f.mp = mp;
    f.rp = rp;
    f.ldg = ldg;
    f.band = band;
    f.vecp = d % 4 == 0 && !(reinterpret_cast<size_t>(p) & 15u) &&
             !(reinterpret_cast<size_t>(p_out) & 15u);
    f.wheel_base = wheel_base;
    f.dt = dt;
    f.sigma_heading = sigma_heading;
    f.use_heading = use_heading;
    const cudaStream_t st = (cudaStream_t)stream;
    switch (mp / 32) {
        case 1: return (int)launch<1>(f, st);
        case 2: return (int)launch<2>(f, st);
        case 3: return (int)launch<3>(f, st);
        case 4: return (int)launch<4>(f, st);
        case 5: return (int)launch<5>(f, st);
        case 6: return (int)launch<6>(f, st);
        default: return (int)launch<7>(f, st);
    }
}
