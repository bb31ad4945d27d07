// H10 obs_step's device code and its plan and launch templates, shared by
// obs_step.cu (the C entries, the frame kernel's variants and the P pass on
// tiles of 32) and obs_step_big.cu (the P pass on tiles of 128), which
// compile apart, in parallel.  See obs_step.cu for what H10 computes and
// its design.
#pragma once

#include <cooperative_groups.h>

#include <algorithm>

#include "obs_band.cuh"
#include "panel.cuh"
#include "resident.cuh"
#include "sweep.cuh"

namespace cg = cooperative_groups;

#define OS_THREADS 512      // 16 warps: H1's sweep layout (csl_sweep::NT)
#define OS_COLS 8           // columns of a unit's column group (a unit is 1 to 4 of them)
#define OS_MAX_UNIT 32      // the most columns of D a block takes through phases 2 and 3
#define OS_BAND 2           // measurement rows a chain band: one measurement
#define OS_MAX_MP 224       // H1's register limit: 7 x 7 elements a thread
#define OS_MAX_RP 232       // gathered rows at MP = 224
#define OS_XG 32            // the mean's partial fmaf chains a column, summed in order
#define OS_MG_WARPS 8       // the gains' warps that form MG; the other 8 form siv and the mean
#define OS_STAMPS 12        // stamps a block (stamp())
#define OS_PLAN 14          // values csl_obs_step_plan reports

namespace csl_h10 {

static_assert(OS_THREADS == csl_sweep::NT, "one block size for every phase of the frame kernel");
constexpr int OS_ROWG = OS_THREADS / OS_COLS;        // row groups of a unit's column group
// The frame kernel's static shared memory: rows, a max per warp.
constexpr int OS_STATIC_BYTES = 4 * (OS_MAX_RP + OS_THREADS / 32);

// The frame: inputs, outputs, the scratch carved by the host, strides (in
// elements) of the 1-D inputs, shapes.
struct Frame {
    const float* p;                 // (d, d)
    const float* x;                 // (d,)   the post-factor mean
    const long long* slots;         // (nz,)
    const float* zr;                // (nz,)
    const float* zb;                // (nz,)
    const unsigned char* mask;      // (nz,) bool
    const float* r_cov;             // (2, 2)
    const float* bmat;              // (nbp, nbp)
    const float* vtf;               // (nbp, d)
    float* p_out;                   // (d, d)
    float* xn;                      // (d,)
    float* nis;                     // (1,)
    float* s;                       // (mp, mp)  S
    float* si;                      // (mp, mp)  S^-1
    float* rowc;                    // (mp, 8)   compact Hc and v
    float* hvb;                     // (mp, nbp) the coupling (Hc vrows^T) B
    float* siv;                     // (mp,)
    float* g;                       // (nbp + mp, ldg)  G = [vtf; pht]
    float* mg;                      // (nbp + mp, ldg)  M G = [B vtf; -S^-1 pht]
    unsigned long long* stamps;     // (grid + pass grid, OS_STAMPS) phase times, or null
    int slots_st, zr_st, zb_st, mask_st;
    int d, nz, cap, mp, rp, nbp, ldg;
    int unit;                       // columns of D a block takes at a time (unit_cols)
    int vecp;                       // P's rows and vtf's take 16-byte accesses
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

// The frame kernel's block b writes its %globaltimer (ns) into stamps[b, k]
// when the caller asked for them: k = 0 the start, 1 the chain done, 2 past
// barrier 1, 3 block 0's sweep done or another block's pht units done, 4
// block 0's siv and NIS done (phase 3), 5 past barrier 2, 6 the gains done,
// 9 its first unit's S^-1 in shared memory, 10 that unit's MG stored (warp
// 0's items), 11 that unit's siv formed; block 0 also its SM's clock64 at
// 7 the sweep's start and 8 its end (cycles over ns: the SM clock during
// the sweep).  The P pass's block b writes stamps[grid + b, 0] as it starts
// its tiles and [grid + b, 1] when done.  A "done" stamp waits for the
// whole block first.
__device__ __forceinline__ void stamp(const Frame& f, int k, bool done) {
    if (f.stamps == nullptr) return;
    if (done) __syncthreads();
    if (threadIdx.x == 0) f.stamps[(size_t)blockIdx.x * OS_STAMPS + k] = csl_res::globaltimer();
}

__device__ __forceinline__ void stamp_clock(const Frame& f, int k) {
    if (f.stamps != nullptr && threadIdx.x == 0) f.stamps[k] = clock64();
}

// n floats (n % 4 == 0, 16-byte aligned ends) written earlier in this
// launch, into shared memory through L2 (cp.async.cg).
__device__ __forceinline__ void stage_cg(float* dst, const float* src, int n) {
    for (int e = 4 * threadIdx.x; e < n; e += 4 * OS_THREADS) csl_cp_async16(dst + e, src + e, true);
}

// --- phase 1: the chain, one band of measurement rows a block ---
__device__ __forceinline__ void chain_phase(const Frame& f, float* smem, const int* rows) {
    const int tid = threadIdx.x;
    const int mp = f.mp, rp = f.rp, nzl = mp / 2, nbp = f.nbp;
    const int nbands = mp / OS_BAND;
    const CslObsSmem sm(smem, mp, rp, nbp, OS_BAND);

    // The packing of ops/frame_kernel.py _pack_meas.
    for (int l = tid; l < nzl; l += OS_THREADS) {
        const bool m = l < f.nz && f.mask[(size_t)l * f.mask_st];
        sm.zs[l] = m ? f.zr[(size_t)l * f.zr_st] : 0.f;
        sm.zs[nzl + l] = m ? f.zb[(size_t)l * f.zb_st] : 0.f;
        sm.zs[2 * nzl + l] = m ? 1.f : 0.f;
    }
    if (tid < 4) sm.rs[tid] = f.r_cov[tid];

    // x[rows], prc rows 0, 1, 2 and a band's slot rows, gathered from x and
    // P (inputs of the launch).
    auto stage_slot_rows = [&](int b) {
        const int i0 = b * OS_BAND, nb = min(OS_BAND, mp - i0);
        const int sr = max(0, min(rp - 3 - i0, nb));
        for (int e = tid; e < sr * rp; e += OS_THREADS) {
            const int r = e / rp, c = e - r * rp;
            csl_cp_async4(sm.prb + (3 + r) * sm.rpa + c,
                          f.p + (size_t)rows[3 + i0 + r] * f.d + rows[c], true);
        }
    };
    for (int e = tid; e < 3 * rp; e += OS_THREADS) {
        const int r = e / rp, c = e - r * rp;
        csl_cp_async4(sm.prb + r * sm.rpa + c, f.p + (size_t)r * f.d + rows[c], true);
    }
    for (int c = tid; c < rp; c += OS_THREADS) csl_cp_async4(sm.xr + c, f.x + rows[c], true);
    stage_slot_rows(blockIdx.x);
    csl_cp_async_commit();
    csl_cp_async_wait<0>();
    __syncthreads();
    csl_obs_observe(sm.xr, sm.zs, sm.hc, mp, rp);
    __syncthreads();
    const float* vtf = f.vtf;
    const float* bmat = f.bmat;
    const int d = f.d;
    for (int b = blockIdx.x; b < nbands; b += gridDim.x) {
        if (b != (int)blockIdx.x) {   // a grid smaller than the bands: the next band's rows
            __syncthreads();
            stage_slot_rows(b);
            csl_cp_async_commit();
            csl_cp_async_wait<0>();
            __syncthreads();
        }
        csl_obs_band(sm.prb, sm.rpa, sm.hc, sm.zs, sm.rs, sm.hvm, sm.hvb, sm.ps, b * OS_BAND,
                     min(OS_BAND, mp - b * OS_BAND), mp, rp, nbp,
                     [&](int k, int c) { return __ldg(vtf + (size_t)k * d + rows[c]); },
                     [&](int k, int c) { return __ldg(bmat + (size_t)k * nbp + c); }, f.s, f.rowc,
                     f.hvb);
    }
}

// --- phase 2, the other blocks: one unit of U = f.unit columns of D (U a
//     multiple of OS_COLS): pht = Hc P[rows] + hvb vtf into G and into
//     shared memory (kept for phase 3), and the unit's vtf rows of G and
//     B vtf rows of MG, which need no S^-1.  `staged`: rowc and hvb are in
//     shared memory already (the block's earlier unit) ---
__device__ __forceinline__ void pht_unit(const Frame& f, float* smem, const int* rows, int unit,
                                         bool staged) {
    const int tid = threadIdx.x, mp = f.mp, rp = f.rp, nbp = f.nbp, ldg = f.ldg, d = f.d;
    const int u = f.unit, pl = u + 4;
    float* pht_s = smem;               // (mp, pl) the unit's pht
    float* rc = pht_s + mp * pl;       // (mp, 8) rowc
    float* hv = rc + 8 * mp;           // (mp, nbp) hvb
    float* pan = hv + mp * nbp;        // (rp, pl) P[rows][:, c0 : c0 + u]
    float* vp = pan + rp * pl;         // (nbp, u) vtf[:, c0 : c0 + u]
    const int c0 = unit * u;
    __syncthreads();                   // the shared memory's earlier readers are done
    if (!staged) {
        stage_cg(rc, f.rowc, 8 * mp);
        stage_cg(hv, f.hvb, mp * nbp);
    }
    csl_stage_panel(pan, [&](int r) { return f.p + (size_t)rows[r] * d; }, rp, u, pl, c0, d,
                    f.vecp != 0);
    csl_stage_panel(vp, [&](int b) { return f.vtf + (size_t)b * d; }, nbp, u, u, c0, d,
                    f.vecp != 0);
    csl_cp_async_commit();
    csl_cp_async_wait<0>();
    __syncthreads();
    const int tx = tid % OS_COLS, ty = tid / OS_COLS;
    for (int q = 0; q < u / OS_COLS; ++q) {
        const int col = OS_COLS * q + tx, n = c0 + col;
        const float p0 = pan[col], p1 = pan[pl + col], p2 = pan[2 * pl + col];
        for (int i = ty; i < mp; i += OS_ROWG) {
            const float* h = rc + 8 * i;
            const float* hb = hv + i * nbp;
            const int cx = 3 + 2 * (i / 2), cy = cx + 1;
            float acc = h[0] * p0 + h[1] * p1 + h[2] * p2;
            if (cx < rp) acc += h[3] * pan[cx * pl + col];
            if (cy < rp) acc += h[4] * pan[cy * pl + col];
            float cpl = 0.f;
            for (int b = 0; b < nbp; ++b) cpl += hb[b] * vp[b * u + col];
            acc += cpl;
            const float v = n < d ? acc : 0.f;
            pht_s[i * pl + col] = v;
            if (n < ldg) f.g[(size_t)(nbp + i) * ldg + n] = v;
        }
        if (n >= ldg) continue;
        // G rows b < nbp: vtf (zero past column d); MG's: (B vtf)[b, n] =
        // sum_j B[b, j] vtf[j, n], one fmaf chain over j in order (B an
        // input of the launch, read through L1).
        for (int b = ty; b < nbp; b += OS_ROWG) {
            f.g[(size_t)b * ldg + n] = vp[b * u + col];
            float acc = 0.f;
            for (int j = 0; j < nbp; ++j)
                acc = fmaf(__ldg(f.bmat + (size_t)b * nbp + j), vp[j * u + col], acc);
            f.mg[(size_t)b * ldg + n] = acc;
        }
    }
}

// MG rows nbp + k, k = 32 rb + lane, over the unit's columns W cg .. W cg +
// W - 1, for the items it = w, w + mw, ... of RX row blocks x the unit's
// W-column groups: acc[q] = sum_i S^-1[i, k] pht[i, W cg + q], one fmaf
// chain over i in order, over each 32-row chunk of S^-1 as it lands (S^-1
// is exactly symmetric, so its row i gives column i: a warp's 32 rows read
// 32 consecutive floats, the item's W pht values are a broadcast).
template <int RX, int W>
__device__ __forceinline__ void mg_items(const Frame& f, const float* si_s, const float* pht_s,
                                         int c0, int w, int mw, bool first,
                                         unsigned long long* bar) {
    const int lane = threadIdx.x & 31, mp = f.mp, ldg = f.ldg, pl = f.unit + 4;
    const int groups = f.unit / W, items = RX * groups;
#pragma unroll 1
    for (int it = w; it < items; it += mw) {
        const int rb = it / groups, cg = it - rb * groups, k = 32 * rb + lane;
        float acc[W];
#pragma unroll
        for (int q = 0; q < W; ++q) acc[q] = 0.f;
#pragma unroll
        for (int c = 0; c < RX; ++c) {
            csl_res::bulk_wait(bar + c);   // chunk c of S^-1 landed
            if (first && c == 0 && it == w) stamp(f, 9, false);
#pragma unroll 4
            for (int i = 32 * c; i < 32 * c + 32; ++i) {
                const float sv = si_s[i * mp + k];
#pragma unroll
                for (int q4 = 0; q4 < W / 4; ++q4) {
                    const float4 a = *reinterpret_cast<const float4*>(pht_s + i * pl + W * cg + 4 * q4);
                    acc[4 * q4] = fmaf(sv, a.x, acc[4 * q4]);
                    acc[4 * q4 + 1] = fmaf(sv, a.y, acc[4 * q4 + 1]);
                    acc[4 * q4 + 2] = fmaf(sv, a.z, acc[4 * q4 + 2]);
                    acc[4 * q4 + 3] = fmaf(sv, a.w, acc[4 * q4 + 3]);
                }
            }
        }
        float* row = f.mg + (size_t)(f.nbp + k) * ldg + c0 + W * cg;
#pragma unroll
        for (int q4 = 0; q4 < W / 4; ++q4)
            if (c0 + W * cg + 4 * q4 < ldg)   // ldg % 4 == 0: four columns all in or all out
                *reinterpret_cast<float4*>(row + 4 * q4) =
                    make_float4(-acc[4 * q4], -acc[4 * q4 + 1], -acc[4 * q4 + 2], -acc[4 * q4 + 3]);
    }
}

// --- phase 3: each unit's MG rows -S^-1 pht and mean, last unit first (its
//     pht still in shared memory from phase 2) ---
//
// S^-1 comes into shared memory by the tensor memory accelerator, in bulk
// copies of 32 rows, one mbarrier each (issued by one thread), and MG runs
// over each chunk as it lands (mg_items).  For the first unit MG runs on
// OS_MG_WARPS warps while the other warps form siv = v^T S^-1 from the same
// S^-1, also as it lands (block 0's bits), and the mean's OS_XG partial
// chains a column; for every later unit all 16 warps take MG's items, then
// the mean's partials.  The items are 32 rows x 8 columns, or x 4 where
// that leaves an MG warp without one (at config 2: 8 columns, MP 128).
// The partials are summed in order: xn = x + siv pht, heading wrapped.
template <int RX>
__device__ __forceinline__ void gain_phase(const Frame& f, float* smem) {
    constexpr int MW = OS_MG_WARPS;
    constexpr int XT = OS_THREADS - 32 * MW;               // siv's and the mean's threads
    static_assert(XT >= OS_MAX_MP, "siv takes a thread a column");
    const int tid = threadIdx.x, w = tid >> 5;
    const int mp = f.mp, ldg = f.ldg, nbp = f.nbp, u = f.unit, pl = u + 4;
    const csl_res::Units us = csl_res::block_units((ldg + u - 1) / u);
    if (us.last < 0) return;
    float* pht_s = smem;               // (mp, pl)
    float* si_s = pht_s + mp * pl;     // (mp, mp) S^-1
    float* part = si_s + mp * mp;      // (OS_XG, u) the mean's partial sums
    float* v_s = part + OS_XG * u;     // (mp,) the innovation
    float* siv_s = v_s + mp;           // (mp,)
    unsigned long long* bar = reinterpret_cast<unsigned long long*>(siv_s + mp);   // (RX,)
    if (tid == 0) csl_res::bulk_load_si<RX>(si_s, f.si, mp, bar);
    for (int i = tid; i < mp; i += OS_THREADS) v_s[i] = __ldcg(f.rowc + 8 * i + 7);
    // The mean's partial chains of columns e % u, i = e / u, e / u + OS_XG, ...
    auto mean_partials = [&](int first_e, int stride) {
        for (int e = first_e; e < OS_XG * u; e += stride) {
            const int g = e / u, col = e - g * u;
            float xs = 0.f;
            for (int i = g; i < mp; i += OS_XG) xs = fmaf(siv_s[i], pht_s[i * pl + col], xs);
            part[g * u + col] = xs;
        }
    };
#pragma unroll 1
    for (int unit = us.last; unit >= us.first; unit -= us.workers) {
        const bool first = unit == us.last;   // its pht is in shared memory
        const int c0 = unit * u;
        if (!first) {                  // another unit's pht, from G
            __syncthreads();           // the last unit's readers are done
            for (int e = tid; e < mp * (u / 4); e += OS_THREADS) {
                const int i = e / (u / 4), c = 4 * (e % (u / 4));
                const bool in = c0 + c < ldg;   // ldg % 4 == 0: four columns all in or all out
                csl_cp_async16(pht_s + i * pl + c, in ? f.g + (size_t)(nbp + i) * ldg + c0 + c : f.g,
                               in);
            }
            csl_cp_async_commit();
        }
        // The mean's base: an input of the launch, read while the copies fly.
        const float xv = tid < u && c0 + tid < f.d ? f.x[c0 + tid] : 0.f;
        csl_cp_async_wait<0>();        // another unit's pht
        __syncthreads();               // and v, and the mbarriers are initialised
        const int mw = first ? MW : OS_THREADS / 32;
        if (w < mw) {
            if (RX * (u / 8) < mw) mg_items<RX, 4>(f, si_s, pht_s, c0, w, mw, first, bar);
            else mg_items<RX, 8>(f, si_s, pht_s, c0, w, mw, first, bar);
            if (first) stamp(f, 10, false);
        } else {
            // siv_j = sum_i v_i S^-1[i, j], one fmaf chain over i in order (as
            // csl_res::siv_chain: block 0's bits), over each chunk as it lands.
            const int j = tid - 32 * MW;
            float acc = 0.f;
#pragma unroll
            for (int c = 0; c < RX; ++c) {
                csl_res::bulk_wait(bar + c);
                if (j < mp)
#pragma unroll 8
                    for (int i = 32 * c; i < 32 * c + 32; ++i) acc = fmaf(v_s[i], si_s[i * mp + j], acc);
            }
            if (j < mp) siv_s[j] = acc;
            // siv is complete: a barrier of the XT threads past MG's.
            asm volatile("bar.sync 1, %0;\n" ::"n"(XT) : "memory");
            if (f.stamps != nullptr && tid == 32 * MW)
                f.stamps[(size_t)blockIdx.x * OS_STAMPS + 11] = csl_res::globaltimer();
            mean_partials(tid - 32 * MW, XT);
        }
        if (!first) mean_partials(tid, OS_THREADS);   // siv was formed with the first unit
        __syncthreads();
        if (tid < u && c0 + tid < f.d) {
            const int n = c0 + tid;
            float s = 0.f;
            for (int r = 0; r < OS_XG; ++r) s += part[r * u + tid];
            const float v = xv + s;
            f.xn[n] = n == 2 ? csl_wrap(v) : v;
        }
    }
}

template <int RX>
__global__ void __launch_bounds__(OS_THREADS, 1)
obs_step_kernel(const __grid_constant__ Frame f) {
    extern __shared__ __align__(16) float smem[];
    __shared__ int rows[OS_MAX_RP];
    __shared__ int wmax[OS_THREADS / 32];
    cg::grid_group grid = cg::this_grid();
    stamp(f, 0, false);
    for (int a = threadIdx.x; a < f.rp; a += OS_THREADS) rows[a] = gathered_row(f, a);
    // Block 0 finds the sweep's nblk now, off its path past barrier 1.
    const int nb = blockIdx.x == 0 ? csl_res::last_valid_slot<OS_THREADS>(f.mask, f.mask_st, f.nz, wmax)
                                   : 0;
    __syncthreads();

    // Every block reaches both grid barriers: no phase returns from the
    // kernel before barrier 2.
    if ((int)blockIdx.x < f.mp / OS_BAND) chain_phase(f, smem, rows);
    stamp(f, 1, true);
    grid.sync();
    stamp(f, 2, false);

    // Phase 2: block 0 sweeps, and nothing else; every other block takes its
    // units of pht.
    bool bad = false;
    if (blockIdx.x == 0) {
        stamp_clock(f, 7);
        bad = csl_sweep::inverse<RX, true>(f.s, nb, f.si, f.mp, smem);
        stamp_clock(f, 8);
    } else {
        const csl_res::Units us = csl_res::block_units((f.ldg + f.unit - 1) / f.unit);
        for (int unit = us.first; unit >= 0 && unit <= us.last; unit += us.workers)
            pht_unit(f, smem, rows, unit, unit != us.first);
    }
    stamp(f, 3, true);
    grid.sync();
    // The P pass may launch now; it waits for this kernel's end to read G
    // and MG (griddepcontrol.wait).
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
    stamp(f, 5, false);

    // Phase 3: the gains, and block 0's siv and NIS beside them (off the
    // critical path: no block waits for it).
    if (blockIdx.x == 0) {
        float* v = smem + csl_sweep::smem_bytes(f.mp, 32 * RX) / sizeof(float);   // past the tile
        csl_res::swept_siv_nis<RX, OS_THREADS>(smem, f.mp, f.rowc, v, v + f.mp, bad, f.siv, f.nis);
        stamp(f, 4, true);
    } else {
        gain_phase<RX>(f, smem);
    }
    stamp(f, 6, true);
}

// --- the second launch: the P pass on route R (csl_res::pass_tiles;
//     obs_pass_kernel<PASS_32, *> in obs_step.cu, <PASS_128, true> in
//     obs_step_big.cu) ---
template <int R, bool VECP>
__global__ void __launch_bounds__(csl_res::PassShape<R>::NT, csl_res::PassShape<R>::MIN_BLOCKS)
obs_pass_kernel(const float* __restrict__ p, const float* __restrict__ g,
                const float* __restrict__ mg, float* __restrict__ out, int d, int ldg, int r,
                int nt, int ntiles, unsigned long long* stamps,
                const __grid_constant__ csl_res::PassMaps maps) {
    csl_res::pass_tiles<R, VECP>(p, g, mg, out, d, ldg, r, nt, ntiles, stamps, OS_STAMPS, maps);
}

// The frame kernel's dynamic shared memory (floats) at a unit of `unit`
// columns: the largest of its phases' needs (the chain; the sweep with v
// and siv; the pht units: the unit's pht, rowc, hvb, the gathered panel and
// vtf's; the gains: the unit's pht, S^-1, the mean's partials, v, siv and
// an mbarrier for each 32 rows of S^-1 (16 floats hold the 7 of MP 224)).
inline size_t smem_floats(int mp, int rp, int nbp, int unit) {
    const int pl = unit + 4;
    size_t fl = (size_t)csl_obs_smem_floats(mp, rp, nbp, OS_BAND);
    fl = std::max(fl, csl_sweep::smem_bytes(mp, 32 * ((mp + 31) / 32)) / sizeof(float) + 2 * mp);
    fl = std::max(fl, (size_t)(mp * pl + 8 * mp + mp * nbp + rp * pl + nbp * unit));
    fl = std::max(fl, (size_t)(mp * pl + mp * mp + OS_XG * unit + 2 * mp + 16));
    return fl;
}

// The unit (columns of D a block takes through phases 2 and 3) for a grid
// of `workers` + 1 blocks: the fewest multiples of OS_COLS that cover ldg
// in one round of the workers, at most OS_MAX_UNIT columns, and no more
// than fit a block's shared memory (at MP 224, 24 columns).
inline int unit_cols(int ldg, int workers, int mp, int rp, int nbp) {
    const int groups = (ldg + OS_COLS - 1) / OS_COLS;
    int unit = OS_COLS * std::min(OS_MAX_UNIT / OS_COLS, std::max(1, (groups + workers - 1) / workers));
    while (unit > OS_COLS &&
           smem_floats(mp, rp, nbp, unit) * sizeof(float) + OS_STATIC_BYTES > CSL_MAX_SMEM)
        unit -= OS_COLS;
    return unit;
}

constexpr int MAX_DEVICES = 64;
constexpr int VARIANTS = OS_MAX_MP / 32;      // RX = 1 .. 7

// Per device, cached on first use: the SM count, each frame-kernel
// variant's static shared memory (its dynamic cap raised once) and its last
// occupancy query, and the P pass's records: [0][VECP] the 32-tiles', [1]
// the streamed 128-tiles'.
struct DeviceInfo {
    int sms = 0;
    int static_bytes[VARIANTS + 1] = {};
    bool raised[VARIANTS + 1] = {};
    size_t occ_smem[VARIANTS + 1] = {};
    int occ[VARIANTS + 1] = {};
    csl_res::PassInfo pass32[2], pass128;
};
inline DeviceInfo g_info[MAX_DEVICES];

// The current device's record, its SM count read (and its support of
// cooperative launches checked) on first use.
inline cudaError_t device_info(DeviceInfo** out) {
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
    *out = &info;
    return cudaSuccess;
}

// The P pass's streamed 128-tiles (obs_step_big.cu, 16-byte P rows): its
// plan at D = d and its launch, and its registers and local bytes a thread.
cudaError_t plan_pass_big(int d, csl_res::PassPlan* plan);
cudaError_t launch_pass_big(const Frame& f, unsigned long long* stamps, cudaStream_t stream);
cudaError_t pass_regs_big(int* regs, int* local);

}  // namespace csl_h10
