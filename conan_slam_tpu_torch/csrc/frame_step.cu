// H9 frame_step: the whole known-association frame in TWO launches on one
// stream: a cooperative frame kernel (the packing, the S-step recursion,
// observe, S, the sweep inverse, siv, the NIS, the gains and the updated
// mean) and the P pass at H4's own occupancy, launched right behind it with
// programmatic dependent launch.
//
// Replaces the TPU kernel conan_slam_tpu/ops/frame_kernel.py:1312
// frame_step (pallas_call :1399, body _framestep_kernel :655-907), the
// reference's one-dispatch resident schedule.  On the TPU its grid ran in
// order: grid step 0 formed the chain, S^-1, siv, xn and the NIS into VMEM
// scratch, and every step then wrote one row panel of
// P + p2 (x) wrow - (pht^T_panel S^-1) pht plus the 3-row border.  Hopper
// blocks run in no order, so the phases here are separated by grid
// barriers (cooperative_groups grid sync; the frame kernel's launch is
// cooperative, one block an SM, every block resident), and what the TPU
// kept in scratch goes through device memory (L2) between phases:
//
//   1. Chain.  Each block that owns a band of measurement rows (the plan of
//      H2, ops/frame_kernel.py frame_chain_plan) packs the frame's raw
//      inputs itself (the gathered rows [0, 1, 2, 3 + 2 s, 4 + 2 s] from the
//      slots clamped to the capacity, zin, R, the controls and chol(Q) in
//      closed form, as ops/frame_kernel.py _pack_meas, _pack_ctrl), gathers
//      the band's rows of P[rows][:, rows] and x[rows] from P and x, runs the
//      recursion on one warp, the observe, and its rows of psub and S
//      (chain_band.cuh, H2's phases).  Block 0 writes the pose trace and the
//      frame scalars, and finds nblk = last valid slot + 1 meanwhile.
//   2. Block 0 inverts S by H1's register-resident sweep (sweep.cuh) over
//      nblk pivots and stores S^-1; nothing else is on its path to the
//      barrier.  Meanwhile every other block takes units of FS_UNIT columns
//      of D: it forms the unit's pht = Hc P'[rows] in
//      16-column panels (panel.cuh, H3's column) into the strip G and into
//      its own shared memory, which it keeps for phase 3, and writes the
//      unit's K4 rows of G = [pht; p2; e0; e1; e2; 0] and MG = [-S^-1 pht;
//      wrow; border; 0] (the closed form U K4 U^T, U = [p2, e0, e1, e2]),
//      which need no S^-1.
//   3. The gains: each block with a unit brings S^-1 into shared memory by
//      bulk copies (TMA) and, for the unit it formed last in phase 2 (its
//      pht still in shared memory; at D 2304 its only unit, so one round), forms -S^-1 pht into MG on 8 warps while the other 8
//      form siv = v^T S^-1 from the same S^-1 and the mean xn = base + siv
//      pht, heading wrapped.  Block 0, beside them, turns its swept tile
//      into S^-1 in place and forms siv (the same bits) and the NIS.
//   4. The P pass (frame_pass_kernel, the second launch): out = P + G^T MG
//      = P + p2 (x) wrow + border - pht^T S^-1 pht over upper-triangle
//      tiles, each mirrored: P comes out exactly symmetric whenever it
//      goes in exactly symmetric.  D and the SM count choose its route
//      (csl_res::pass_route): H4's 32-tile blocks, Cfg<32>: 64 threads
//      and a 16 KB ring a block, 12 or 13 resident an SM, one block a
//      tile, so as many tiles are in flight as in H4 (where D gives fewer
//      tiles than that, at most ceil(tiles / SMs) an SM, so that they
//      spread over every SM); or, where D gives at least 8 tiles of 128
//      an SM (the 10k-landmark shape, D 20,224), streamed 128-tiles, one
//      persistent block an SM that brings P in and out by tensor copies
//      under its FMAs (csl_res::stream_tiles).  Its body, plan and
//      launch are H10's too (resident.cuh).  The frame kernel cannot hold the 32-tiles: its blocks are 512
//      threads for the sweep's layout, and 12 tile groups a block would cap
//      a thread at ~80 registers, under the sweep's 96 at MP 128.  The
//      launch carries the programmatic-stream-serialization attribute; the
//      frame kernel lets it launch once every block has passed barrier 2,
//      and the P pass waits (griddepcontrol.wait) until the frame kernel is
//      complete and its writes visible, so its launch overlaps the gains.
//
// What bounds it on the card: at the bench shape (D = 2304, MP = 128) P's
// bytes, 2 D^2 x 4 B = 42.5 MB (12.7 us at 3.35 TB/s), against ~0.7 GFLOP
// of the P pass (10.8 us at 67 TFLOP/s fp32); in practice the serial sweep
// (phase 2, one block) and the P pass, which is FMA-issue bound at the
// tiles in flight.  fp32 FMA only (TF32 off, no tensor cores).  No atomics:
// every sum is one thread's fixed chain or a fixed-order reduction, so two
// calls are bit for bit equal.
//
// The frame kernel's blocks are 512 threads in every phase, the sweep's 16
// warps (H1's register layout needs them); the panels take 16 columns x 32
// row groups.  Its shared memory is the largest of its phases' needs, not
// their sum.  Data written during the launch is read with __ldcg,
// cp.async.cg or bulk copies after a proxy fence (through L2, never from a
// stale L1 line or the read-only path).
//
// The C entry launches both kernels on the stream it is given, allocates
// nothing (the caller hands it one scratch buffer), and returns the first
// launch error, so the pair can be captured in a CUDA graph (the
// programmatic edge included).  If either launch fails the call fails: there
// is no other route.
#include <cooperative_groups.h>

#include <algorithm>
#include <vector>

#include "chain_band.cuh"
#include "panel.cuh"
#include "rank_tile.cuh"
#include "resident.cuh"
#include "sweep.cuh"

namespace cg = cooperative_groups;

#define FS_THREADS 512      // 16 warps: H1's sweep layout (csl_sweep::NT)
#define FS_W 16             // columns of a pht panel (H3's PANEL_W)
#define FS_LD 24            // row stride of a gathered panel (H3's PANEL_LD)
#define FS_UNIT 24          // columns of D a block takes through phases 2 and 3
#define FS_MAX_MP 224       // H1's register limit: 7 x 7 elements a thread
#define FS_MAX_RP 232       // gathered rows at MP = 224
#define FS_XG 32            // the mean's partial fmaf chains a column, summed in order
#define FS_STAMPS 12        // stamps a block (stamp())
#define FS_PLAN 14          // values csl_frame_step_plan reports
#define FP_PLAN 8           // values csl_frame_pass_plan reports

namespace {

static_assert(FS_THREADS == csl_sweep::NT, "one block size for every phase of the frame kernel");
using csl_res::PASS_128;
using csl_res::PASS_32;
using csl_res::block_units;
using csl_res::bulk_wait;
using csl_res::globaltimer;
using csl_res::Units;

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
    unsigned long long* stamps;     // (grid + pass grid, FS_STAMPS) phase times, or null
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

// The frame kernel's block b writes its %globaltimer (ns) into stamps[b, k]
// when the caller asked for them: k = 0 the start, 1 the chain done, 2 past
// barrier 1, 3 block 0's sweep done or another block's pht units done, 4
// block 0's siv and NIS done (phase 3), 5 past barrier 2, 6 the gains
// done, 9 its first unit's S^-1 in shared memory, 10 that unit's MG
// stored, 11 that unit's siv formed;
// block 0 also its SM's clock64 at 7 the sweep's start and 8 its end
// (cycles over ns: the SM clock during the sweep).  The P pass's block b writes
// stamps[grid + b, 0] as it starts its tiles and [grid + b, 1] when done.
// A "done" stamp waits for the whole block first.
__device__ __forceinline__ void stamp(const Frame& f, int k, bool done) {
    if (f.stamps == nullptr) return;
    if (done) __syncthreads();
    if (threadIdx.x == 0) f.stamps[(size_t)blockIdx.x * FS_STAMPS + k] = globaltimer();
}

__device__ __forceinline__ void stamp_clock(const Frame& f, int k) {
    if (f.stamps != nullptr && threadIdx.x == 0) f.stamps[k] = clock64();
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

// The sweep phase's shared memory (floats): the sweep's (sweep.cuh), then
// the innovation and siv.
__host__ __device__ constexpr int sweep_phase_floats(int mp) {
    return mp * (mp + 1) + mp + 8 * 32 * ((mp + 31) / 32) + 2 * mp;
}

// --- phase 2, block 0: S^-1 by the sweep.  Returns whether a value was
//     non-finite (S^-1 is then zero); the swept tile stays in shared memory
//     for phase 3 ---
template <int RX>
__device__ __forceinline__ bool sweep_phase(const Frame& f, float* smem, int nb) {
    stamp_clock(f, 7);
    const bool bad = csl_sweep::inverse<RX, true>(f.s, nb, f.si, f.mp, smem);
    stamp_clock(f, 8);
    stamp(f, 3, true);
    return bad;
}

// --- phase 3, block 0 (off the critical path: no block waits for it): the
//     swept tile becomes S^-1 in place, then siv and the NIS ---
template <int RX>
__device__ __forceinline__ void nis_phase(const Frame& f, float* smem, bool bad) {
    float* v = smem + sweep_phase_floats(f.mp) - 2 * f.mp;   // (mp,) the innovation, then siv
    csl_res::swept_siv_nis<RX, FS_THREADS>(smem, f.mp, f.rowc, v, v + f.mp, bad, f.siv, f.nis);
    stamp(f, 4, true);
}

// --- phase 2, the other blocks: one unit of U columns: pht into G and into
//     shared memory (kept for phase 3), and the unit's K4 rows of G, MG, in
//     panels of FS_W columns at offsets 0, FS_W, ..., the last one ending at
//     the unit's end (at U = 24 the two panels overlap by 8 columns, which
//     get the same values twice) ---
template <int U>
__device__ __forceinline__ void pht_unit(const Frame& f, float* smem, const int* rows, int unit) {
    const int tid = threadIdx.x, mp = f.mp, rp = f.rp, nzl = mp / 2, ldg = f.ldg;
    float* pht_s = smem;               // (mp, U) the unit's pht
    float* rc = pht_s + mp * U;        // (mp, 8) rowc
    float* msh = rc + 8 * mp;          // (32,)
    float* pan = msh + 32;             // (rp, FS_LD) P[rows][:, c0 : c0 + FS_W]
    const int tx = tid % FS_W, ty = tid / FS_W;
    __syncthreads();                   // the shared memory's earlier readers are done
    stage_cg(rc, f.rowc, 8 * mp);
    stage_cg(msh, f.ms, 32);
#pragma unroll 1
    for (int sub = 0; sub < (U + FS_W - 1) / FS_W; ++sub) {
        const int off = min(sub * FS_W, U - FS_W), c0 = unit * U + off, n = c0 + tx;
        if (sub > 0) __syncthreads();  // the last panel's readers are done
        csl_stage_panel(pan, [&](int r) { return f.p + (size_t)rows[r] * f.d; }, rp, FS_W, FS_LD,
                        c0, f.d, f.vecp != 0);
        csl_cp_async_commit();
        csl_cp_async_wait<0>();
        __syncthreads();
        const float p2 = pan[2 * FS_LD + tx];      // P[2, n]: gathered row 2 is P's row 2
        const CslPanelColumn col = csl_panel_column(msh, pan[tx], pan[FS_LD + tx], p2, n);
        for (int l = ty; l < nzl; l += FS_THREADS / FS_W) {
            const int cx = 3 + 2 * l, cy = cx + 1;
            const float sx = cx < rp ? pan[cx * FS_LD + tx] : 0.f;
            const float sy = cy < rp ? pan[cy * FS_LD + tx] : 0.f;
            for (int k = 0; k < 2; ++k) {
                const int i = 2 * l + k;
                const float acc = n < f.d ? csl_pht_entry(rc + 8 * i, col, sx, sy, cx < rp, cy < rp)
                                          : 0.f;
                if (n < ldg) f.g[(size_t)i * ldg + n] = acc;
                pht_s[i * U + off + tx] = acc;
            }
        }
        // G rows mp .. mp + 7 = [p2; e0; e1; e2; 0], MG's = K4 [p2; e0; e1; e2]
        // = [wrow; g_r p2 + m3[r, :]; 0].
        if (ty < 8 && n < ldg) {
            float gv = 0.f, mv = 0.f;
            if (ty == 0) {
                gv = p2;
                mv = col.wrow;
            } else if (ty < 4) {
                const int r = ty - 1;
                gv = n == r ? 1.f : 0.f;
                mv = msh[5 + r] * p2 + (n < 3 ? msh[8 + 3 * r + n] : 0.f);
            }
            f.g[(size_t)(mp + ty) * ldg + n] = gv;
            f.mg[(size_t)(mp + ty) * ldg + n] = mv;
        }
    }
}

// The gains phase's shared memory (floats): a unit's pht, S^-1, the mean's
// partial sums (FS_XG a column), v, siv, ms and an mbarrier for each 32
// rows of S^-1 (16 floats hold the 7 of MP 224).
__host__ __device__ constexpr int gains_floats(int mp) {
    return mp * FS_UNIT + mp * mp + FS_XG * FS_UNIT + 2 * mp + 32 + 16;
}

// MG rows krow[m], 8 columns, over S^-1 rows i0 .. i1 - 1: acc[m][q] +=
// S^-1[i, krow[m]] pht[i, 8 cg + q].  S^-1 is exactly symmetric, so its row
// i gives column i: a warp's rows (lane + 32 ...) read 32 consecutive
// floats, and the warp's one column group's 8 pht values are a broadcast.
template <int R, int U>
__device__ __forceinline__ void mg_rows(float (&acc)[R][8], const int (&krow)[R],
                                        const float* si_s, int mp, const float* pht_s, int cg,
                                        int i0, int i1) {
#pragma unroll 2
    for (int i = i0; i < i1; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(pht_s + i * U + 8 * cg);
        const float4 b = *reinterpret_cast<const float4*>(pht_s + i * U + 8 * cg + 4);
        const float pv[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
        for (int m = 0; m < R; ++m) {
            const float sv = si_s[i * mp + krow[m]];
#pragma unroll
            for (int q = 0; q < 8; ++q) acc[m][q] = fmaf(sv, pv[q], acc[m][q]);
        }
    }
}

// --- phase 3: each unit's MG = -S^-1 pht and mean, last unit first (its
//     pht still in shared memory from phase 2) ---
//
// S^-1 comes into shared memory by the tensor memory accelerator, in bulk
// copies of 32 rows, one mbarrier each (issued by one thread, so the
// block's threads spend nothing on the copy), and MG runs over each chunk
// as it lands.  MG runs on MW = 2 U / 8 warps (6 at U = 24), each thread a
// tile of R rows x 8 columns (16 fmaf to 2 + 2 loads at MP 128): warp w
// takes the 8 columns 8 (w % C8) .. of the unit and the rows lane + 32
// (w / C8 + 2 m); each entry is one fmaf chain over i in order.  Meanwhile
// the other warps form siv from the staged S^-1 (as block 0 does, the same
// bits) and the mean's partial sums.
template <int RX, int U>
__device__ __forceinline__ void gain_phase(const Frame& f, float* smem) {
    constexpr int C8 = U / 8;                              // 8-column groups of a unit
    constexpr int WG = 2;                                  // warps a column group
    constexpr int MW = C8 * WG;                            // MG's warps
    constexpr int R = (RX + WG - 1) / WG;                  // MG rows a thread
    constexpr int XT = FS_THREADS - 32 * MW;               // siv's and the mean's threads
    static_assert(U % 8 == 0 && XT >= FS_MAX_MP, "MG's warps");
    const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
    const int mp = f.mp, ldg = f.ldg;
    if (blockIdx.x == 0) return;
    const Units us = block_units((ldg + U - 1) / U);
    if (us.last < 0) return;
    float* pht_s = smem;               // (mp, U)
    float* si_s = pht_s + mp * U;      // (mp, mp) S^-1
    float* part = si_s + mp * mp;      // (FS_XG, U) the mean's partial sums
    float* v_s = part + FS_XG * U;     // (mp,) the innovation
    float* siv_s = v_s + mp;           // (mp,)
    float* msh = siv_s + mp;           // (32,)
    unsigned long long* bar = reinterpret_cast<unsigned long long*>(msh + 32);   // (RX,)
    if (tid == 0) csl_res::bulk_load_si<RX>(si_s, f.si, mp, bar);
    for (int i = tid; i < mp; i += FS_THREADS) v_s[i] = __ldcg(f.rowc + 8 * i + 7);
    stage_cg(msh, f.ms, 32);
    csl_cp_async_commit();
    const int cg = w % C8, wg = w / C8;
    int krow[R];
#pragma unroll
    for (int m = 0; m < R; ++m) krow[m] = min(lane + 32 * (wg + WG * m), mp - 1);
    const int tx = tid % U;
#pragma unroll 1
    for (int unit = us.last; unit >= us.first; unit -= us.workers) {
        const bool first = unit == us.last;   // its pht is in shared memory
        const int c0 = unit * U, n = c0 + tx;
        if (!first) {                  // another unit's pht, from G
            __syncthreads();           // the last unit's readers are done
            for (int e = tid; e < mp * (U / 4); e += FS_THREADS) {
                const int i = e / (U / 4), c = 4 * (e % (U / 4));
                const bool in = c0 + c < ldg;   // ldg % 4 == 0: four columns all in or all out
                csl_cp_async16(pht_s + i * U + c, in ? f.g + (size_t)i * ldg + c0 + c : f.g, in);
            }
            csl_cp_async_commit();
        }
        // The mean's base: inputs of the launch, read while the copies fly.
        float xv = 0.f, p2 = 0.f;
        if (tid < U && n < f.d) {
            xv = f.x[n];
            p2 = f.p[2 * (size_t)f.d + n];
        }
        csl_cp_async_wait<0>();        // ms (and another unit's pht)
        __syncthreads();               // and the mbarriers are initialised
        if (w < MW) {
            float acc[R][8];
#pragma unroll
            for (int m = 0; m < R; ++m)
#pragma unroll
                for (int q = 0; q < 8; ++q) acc[m][q] = 0.f;
#pragma unroll
            for (int c = 0; c < RX; ++c) {
                bulk_wait(bar + c);    // chunk c of S^-1 landed
                if (first && c == 0) stamp(f, 9, false);
                mg_rows<R, U>(acc, krow, si_s, mp, pht_s, cg, 32 * c, 32 * c + 32);
            }
            const int n8 = c0 + 8 * cg;
#pragma unroll
            for (int m = 0; m < R; ++m) {
                const int k = lane + 32 * (wg + WG * m);
                float* row = f.mg + (size_t)k * ldg + n8;
                if (k < mp && n8 < ldg)
                    *reinterpret_cast<float4*>(row) =
                        make_float4(-acc[m][0], -acc[m][1], -acc[m][2], -acc[m][3]);
                if (k < mp && n8 + 4 < ldg)
                    *reinterpret_cast<float4*>(row + 4) =
                        make_float4(-acc[m][4], -acc[m][5], -acc[m][6], -acc[m][7]);
            }
            if (first) stamp(f, 10, false);
        } else {
            if (first) {
#pragma unroll
                for (int c = 0; c < RX; ++c) bulk_wait(bar + c);   // S^-1 landed
                csl_res::siv_chain(si_s, mp, v_s, siv_s, mp, 32 * MW);
                // siv is complete: a barrier of the XT threads past MG's.
                asm volatile("bar.sync 1, %0;\n" ::"n"(XT) : "memory");
                if (f.stamps != nullptr && tid == 32 * MW)
                    f.stamps[(size_t)blockIdx.x * FS_STAMPS + 11] = globaltimer();
            }
            // The mean: FS_XG partial fmaf chains a column (i = g, g + FS_XG,
            // ...), summed in order.
            for (int e = tid - 32 * MW; e < FS_XG * U; e += XT) {
                const int g = e / U, col = e % U;
                float xs = 0.f;
                for (int i = g; i < mp; i += FS_XG) xs = fmaf(siv_s[i], pht_s[i * U + col], xs);
                part[g * U + col] = xs;
            }
        }
        __syncthreads();
        if (tid < U && n < f.d) {
            float s = 0.f;
            for (int r = 0; r < FS_XG; ++r) s += part[r * U + tx];
            const float base = n < 3 ? msh[n] : xv + p2 * msh[3];
            const float v = base + s;
            f.xn[n] = n == 2 ? csl_wrap(v) : v;
        }
    }
}

template <int RX>
__global__ void __launch_bounds__(FS_THREADS, 1)
frame_step_kernel(const __grid_constant__ Frame f) {
    constexpr int U = FS_UNIT;
    extern __shared__ __align__(16) float smem[];
    __shared__ int rows[FS_MAX_RP];
    __shared__ float qc[4];
    __shared__ float ms[32];
    __shared__ int wmax[FS_THREADS / 32];
    cg::grid_group grid = cg::this_grid();
    stamp(f, 0, false);
    for (int a = threadIdx.x; a < f.rp; a += FS_THREADS) rows[a] = gathered_row(f, a);
    const int nb = blockIdx.x == 0 ? csl_res::last_valid_slot<FS_THREADS>(f.mask, f.mask_st, f.nz, wmax)
                                   : 0;

    // Every block reaches every grid barrier: no phase returns from the
    // kernel before barrier 2.
    if ((int)blockIdx.x < (f.mp + f.band - 1) / f.band) chain_phase(f, smem, rows, qc, ms);
    stamp(f, 1, true);
    grid.sync();
    stamp(f, 2, false);

    // Phase 2: block 0 sweeps; every other block takes its units of pht.
    bool bad = false;
    if (blockIdx.x == 0) {
        bad = sweep_phase<RX>(f, smem, nb);
    } else {
        const Units us = block_units((f.ldg + U - 1) / U);
        for (int unit = us.first; unit >= 0 && unit <= us.last; unit += us.workers)
            pht_unit<U>(f, smem, rows, unit);
        stamp(f, 3, true);
    }
    grid.sync();
    // The P pass may launch now; it waits for this kernel's end to read G
    // and MG (griddepcontrol.wait).
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
    stamp(f, 5, false);

    // Phase 3: the gains, and block 0's siv and NIS beside them.
    if (blockIdx.x == 0) nis_phase<RX>(f, smem, bad);
    gain_phase<RX, U>(f, smem);
    stamp(f, 6, true);
}

// --- the second launch: out = P + G^T MG over the upper-triangle tiles,
//     mirrored, on route R (csl_res::pass_tiles, shared with H10), P read
//     and written evict-first ---
template <int R, bool VECP>
__global__ void __launch_bounds__(csl_res::PassShape<R>::NT, csl_res::PassShape<R>::MIN_BLOCKS)
frame_pass_kernel(const float* __restrict__ p, const float* __restrict__ g,
                  const float* __restrict__ mg, float* __restrict__ out, int d, int ldg, int r,
                  int nt, int ntiles, unsigned long long* stamps,
                  const __grid_constant__ csl_res::PassMaps maps) {
    csl_res::pass_tiles<R, VECP>(p, g, mg, out, d, ldg, r, nt, ntiles, stamps, FS_STAMPS, maps);
}

// The frame kernel's dynamic shared memory (bytes): the largest of its
// phases' needs (the chain's with the controls and the recursion's, sized
// by S).
size_t smem_bytes(int mp, int rp, int band, int S) {
    size_t fl = (size_t)(csl_chain_smem_floats(mp, rp, band) + 4 * S + csl_coeff_smem_floats(S));
    fl = std::max(fl, (size_t)sweep_phase_floats(mp));
    fl = std::max(fl, (size_t)(mp * FS_UNIT + 8 * mp + 32 + rp * FS_LD));
    fl = std::max(fl, (size_t)gains_floats(mp));
    return fl * sizeof(float);
}

constexpr int MAX_DEVICES = 64;
constexpr int VARIANTS = FS_MAX_MP / 32;      // RX = 1 .. 7

// Per device, cached on first use: the SM count, each frame-kernel
// variant's static shared memory (its dynamic cap raised once) and its last
// occupancy query, and the P pass's records: pass32[VECP] and pass128
// (16-byte P rows only).
struct DeviceInfo {
    int sms = 0;
    int static_bytes[VARIANTS + 1] = {};
    bool raised[VARIANTS + 1] = {};
    size_t occ_smem[VARIANTS + 1] = {};
    int occ[VARIANTS + 1] = {};
    csl_res::PassInfo pass32[2], pass128;
};
DeviceInfo g_info[MAX_DEVICES];

cudaError_t device_info(DeviceInfo** out) {
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

// The frame kernel's grid for variant RX at `smem` dynamic bytes: one block
// an SM, after checking that a block of FS_THREADS fits an SM at all (the
// cooperative launch needs every block resident) and that there are two
// SMs at least (block 0 sweeps while the others form pht).
template <int RX>
cudaError_t plan_frame(size_t smem, int* grid) {
    DeviceInfo* info = nullptr;
    cudaError_t err = device_info(&info);
    if (err != cudaSuccess) return err;
    const auto fn = frame_step_kernel<RX>;
    if (!info->raised[RX]) {
        cudaFuncAttributes attr;
        err = cudaFuncGetAttributes(&attr, fn);
        if (err != cudaSuccess) return err;
        info->static_bytes[RX] = (int)attr.sharedSizeBytes;
        err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   CSL_MAX_SMEM - (int)attr.sharedSizeBytes);
        if (err != cudaSuccess) return err;
        info->raised[RX] = true;
    }
    if (smem + info->static_bytes[RX] > CSL_MAX_SMEM) return cudaErrorInvalidValue;
    if (info->occ_smem[RX] != smem) {
        int occ = 0;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, FS_THREADS, smem);
        if (err != cudaSuccess) return err;
        info->occ[RX] = occ;
        info->occ_smem[RX] = smem;
    }
    if (info->occ[RX] < 1 || info->sms < 2) return cudaErrorCooperativeLaunchTooLarge;
    *grid = info->sms;
    return cudaSuccess;
}

// The P pass's plan at D = d on route R (csl_res::plan_pass), its
// occupancy query cached per device.
template <int R, bool VECP>
cudaError_t plan_pass(int d, csl_res::PassPlan* plan) {
    DeviceInfo* info = nullptr;
    const cudaError_t err = device_info(&info);
    if (err != cudaSuccess) return err;
    csl_res::PassInfo* pi = R == PASS_128 ? &info->pass128 : &info->pass32[VECP ? 1 : 0];
    return csl_res::plan_pass<R>(frame_pass_kernel<R, VECP>, d, pi, plan);
}

template <int R, bool VECP>
cudaError_t launch_pass(const float* p, const float* g, const float* mg, float* out, int d,
                        int ldg, int r, unsigned long long* stamps, cudaStream_t stream) {
    csl_res::PassPlan plan;
    const cudaError_t err = plan_pass<R, VECP>(d, &plan);
    if (err != cudaSuccess) return err;
    return csl_res::launch_pass<R>(frame_pass_kernel<R, VECP>, plan, p, g, mg, out, d, ldg, r,
                                   stamps, stream);
}

// The pass on `route`: 0 the frame's (csl_res::pass_route), else PASS_32 or
// PASS_128 (16-byte P rows only).
cudaError_t launch_pass_route(int route, const float* p, const float* g, const float* mg, float* out,
                              int d, int ldg, int r, unsigned long long* stamps,
                              cudaStream_t stream) {
    const bool vec = csl_res::pass_vec(p, out, d);
    if (route == 0) {
        DeviceInfo* info = nullptr;
        const cudaError_t err = device_info(&info);
        if (err != cudaSuccess) return err;
        route = csl_res::pass_route(d, info->sms, vec);
    }
    switch (route) {
        case PASS_32:
            return vec ? launch_pass<PASS_32, true>(p, g, mg, out, d, ldg, r, stamps, stream)
                       : launch_pass<PASS_32, false>(p, g, mg, out, d, ldg, r, stamps, stream);
        case PASS_128:
            if (!vec) return cudaErrorInvalidValue;
            return launch_pass<PASS_128, true>(p, g, mg, out, d, ldg, r, stamps, stream);
        default:
            return cudaErrorInvalidValue;
    }
}

// What csl_frame_pass_plan reports for route R (see there).
template <int R>
cudaError_t pass_plan_only(int d, int* out) {
    csl_res::PassPlan pass;
    cudaError_t err = plan_pass<R, true>(d, &pass);
    if (err != cudaSuccess) return err;
    out[0] = R;
    out[1] = pass.grid;
    out[2] = csl_res::PassShape<R>::NT;
    out[3] = (int)pass.smem;
    err = csl_func_regs(frame_pass_kernel<R, true>, &out[4], &out[5]);
    out[6] = pass.occ;
    out[7] = pass.ntiles;
    return err;
}

template <int RX>
cudaError_t launch(const Frame& f, cudaStream_t stream) {
    const size_t smem = smem_bytes(f.mp, f.rp, f.band, f.S);
    int grid = 0;
    cudaError_t err = plan_frame<RX>(smem, &grid);
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
    err = launch_pass_route(0, f.p, f.g, f.mg, f.p_out, f.d, f.ldg, f.mp + 8,
                            f.stamps ? f.stamps + (size_t)grid * FS_STAMPS : nullptr, stream);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

// What csl_frame_step_plan reports for variant RX (see there).
template <int RX>
cudaError_t plan_only(int mp, int rp, int band, int S, int d, int* out) {
    const size_t bytes = smem_bytes(mp, rp, band, S);
    cudaError_t err = plan_frame<RX>(bytes, &out[0]);
    if (err != cudaSuccess) return err;
    out[1] = FS_THREADS;
    out[2] = (int)bytes;
    err = csl_func_regs(frame_step_kernel<RX>, &out[3], &out[4]);
    if (err != cudaSuccess) return err;
    DeviceInfo* info = nullptr;
    err = device_info(&info);
    if (err != cudaSuccess) return err;
    int pass[FP_PLAN];
    err = csl_res::pass_route(d, info->sms, true) == PASS_128 ? pass_plan_only<PASS_128>(d, pass)
                                                              : pass_plan_only<PASS_32>(d, pass);
    if (err != cudaSuccess) return err;
    out[5] = pass[1];
    out[6] = pass[2];
    out[7] = pass[3];
    out[8] = pass[4];
    out[9] = pass[5];
    out[10] = FS_UNIT;
    out[11] = pass[7];
    out[12] = pass[6];
    out[13] = pass[0];
    return cudaSuccess;
}

}  // namespace

// The plan of a frame at (mp, rp, band, S, d) on the current device, as
// FS_PLAN ints: the frame kernel's grid, block, dynamic shared memory
// (bytes), registers and local-memory bytes a thread; the P pass's grid,
// block, shared memory, registers and local bytes (16-byte P rows); the
// unit's columns; the P pass's tiles, its blocks an SM and its tile edge
// (its route, csl_res::pass_route).  Launches nothing.
extern "C" int csl_frame_step_plan(int mp, int rp, int band, int S, int d, int* out) {
    if (mp <= 0 || mp % 32 || mp > FS_MAX_MP || rp < 3 || rp > FS_MAX_RP || band <= 0 ||
        band % 2 || S <= 0 || S > CSL_MAX_STEPS || d < 3)
        return (int)cudaErrorInvalidValue;
    switch (mp / 32) {
        case 1: return (int)plan_only<1>(mp, rp, band, S, d, out);
        case 2: return (int)plan_only<2>(mp, rp, band, S, d, out);
        case 3: return (int)plan_only<3>(mp, rp, band, S, d, out);
        case 4: return (int)plan_only<4>(mp, rp, band, S, d, out);
        case 5: return (int)plan_only<5>(mp, rp, band, S, d, out);
        case 6: return (int)plan_only<6>(mp, rp, band, S, d, out);
        default: return (int)plan_only<7>(mp, rp, band, S, d, out);
    }
}

// One frame: see the top of this file.  slots int64, actives and mask bool
// (one byte); the 1-D inputs with their strides in elements; q_cov, r_cov
// (2, 2), p (d, d) and x (d,) contiguous; scratch of 2 mp^2 + 9 mp + 32 +
// 2 (mp + 8) ldg floats, 16-byte aligned: S, S^-1, rowc, ms, siv, G, MG
// (ops/frame_kernel.py _frame_step_scratch_floats); stamps null, or
// (grid + pass grid, FS_STAMPS) for each block's phase times (see stamp()).
// mp = 2 nz rounded up to 32, rp = 3 + 2 nz rounded up to 8, ldg = d
// rounded up to 4, band = the chain plan's rows a block.
extern "C" int csl_frame_step(const float* p, const float* x, const long long* slots,
                              const float* vns, const float* swans, const float* phis,
                              const unsigned char* actives, const float* q_cov, const float* zr,
                              const float* zb, const unsigned char* mask, const float* r_cov,
                              float* p_out, float* xn, float* pt, float* nis, float* scratch,
                              unsigned long long* stamps, int slots_st, int vns_st,
                              int swans_st, int phis_st, int actives_st, int zr_st, int zb_st,
                              int mask_st, int d, int nz, int S, int cap, int mp, int rp, int ldg,
                              int band, float wheel_base, float dt, float sigma_heading,
                              int use_heading, void* stream) {
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
    f.wheel_base = wheel_base;
    f.dt = dt;
    f.sigma_heading = sigma_heading;
    f.use_heading = use_heading;
    f.vecp = csl_res::pass_vec(p, p_out, d);    // the panels' and the P pass's 16-byte rows
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

// The P pass alone, out = P + G^T MG over the strips g and mg (r rows of
// row stride ldg >= d, ldg % 4 == 0, 16-byte aligned), on `route`: 0 the
// frame's (csl_res::pass_route), else PASS_32 or PASS_128 (d % 4 == 0, P
// and out 16-byte aligned).  Launched as the frame launches it (a
// programmatic dependent of whatever precedes it on the stream);
// allocates nothing.
extern "C" int csl_frame_pass(const float* p, const float* g, const float* mg, float* out, int d,
                              int ldg, int r, int route, void* stream) {
    if (d < 1 || r < 1 || ldg < d || ldg % 4 ||
        ((reinterpret_cast<size_t>(g) | reinterpret_cast<size_t>(mg)) & 15u))
        return (int)cudaErrorInvalidValue;
    const cudaError_t err =
        launch_pass_route(route, p, g, mg, out, d, ldg, r, nullptr, (cudaStream_t)stream);
    return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// The plan of csl_frame_pass at D = d on `route` (as there; 16-byte P
// rows), as FP_PLAN ints: the tile edge, the grid, the block, the shared
// memory a block (bytes), registers and local-memory bytes a thread,
// blocks an SM and tiles.  Launches nothing.
extern "C" int csl_frame_pass_plan(int d, int route, int* out) {
    if (d < 1) return (int)cudaErrorInvalidValue;
    if (route == 0) {
        DeviceInfo* info = nullptr;
        const cudaError_t err = device_info(&info);
        if (err != cudaSuccess) return (int)err;
        route = csl_res::pass_route(d, info->sms, true);
    }
    switch (route) {
        case PASS_32: return (int)pass_plan_only<PASS_32>(d, out);
        case PASS_128: return (int)pass_plan_only<PASS_128>(d, out);
        default: return (int)cudaErrorInvalidValue;
    }
}

// The programmatic edges (programmatic dependent launch: H9's P pass on its
// frame kernel) of a CUDA graph, e.g. one captured from a stream; launches
// nothing.  Needs CUDA 12.3's edge data.
extern "C" int csl_graph_programmatic_edges(void* graph, int* edges) {
#if CUDART_VERSION >= 12030
#if CUDART_VERSION >= 13000
#define CSL_GRAPH_EDGES cudaGraphGetEdges
#else
#define CSL_GRAPH_EDGES cudaGraphGetEdges_v2
#endif
    const cudaGraph_t g = static_cast<cudaGraph_t>(graph);
    size_t n = 0;
    cudaError_t err = CSL_GRAPH_EDGES(g, nullptr, nullptr, nullptr, &n);
    if (err != cudaSuccess) return (int)err;
    std::vector<cudaGraphNode_t> from(n), to(n);
    std::vector<cudaGraphEdgeData> data(n);
    if (n > 0) err = CSL_GRAPH_EDGES(g, from.data(), to.data(), data.data(), &n);
    if (err != cudaSuccess) return (int)err;
#undef CSL_GRAPH_EDGES
    int count = 0;
    for (size_t i = 0; i < n; ++i) count += data[i].type == cudaGraphDependencyTypeProgrammatic;
    *edges = count;
    return (int)cudaSuccess;
#else
    (void)graph;
    (void)edges;
    return (int)cudaErrorNotSupported;
#endif
}
