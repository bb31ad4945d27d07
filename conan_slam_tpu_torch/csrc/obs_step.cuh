// H10 obs_step's device code and its plan and launch templates, shared by
// obs_step.cu (the C entries and the variants with the P pass on tiles of
// 32) and obs_step_big.cu (the variants on tiles of 128), which compile
// apart, in parallel.  See obs_step.cu for what H10 computes and its
// design.
#pragma once

#include <cooperative_groups.h>

#include <algorithm>

#include "obs_band.cuh"
#include "panel.cuh"
#include "rank_tile.cuh"
#include "sweep.cuh"

namespace cg = cooperative_groups;

#define OS_THREADS 512      // 16 warps: H1's sweep layout (csl_sweep::NT)
#define OS_W 16             // columns of a panel
#define OS_LD 24            // row stride of a gathered panel
#define OS_BAND 2           // measurement rows a chain band: one measurement
#define OS_MAX_MP 224       // H1's register limit: 7 x 7 elements a thread
#define OS_MAX_RP 232       // gathered rows at MP = 224

namespace csl_h10 {

static_assert(OS_THREADS == csl_sweep::NT, "one block size for every phase");
constexpr int OS_ROWG = OS_THREADS / OS_W;           // row groups of a panel

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
    unsigned long long* stamps;     // (grid, 8) phase boundary times, or null
    int slots_st, zr_st, zb_st, mask_st;
    int d, nz, cap, mp, rp, nbp, ldg;
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

// --- phase 2, block 0: S^-1 by the sweep, siv = v^T S^-1 and the NIS ---
template <int RX>
__device__ __forceinline__ void sweep_phase(const Frame& f, float* smem, int* wmax) {
    const int tid = threadIdx.x, mp = f.mp;
    // nblk = last valid slot + 1 (ops/frame_kernel.py _pack_meas).
    int nb = 0;
    for (int l = tid; l < f.nz; l += OS_THREADS)
        if (f.mask[(size_t)l * f.mask_st]) nb = l + 1;
    nb = __reduce_max_sync(0xffffffffu, nb);
    if ((tid & 31) == 0) wmax[tid >> 5] = nb;
    __syncthreads();
    nb = 0;
    for (int w = 0; w < OS_THREADS / 32; ++w) nb = max(nb, wmax[w]);
    csl_sweep::inverse<RX, true>(f.s, nb, f.si, mp, smem);
    __syncthreads();      // S^-1 is stored; the sweep's shared memory is free

    float* v = smem;      // (mp,) the innovation
    float* sv = v + mp;   // (mp,) siv
    for (int i = tid; i < mp; i += OS_THREADS) v[i] = __ldcg(f.rowc + 8 * i + 7);
    __syncthreads();
    for (int j = tid; j < mp; j += OS_THREADS) {
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

// --- phase 2, the other blocks: 16-column panels of G = [vtf; pht] ---
__device__ __forceinline__ void pht_phase(const Frame& f, float* smem, const int* rows, int first,
                                          int stride) {
    const int tid = threadIdx.x, mp = f.mp, rp = f.rp, nbp = f.nbp, ldg = f.ldg;
    const int npanel = (ldg + OS_W - 1) / OS_W;
    if (first >= npanel) return;
    float* rc = smem;                  // (mp, 8) rowc
    float* hv = rc + 8 * mp;           // (mp, nbp) hvb
    float* pan = hv + mp * nbp;        // (rp, OS_LD) P[rows][:, c0 : c0 + OS_W]
    float* vp = pan + rp * OS_LD;      // (nbp, OS_W) vtf[:, c0 : c0 + OS_W]
    stage_cg(rc, f.rowc, 8 * mp);
    stage_cg(hv, f.hvb, mp * nbp);
    const int tx = tid % OS_W, ty = tid / OS_W;
    for (int panel = first; panel < npanel; panel += stride) {
        const int c0 = panel * OS_W, n = c0 + tx;
        __syncthreads();               // the last panel's readers are done
        csl_stage_panel(pan, [&](int r) { return f.p + (size_t)rows[r] * f.d; }, rp, OS_W, OS_LD, c0,
                        f.d, f.vecp != 0);
        csl_stage_panel(vp, [&](int b) { return f.vtf + (size_t)b * f.d; }, nbp, OS_W, OS_W, c0, f.d,
                        f.vecp != 0);
        csl_cp_async_commit();
        csl_cp_async_wait<0>();
        __syncthreads();
        if (n >= ldg) continue;
        const float p0 = pan[tx], p1 = pan[OS_LD + tx], p2 = pan[2 * OS_LD + tx];
        for (int i = ty; i < mp; i += OS_ROWG) {
            const float* h = rc + 8 * i;
            const float* hb = hv + i * nbp;
            const int cx = 3 + 2 * (i / 2), cy = cx + 1;
            float acc = h[0] * p0 + h[1] * p1 + h[2] * p2;
            if (cx < rp) acc += h[3] * pan[cx * OS_LD + tx];
            if (cy < rp) acc += h[4] * pan[cy * OS_LD + tx];
            float cpl = 0.f;
            for (int b = 0; b < nbp; ++b) cpl += hb[b] * vp[b * OS_W + tx];
            acc += cpl;
            f.g[(size_t)(nbp + i) * ldg + n] = n < f.d ? acc : 0.f;
        }
        for (int b = ty; b < nbp; b += OS_ROWG) f.g[(size_t)b * ldg + n] = vp[b * OS_W + tx];
    }
}

// The gains phase's split of a panel's -S^-1 pht rows over blocks: where
// the card has more blocks than panels, up to one part of 32 rows a block.
__host__ __device__ __forceinline__ int gain_parts(int grid, int npanel, int mp) {
    const int parts = grid / npanel;
    return parts < 1 ? 1 : (parts > mp / 32 ? mp / 32 : parts);
}

// --- phase 3: the gains of 16-column panels: MG = [B vtf; -S^-1 pht] and
//     the mean ---
__device__ __forceinline__ void gain_phase(const Frame& f, float* smem) {
    const int tid = threadIdx.x, mp = f.mp, nbp = f.nbp, ldg = f.ldg, sl = mp + 4;
    const int npanel = (ldg + OS_W - 1) / OS_W;
    const int parts = gain_parts(gridDim.x, npanel, mp);
    const int groups = gridDim.x / parts;
    const int part = blockIdx.x % parts, group = blockIdx.x / parts;
    if (group >= groups || group >= npanel) return;
    const int kpart = (mp + parts - 1) / parts;
    const int k0 = part * kpart, k1 = min(mp, k0 + kpart);
    float* si_s = smem;                // (k1 - k0, mp + 4) rows k0 .. k1 - 1 of S^-1
    float* pht_s = si_s + kpart * sl;  // (mp, OS_W) the panel of pht
    float* part_s = pht_s + mp * OS_W; // (OS_THREADS,) partial sums of the mean
    float* siv_s = part_s + OS_THREADS;  // (mp,)
    for (int e = tid; e < (k1 - k0) * (mp / 4); e += OS_THREADS) {
        const int i = e / (mp / 4), c = 4 * (e % (mp / 4));
        csl_cp_async16(si_s + i * sl + c, f.si + (size_t)(k0 + i) * mp + c, true);
    }
    if (part == 0) stage_cg(siv_s, f.siv, mp);
    const int tx = tid % OS_W, ty = tid / OS_W;
    for (int panel = group; panel < npanel; panel += groups) {
        const int c0 = panel * OS_W, n = c0 + tx;
        __syncthreads();               // the last panel's readers are done
        for (int e = tid; e < mp * (OS_W / 4); e += OS_THREADS) {
            const int i = e / (OS_W / 4), c = 4 * (e % (OS_W / 4));
            const bool in = c0 + c < ldg;   // ldg % 4 == 0: four columns all in or all out
            csl_cp_async16(pht_s + i * OS_W + c, in ? f.g + (size_t)(nbp + i) * ldg + c0 + c : f.g,
                           in);
        }
        csl_cp_async_commit();
        csl_cp_async_wait<0>();
        __syncthreads();

        // MG rows nbp + k, k in this block's part: -sum_i S^-1[k, i]
        // pht[i, n], one fmaf chain over i in order.
        for (int k = k0 + ty; k < k1; k += OS_ROWG) {
            const float* sk = si_s + (k - k0) * sl;
            float acc = 0.f;
#pragma unroll 8
            for (int i = 0; i < mp; ++i) acc = fmaf(sk[i], pht_s[i * OS_W + tx], acc);
            if (n < ldg) f.mg[(size_t)(nbp + k) * ldg + n] = -acc;
        }
        if (part != 0) continue;
        // MG rows b < nbp: (B vtf)[b, n] = sum_j B[b, j] vtf[j, n], from G's
        // rows 0 .. nbp - 1 (phase 2's copy of vtf, zero past column d).
        for (int b = ty; b < nbp; b += OS_ROWG) {
            float acc = 0.f;
            if (n < ldg)
                for (int j = 0; j < nbp; ++j)
                    acc = fmaf(__ldg(f.bmat + (size_t)b * nbp + j), __ldcg(f.g + (size_t)j * ldg + n),
                               acc);
            if (n < ldg) f.mg[(size_t)b * ldg + n] = acc;
        }
        float xs = 0.f;
        for (int i = ty; i < mp; i += OS_ROWG) xs += siv_s[i] * pht_s[i * OS_W + tx];
        part_s[tid] = xs;
        __syncthreads();
        if (ty == 0 && n < f.d) {
            float s = 0.f;
            for (int r = 0; r < OS_ROWG; ++r) s += part_s[r * OS_W + tx];
            const float v = f.x[n] + s;
            f.xn[n] = n == 2 ? csl_wrap(v) : v;
        }
    }
}

// --- phase 4: out = P + G^T MG over the upper-triangle tiles, mirrored ---
template <int T, bool VECP>
__device__ __forceinline__ void p_pass(const Frame& f, float* smem) {
    using C = csl_rank::Cfg<T>;
    constexpr int GROUPS = OS_THREADS / C::NT;
    const int group = threadIdx.x / C::NT, gtid = threadIdx.x % C::NT;
    float* ring = smem + group * C::SMEM_FLOATS;
    const int nt = (f.d + T - 1) / T, ntiles = nt * (nt + 1) / 2;
    const csl_rank::GroupSync sync{1 + group, C::NT};
    for (int t = blockIdx.x * GROUPS + group; t < ntiles; t += gridDim.x * GROUPS) {
        int ti, tj;
        csl_rank::tile_ij(t, nt, &ti, &tj);
        csl_rank::tile<T, true, VECP>(f.p, f.g, f.mg, f.p_out, f.d, f.ldg, f.nbp + f.mp, ti * T,
                                      tj * T, ring, gtid, sync);
    }
}

template <int RX, int TILE>
__global__ void __launch_bounds__(OS_THREADS, 1)
obs_step_kernel(const __grid_constant__ Frame f) {
    extern __shared__ __align__(16) float smem[];
    __shared__ int rows[OS_MAX_RP];
    __shared__ int wmax[OS_THREADS / 32];
    cg::grid_group grid = cg::this_grid();
    stamp(f, 0, false);
    for (int a = threadIdx.x; a < f.rp; a += OS_THREADS) rows[a] = gathered_row(f, a);
    __syncthreads();

    // Every block reaches every grid barrier: no phase returns from the kernel.
    if ((int)blockIdx.x < f.mp / OS_BAND) chain_phase(f, smem, rows);
    stamp(f, 1, true);
    grid.sync();
    stamp(f, 2, false);

    if (blockIdx.x == 0) sweep_phase<RX>(f, smem, wmax);
    if (blockIdx.x > 0 || gridDim.x == 1)
        pht_phase(f, smem, rows, gridDim.x > 1 ? blockIdx.x - 1 : 0,
                  gridDim.x > 1 ? gridDim.x - 1 : 1);
    stamp(f, 3, true);
    grid.sync();
    stamp(f, 4, false);

    gain_phase(f, smem);
    stamp(f, 5, true);
    grid.sync();
    stamp(f, 6, false);

    if (f.vecp) p_pass<TILE, true>(f, smem);
    else p_pass<TILE, false>(f, smem);
    stamp(f, 7, true);
}

// Dynamic shared memory (floats): the largest of the phases' needs.
inline size_t smem_floats(int mp, int rp, int nbp, int tile) {
    const int w = 32 * ((mp + 31) / 32);
    size_t fl = (size_t)csl_obs_smem_floats(mp, rp, nbp, OS_BAND);
    fl = std::max(fl, csl_sweep::smem_bytes(mp, w) / sizeof(float));
    fl = std::max(fl, (size_t)(8 * mp + mp * nbp + rp * OS_LD + nbp * OS_W));
    fl = std::max(fl, (size_t)(mp * (mp + 4) + mp * OS_W + OS_THREADS + mp));
    const size_t ring = tile == 128 ? (size_t)2 * csl_rank::Cfg<128>::SMEM_FLOATS
                                    : (size_t)(OS_THREADS / 64) * csl_rank::Cfg<32>::SMEM_FLOATS;
    return std::max(fl, ring);
}

constexpr int MAX_DEVICES = 64;
constexpr int VARIANTS = OS_MAX_MP / 32;      // RX = 1 .. 7

// Per device, cached on first use: the SM count, and each variant's static
// shared memory (its dynamic cap raised once) and its last occupancy query;
// variant (RX, TILE) at [RX][TILE == 128].
struct DeviceInfo {
    int sms = 0;
    int static_bytes[VARIANTS + 1][2] = {};
    bool raised[VARIANTS + 1][2] = {};
    size_t occ_smem[VARIANTS + 1][2] = {};
    int occ[VARIANTS + 1][2] = {};
};
inline DeviceInfo g_info[MAX_DEVICES];

// The P pass's tile edge at D = d: 128 where D has at least 8 such
// upper-triangle tiles an SM, else 32 (H4's rule, rank_update.cu).
inline int pass_tile(int d, int sms) {
    const int n = (d + 127) / 128;
    return n * (n + 1) / 2 >= 8 * sms ? 128 : 32;
}

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

// The grid and shared memory of variant (RX, TILE) for (mp, rp, nbp): one
// block an SM, after checking that a block of OS_THREADS with that shared
// memory fits an SM at all (the cooperative launch needs every block
// resident).
template <int RX, int TILE>
cudaError_t plan(int mp, int rp, int nbp, int* grid, size_t* smem) {
    constexpr int V = TILE == 128 ? 1 : 0;
    DeviceInfo* pinfo = nullptr;
    cudaError_t err = device_info(&pinfo);
    if (err != cudaSuccess) return err;
    DeviceInfo& info = *pinfo;
    const auto fn = obs_step_kernel<RX, TILE>;
    if (!info.raised[RX][V]) {
        cudaFuncAttributes attr;
        err = cudaFuncGetAttributes(&attr, fn);
        if (err != cudaSuccess) return err;
        info.static_bytes[RX][V] = (int)attr.sharedSizeBytes;
        err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   CSL_MAX_SMEM - (int)attr.sharedSizeBytes);
        if (err != cudaSuccess) return err;
        info.raised[RX][V] = true;
    }
    *smem = smem_floats(mp, rp, nbp, TILE) * sizeof(float);
    if (*smem + info.static_bytes[RX][V] > CSL_MAX_SMEM) return cudaErrorInvalidValue;
    if (info.occ_smem[RX][V] != *smem) {
        int occ = 0;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, OS_THREADS, *smem);
        if (err != cudaSuccess) return err;
        info.occ[RX][V] = occ;
        info.occ_smem[RX][V] = *smem;
    }
    if (info.occ[RX][V] < 1) return cudaErrorCooperativeLaunchTooLarge;
    *grid = info.sms;
    return cudaSuccess;
}

template <int RX, int TILE>
cudaError_t launch_tile(const Frame& f, cudaStream_t stream) {
    int grid = 0;
    size_t smem = 0;
    cudaError_t err = plan<RX, TILE>(f.mp, f.rp, f.nbp, &grid, &smem);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(OS_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, obs_step_kernel<RX, TILE>, f);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

// The variants on tiles of 128 (obs_step_big.cu): plan and launch for the
// run-time RX = mp / 32.
cudaError_t plan_big(int rx, int mp, int rp, int nbp, int* grid, size_t* smem);
cudaError_t launch_big(int rx, const Frame& f, cudaStream_t stream);

}  // namespace csl_h10
