// Device code shared by the two one-launch frames, H9 (frame_step.cu, the
// known frame) and H10 (obs_step.cu, the gated frame): the pieces of their
// cooperative frame kernels that do not depend on how the frame forms G and
// MG, and their second launch, the P pass.  One routine for both.
//
// Each frame runs as TWO launches on one stream: the cooperative frame
// kernel, then the P pass out = P + G^T MG over the upper-triangle tiles of
// rank_tile.cuh (each mirrored: P comes out exactly symmetric whenever it
// goes in exactly symmetric), at H4's tile edge for that D: 32-tiles one
// 64-thread block a tile, 12 or 13 blocks resident an SM, as H4's; at large
// D 128-tiles two at a time in a persistent 512-thread block (PassShape).
// The frame kernel cannot hold the 32-tile occupancy itself: its blocks are
// 512 threads for the sweep's register layout.  The pass is launched with the programmatic-stream-serialization
// attribute: the frame kernel lets it launch (griddepcontrol.launch_dependents)
// once every block has passed its last grid barrier, and each pass block
// waits (griddepcontrol.wait) until the frame kernel is complete and its
// writes visible, so the pass's launch overlaps the frame kernel's last
// phase.  The pass reads P evict-first (ld.cs), so that its stream of P does
// not push the frame kernel's code and state out of the L2 between frames.
#pragma once

#include <algorithm>

#include "rank_tile.cuh"

namespace csl_res {

__device__ __forceinline__ unsigned long long globaltimer() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

// nblk = last valid slot + 1 (ops/frame_kernel.py _pack_meas), in every
// thread of a block of NT threads; wmax holds NT / 32 ints.
template <int NT>
__device__ __forceinline__ int last_valid_slot(const unsigned char* mask, int mask_st, int nz,
                                               int* wmax) {
    const int tid = threadIdx.x;
    int nb = 0;
    for (int l = tid; l < nz; l += NT)
        if (mask[(size_t)l * mask_st]) nb = l + 1;
    nb = __reduce_max_sync(0xffffffffu, nb);
    if ((tid & 31) == 0) wmax[tid >> 5] = nb;
    __syncthreads();
    nb = 0;
    for (int w = 0; w < NT / 32; ++w) nb = max(nb, wmax[w]);
    return nb;
}

// The units of block b > 0 (block 0 sweeps): first = b - 1, first +
// workers, ..., last, below nunits; last = -1 if it has none.
struct Units {
    int first, workers, last;
};

__device__ __forceinline__ Units block_units(int nunits) {
    Units u;
    u.workers = gridDim.x - 1;
    u.first = (int)blockIdx.x - 1;
    u.last = u.first < nunits ? u.first + ((nunits - 1 - u.first) / u.workers) * u.workers : -1;
    return u;
}

// A one-arrival mbarrier in shared memory, armed for `bytes` of one bulk
// copy, and the copy: n bytes (n % 16 == 0, 16-byte aligned ends) from
// device memory into shared memory by the tensor memory accelerator.  The
// caller (one thread) fences first: the barriers' init, and the generic
// proxy's earlier accesses to both ends, against the async proxy's.
__device__ __forceinline__ void bulk_load(float* dst, const float* src, unsigned bytes,
                                          unsigned long long* bar) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(csl_smem_addr(bar)),
                 "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
            csl_smem_addr(dst)),
        "l"(src), "r"(bytes), "r"(csl_smem_addr(bar))
        : "memory");
}

// Wait for phase 0 of the mbarrier (its one bulk copy landed).
__device__ __forceinline__ void bulk_wait(unsigned long long* bar) {
    unsigned done = 0;
    while (!done)
        asm volatile(
            "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
            " selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(csl_smem_addr(bar))
            : "memory");
}

// Thread 0 of a block: initialise RX one-arrival mbarriers and bring S^-1
// (mp = 32 RX rows of mp floats, stored earlier in this launch by the
// generic proxy) into si_s by bulk copies of 32 rows, one mbarrier each.
// The block's other threads touch neither si_s nor the barriers before a
// __syncthreads() past this call; each chunk c is then waited for with
// bulk_wait(bar + c).
template <int RX>
__device__ __forceinline__ void bulk_load_si(float* si_s, const float* si, int mp,
                                             unsigned long long* bar) {
#pragma unroll
    for (int c = 0; c < RX; ++c)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(csl_smem_addr(bar + c))
                     : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // S^-1 was stored by block 0 (the generic proxy) before the last grid
    // barrier, and this shared memory last held the generic proxy's data.
    asm volatile("fence.proxy.async;\n" ::: "memory");
#pragma unroll
    for (int c = 0; c < RX; ++c)
        bulk_load(si_s + 32 * c * mp, si + 32 * c * mp, 32u * mp * 4u, bar + c);
}

// siv_j = sum_i v_i S^-1[i, j] for j < mp, one fmaf chain over i in order a
// column, by the block's threads first .. first + mp - 1; si has row
// stride ld.
__device__ __forceinline__ void siv_chain(const float* si, int ld, const float* v, float* siv,
                                          int mp, int first) {
    const int j = (int)threadIdx.x - first;
    if (j < 0 || j >= mp) return;
    float acc = 0.f;
#pragma unroll 8
    for (int i = 0; i < mp; ++i) acc = fmaf(v[i], si[i * ld + j], acc);
    siv[j] = acc;
}

// Block 0 after its sweep (csl_sweep::inverse left the swept tile ts, (mp,
// mp + 1), and its scales in shared memory; `bad` its non-finite flag), by
// its NT threads: the tile becomes S^-1 in place, then siv = v^T S^-1 (the
// gains blocks' bits, siv_chain) and the NIS = siv v into siv_out[0 .. mp)
// and nis_out[0].  v and sv are two free (mp,) arrays of shared memory,
// rowc the chain's per-row coefficients (v in column 7).
template <int RX, int NT>
__device__ __forceinline__ void swept_siv_nis(float* ts, int mp, const float* rowc, float* v,
                                              float* sv, bool bad, float* siv_out,
                                              float* nis_out) {
    const int tid = threadIdx.x, tp = mp + 1;
    const float* dsc = ts + mp * tp;
    for (int i = tid; i < mp; i += NT) v[i] = __ldcg(rowc + 8 * i + 7);
    // S^-1[i, j] = 0.5 (x_ij + x_ji), x_ij = -A_ij dsc_i dsc_j, as the
    // sweep's store forms it (the same bits), or 0 where the sweep zeroed
    // S^-1; one thread forms and writes both (i, j) and (j, i).
    const int tx = tid & 31;
#pragma unroll 2
    for (int i = tid >> 5; i < mp; i += NT / 32)
#pragma unroll
        for (int b = 0; b < RX; ++b) {
            const int j = tx + 32 * b;
            if (j >= i && j < mp) {
                const float xij = __fmul_rn(__fmul_rn(-ts[i * tp + j], dsc[i]), dsc[j]);
                const float xji = __fmul_rn(__fmul_rn(-ts[j * tp + i], dsc[j]), dsc[i]);
                const float sij = bad ? 0.f : 0.5f * __fadd_rn(xij, xji);
                ts[i * tp + j] = sij;
                ts[j * tp + i] = sij;
            }
        }
    __syncthreads();
    siv_chain(ts, tp, v, sv, mp, 0);
    __syncthreads();
    if (tid < mp) siv_out[tid] = sv[tid];
    if (tid < 32) {
        float s = 0.f;
        for (int j = tid; j < mp; j += 32) s += sv[j] * v[j];
        for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
        if (tid == 0) nis_out[0] = s;
    }
}

// --- the second launch: out = P + G^T MG over the upper-triangle tiles of
//     edge T, mirrored, P read evict-first ---
//
// Its shape at tile edge T: at 32, one H4 tile a block (Cfg<32>: 64
// threads and a 16 KB ring, 12 or 13 blocks resident an SM), one block a
// tile; at 128, two tiles at a time in a 512-thread block, one on each half
// with its own named barrier, one block an SM, persistent (H4's Cfg<128>
// as one 256-thread block a tile, 2 an SM, spills 104 bytes a thread under
// the same 128-register budget and took 6% longer at the 10k-landmark
// shape, PERF.md).
template <int T>
struct PassShape {
    static constexpr int TILES = T == 128 ? 2 : 1;               // tiles a block at a time
    static constexpr int NT = TILES * csl_rank::Cfg<T>::NT;      // threads a block
    static constexpr int MIN_BLOCKS = TILES == 1 ? csl_rank::Cfg<T>::MIN_BLOCKS : 1;
};

// The body of a frame's P-pass kernel (each frame declares its own
// __global__ kernel around it, with __launch_bounds__(PassShape<T>::NT,
// PassShape<T>::MIN_BLOCKS), so that a profile tells the two frames apart).
// stamps, when not null, are the pass's rows of the frame's stamps (row
// stride `stride`): each block writes [b, 0] as it starts its tiles (past
// its wait for the frame kernel) and [b, 1] when done.
template <int T, bool VECP>
__device__ __forceinline__ void pass_tiles(const float* __restrict__ p, const float* __restrict__ g,
                                           const float* __restrict__ mg, float* __restrict__ out,
                                           int d, int ldg, int r, int nt, int ntiles,
                                           unsigned long long* stamps, int stride) {
    using C = csl_rank::Cfg<T>;
    constexpr int TILES = PassShape<T>::TILES;
    extern __shared__ __align__(16) float smem[];
    // The frame kernel is complete and its G and MG visible (a no-op when
    // this launch was not made dependent on it).
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    if (stamps != nullptr && threadIdx.x == 0) stamps[(size_t)blockIdx.x * stride] = globaltimer();
    if constexpr (TILES == 1) {
        for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
            int ti, tj;
            csl_rank::tile_ij(tile, nt, &ti, &tj);
            csl_rank::tile<T, true, VECP, csl_rank::BlockSync, true, true>(
                p, g, mg, out, d, ldg, r, ti * T, tj * T, smem, threadIdx.x, csl_rank::BlockSync{});
        }
    } else {
        const int group = threadIdx.x / C::NT, gtid = threadIdx.x % C::NT;
        const csl_rank::GroupSync sync{1 + group, C::NT};
        for (int tile = blockIdx.x * TILES + group; tile < ntiles; tile += gridDim.x * TILES) {
            int ti, tj;
            csl_rank::tile_ij(tile, nt, &ti, &tj);
            csl_rank::tile<T, true, VECP, csl_rank::GroupSync, true, true>(
                p, g, mg, out, d, ldg, r, ti * T, tj * T, smem + group * C::SMEM_FLOATS, gtid, sync);
        }
    }
    if (stamps != nullptr) {
        __syncthreads();
        if (threadIdx.x == 0) stamps[(size_t)blockIdx.x * stride + 1] = globaltimer();
    }
}

// The P pass's plan at D = d.  At tile edge 32, one block a tile: the
// hardware hands out the tiles as blocks retire, so the blocks that become
// resident early (on the SMs whose frame-kernel block left first, before
// the frame kernel ends) take no larger share of the tiles than the others;
// persistent blocks, as H4 plans them, would.  Where P has fewer tiles than
// the card holds blocks at once (D 1024 has 528 tiles of 32, 4 an SM), the
// SMs that the frame kernel frees first would take every tile, up to the
// kernel's occupancy each, and leave the rest idle: there each block asks
// for an SM's shared memory over ceil(tiles / SMs), so that no SM holds
// more blocks than that and the tiles spread over every SM.  At 128 (at
// least 8 tiles an SM, H4's rule), one persistent block an SM.
struct PassPlan {
    int grid, nt, ntiles;
    size_t smem;    // dynamic shared memory a block: the rings, or more to spread the tiles
    int occ;        // blocks an SM
};

// Per device and pass kernel, cached on first use: its blocks an SM at its
// rings (the occupancy query), the SM count, an SM's shared memory and a
// block's reserved part, and whether its dynamic shared memory cap was
// raised past the rings.
struct PassInfo {
    int occ = 0, sms = 0, smem_sm = 0, reserved = 0;
    bool raised = false;
};

template <int T>
constexpr size_t pass_smem_bytes() {
    return PassShape<T>::TILES * csl_rank::Cfg<T>::SMEM_FLOATS * sizeof(float);
}

template <int T, typename Kernel>
cudaError_t plan_pass(Kernel kernel, int d, PassInfo* info, PassPlan* plan) {
    constexpr size_t ring = pass_smem_bytes<T>();
    cudaError_t err = cudaSuccess;
    if (info->occ == 0) {
        int dev = 0;
        err = cudaGetDevice(&dev);
        if (err == cudaSuccess) err = cudaDeviceGetAttribute(&info->sms, cudaDevAttrMultiProcessorCount, dev);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(&info->smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(&info->reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
        if (err == cudaSuccess) err = csl_allow_smem(kernel, ring);
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info->occ, kernel, PassShape<T>::NT,
                                                                ring);
        if (err != cudaSuccess) return err;
        if (info->occ < 1) return cudaErrorInvalidConfiguration;
    }
    plan->nt = (d + T - 1) / T;
    plan->ntiles = plan->nt * (plan->nt + 1) / 2;
    plan->smem = ring;
    plan->occ = info->occ;
    if (PassShape<T>::TILES > 1) {
        plan->grid = info->sms * info->occ;
        return cudaSuccess;
    }
    plan->grid = plan->ntiles;
    const int per_sm = (plan->ntiles + info->sms - 1) / info->sms;
    if (per_sm < info->occ) {
        const size_t spread = ((size_t)(info->smem_sm / per_sm - info->reserved)) & ~(size_t)1023;
        plan->smem = std::max(ring, std::min(spread, (size_t)CSL_MAX_SMEM));
        plan->occ = per_sm;
        if (plan->smem > ring && !info->raised) {
            err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       CSL_MAX_SMEM);
            if (err != cudaSuccess) return err;
            info->raised = true;
        }
    }
    return cudaSuccess;
}

// Launch the pass `kernel` (pass_tiles<T, VECP> inside) at `plan` on
// `stream`, right behind the frame kernel, as its programmatic dependent.
template <int T, typename Kernel>
cudaError_t launch_pass(Kernel kernel, const PassPlan& plan, const float* p, const float* g,
                        const float* mg, float* out, int d, int ldg, int r,
                        unsigned long long* stamps, cudaStream_t stream) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(plan.grid);
    cfg.blockDim = dim3(PassShape<T>::NT);
    cfg.dynamicSmemBytes = plan.smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, kernel, p, g, mg, out, d, ldg, r, plan.nt, plan.ntiles, stamps);
}

}  // namespace csl_res
