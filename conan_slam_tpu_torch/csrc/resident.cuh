// Device code shared by the two one-launch frames, H9 (frame_step.cu, the
// known frame) and H10 (obs_step.cu, the gated frame): the pieces of their
// cooperative frame kernels that do not depend on how the frame forms G and
// MG, and their second launch, the P pass.  One routine for both.
//
// Each frame runs as TWO launches on one stream: the cooperative frame
// kernel, then the P pass out = P + G^T MG over upper-triangle tiles (each
// mirrored: P comes out exactly symmetric whenever it goes in exactly
// symmetric), on the route D and the SM count choose (pass_route): H4's
// 32-tiles of rank_tile.cuh, one 64-thread block a tile, 12 or 13 blocks
// resident an SM; at large D streamed 128-tiles, one persistent block an SM
// that brings P in and out by tensor copies under its FMAs (stream_tiles).
// The frame kernel cannot hold the 32-tile occupancy itself: its blocks are
// 512 threads for the sweep's register layout.  The pass is launched with the programmatic-stream-serialization
// attribute: the frame kernel lets it launch (griddepcontrol.launch_dependents)
// once every block has passed its last grid barrier, and each pass block
// waits (griddepcontrol.wait) until the frame kernel is complete and its
// writes visible, so the pass's launch overlaps the frame kernel's last
// phase.  The pass reads and writes P evict-first, so that its stream of P
// does not push the strips, the frame kernel's code and its state out of
// the L2.
#pragma once

#include <cuda.h>

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

// --- the second launch: out = P + G^T MG over the upper-triangle tiles,
//     mirrored, P read and written evict-first ---
//
// Its routes (PassShape<R>):
//   PASS_32    H4's 32-tiles (Cfg<32>: 64 threads and a 16 KB ring a block,
//              12 or 13 resident an SM), one block a tile;
//   PASS_128   streamed 128-tiles (stream_tiles), one persistent block an
//              SM.
// pass_route picks PASS_128 where D gives at least PASS_TILES_AN_SM
// upper-triangle tiles of PASS_BIG an SM (H4's rule for its tile edge,
// rank_update.cu) and P's rows take 16-byte copies, else PASS_32: at
// smaller D 128-tiles would leave SMs empty.
#define PASS_SMALL 32           // PASS_32's tile edge
#define PASS_BIG 128            // PASS_128's tile edge
#define PASS_TILES_AN_SM 8      // PASS_128 from this many tiles of PASS_BIG an SM
#define SP_THREADS 352          // PASS_128: 8 consumer warps, the strips', P's and out's warps
#define SP_BK 16                // PASS_128: rows of G and of MG a stage of the strips' ring
#define SP_STAGES 4             // PASS_128: the strips' ring's stages
#define SP_SLOTS 5              // PASS_128: P's ring's half-blocks (64 x 128)

constexpr int PASS_32 = PASS_SMALL, PASS_128 = PASS_BIG;

template <int R>
struct PassShape {
    static_assert(R == PASS_32 || R == PASS_128, "a P-pass route");
    static constexpr int TILE = R;                                     // tile edge
    static constexpr int NT = R == PASS_128 ? SP_THREADS : csl_rank::Cfg<PASS_SMALL>::NT;
    static constexpr int MIN_BLOCKS = R == PASS_32 ? csl_rank::Cfg<PASS_SMALL>::MIN_BLOCKS : 1;
    static constexpr bool PERSISTENT = R == PASS_128;                  // one block an SM
};

// P's rows take 16-byte accesses: d % 4 == 0, P and out 16-byte aligned.
inline bool pass_vec(const float* p, const float* out, int d) {
    return d % 4 == 0 && !(reinterpret_cast<size_t>(p) & 15u) && !(reinterpret_cast<size_t>(out) & 15u);
}

// The P pass's route at D = d on a card of `sms` SMs; vec: pass_vec.
inline int pass_route(int d, int sms, bool vec) {
    const long long n = (d + PASS_BIG - 1) / PASS_BIG;
    return vec && n * (n + 1) / 2 >= (long long)PASS_TILES_AN_SM * sms ? PASS_128 : PASS_32;
}

// The tensor maps of P and out (D x D, boxes of 32 columns x 64 rows in the
// 128-byte swizzle) and of the strips G and MG (r x ldg, boxes of 128
// columns x SP_BK rows), all fp32 (PASS_128's; the other routes take them
// unread).
struct PassMaps {
    CUtensorMap p, out, g, mg;
};

// --- PASS_128: streamed 128-tiles ---
//
// What bounds it: at the 10k-landmark shape (D 20,224, r = MP + 8 = 136)
// P's 3.27 GB in and out, 977 us at 3.35 TB/s, against the upper
// triangle's 5.6e10 fp32 flops, 830 us at 67 TFLOP/s.  So an SM has to
// keep P's stream running under its FMAs: per tile ~9 us of FMAs at the
// peak rate and ~10 us of its share of the HBM for 256 KB of P.  The
// 32-tiles cannot: each reads 35 KB of strips through the L2 for 16 KB of
// P, two 16-byte shared loads feed 16 FMAs, and a tile's P loads and
// stores wait behind its own short k-loop (2,550 us, PERF.md).
//
// One block an SM walks the tile list row by row with a static stride
// (Walk: tiles b, b + grid, ...; the SMs at a time share G[:, I] in the
// L2), warp-specialised:
//   - 8 consumer warps, 16 x 16 threads, each holding 8 x 8 outputs in
//     registers (rows 64 f + 4 ty + (0..3), columns 64 h + 4 tx + (0..3),
//     H4's Cfg<128> layout): 64 FMAs for four 16-byte shared loads.  Each
//     output is one fmaf chain over k in order from 0, as H4's tile; where
//     r is not a multiple of H4's 16 its tile ran its zero-filled rows as
//     fmaf(0, 0, acc) = acc + 0, and so does this one, once: the same
//     bits.  The epilogue adds the sums into P's half-blocks in shared
//     memory.
//   - the strips' warp (one thread) brings G's and MG's k-chunks of SP_BK
//     rows through a ring of SP_STAGES stages, two tensor copies a chunk;
//   - P's warp (one thread) brings P through a ring of SP_SLOTS half-blocks
//     of 64 x 128, a tile's four in order (P[I, J]'s rows 0-63 and 64-127,
//     then P[J, I]'s; a diagonal tile's first two), each by four tensor
//     copies (TMA) into its slot as soon as out's warp has stored the
//     slot's last half: the next tile's first halves land during this
//     tile's k-loop, so P's stream does not wait on a tile's epilogue.
//   - out's warp (one thread) stores each half by four tensor copies once
//     its sums are in, while the consumers go on.
// Both evict-first; the tensor maps clip a ragged edge (zeros in, nothing
// out).  A half lies in shared memory as four boxes of 64 rows x 32
// columns in the 128-byte swizzle (sw(): 16 bytes c of row v at c ^ (v %
// 8)): P[I, J]'s adds (8 threads a phase along a row) and P[J, I]'s
// (rows 4 apart, each thread's 4 rows taken in an order rotated by tx / 2)
// fall on 8 distinct 16-byte bank groups.  In a half P[I, J] rows 64 f +
// ... hold the outputs of every thread's acc rows 4 f .. 4 f + 3, P[J,
// I]'s half h its acc columns 4 h .. 4 h + 3: each half is every thread's,
// added as P + acc (P[J, I] + acc^T, a diagonal tile's two halves
// together, element by element, its lower half from its upper half).
// Every copy is a tensor copy: the designs that moved P or the strips a
// 512-byte row at a time (one bulk copy, or one cp.async warp instruction
// a row) or stored out from the consumers' registers took 1,835-2,620 us
// at the 10k shape, this one ~1,500 (PERF.md).  The rings' sizes are the
// measured best of SP_BK 8 or 16, 2-6 stages and 4-6 slots.  Nothing is
// summed by atomics; the output is bit for bit H4's tiles'.
namespace csl_sp {

constexpr int T = PASS_BIG, BK = SP_BK, STAGES = SP_STAGES, SLOTS = SP_SLOTS;
constexpr int CONSUMERS = 256;                 // 16 x 16 threads, 8 x 8 outputs each
constexpr int STAGE_FLOATS = 2 * BK * T;       // a chunk of G's rows, then MG's
constexpr int HALF = T / 2;                    // rows a half-block
constexpr int HALF_FLOATS = HALF * T;          // four 8 KB boxes of HALF x 32
constexpr int BARS = 2 * STAGES + 3 * SLOTS;   // a stage full, empty; a slot's P landed, sums added, out stored
constexpr size_t SMEM = 1024 + (size_t)(STAGES * STAGE_FLOATS + SLOTS * HALF_FLOATS) * sizeof(float) +
                        BARS * sizeof(unsigned long long);
static_assert(SP_THREADS == CONSUMERS + 96, "the consumers, the strips' warp, P's, out's");
static_assert(SLOTS >= 4 && SLOTS <= 8, "a tile's four halves and some of the next");
static_assert(csl_rank::BK % BK == 0, "whole chunks of H4's");
static_assert(STAGES * STAGE_FLOATS * sizeof(float) % 1024 == 0, "the halves 1024-byte aligned");
static_assert(SMEM <= CSL_MAX_SMEM, "the rings fit one block");

// Element (v, c) of a half: box c / 32, 16 bytes (c / 4) % 8 of its row v
// at (c / 4 % 8) ^ (v % 8), as the tensor copies' 128-byte swizzle lays it.
__device__ __forceinline__ int sw(int v, int c) {
    return ((c >> 5) << 11) + (v << 5) + ((((c >> 2) & 7) ^ (v & 7)) << 2) + (c & 3);
}

__device__ __forceinline__ void bar_init(unsigned long long* bar, unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(csl_smem_addr(bar)), "r"(count)
                 : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned long long* bar, unsigned parity) {
    unsigned done = 0;
    while (!done)
        asm volatile(
            "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(csl_smem_addr(bar)), "r"(parity)
            : "memory");
}

__device__ __forceinline__ void bar_arrive(unsigned long long* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(csl_smem_addr(bar)) : "memory");
}

// The one arrival of a landed barrier, armed for `bytes` of tensor copies.
__device__ __forceinline__ void bar_expect(unsigned long long* bar, unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(csl_smem_addr(bar)),
                 "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ unsigned long long evict_first() {
    unsigned long long pol;
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(pol));
    return pol;
}

// The box at (column c0, row r0) of `map` into shared memory at dst,
// completing on bar.
__device__ __forceinline__ void box_in(float* dst, const CUtensorMap* map, int c0, int r0,
                                       unsigned long long* bar, unsigned long long pol) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
        " [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(csl_smem_addr(dst)),
        "l"(reinterpret_cast<unsigned long long>(map)), "r"(c0), "r"(r0), "r"(csl_smem_addr(bar)),
        "l"(pol)
        : "memory");
}

// The box of shared memory at src to (column c0, row r0) of `map`, in this
// thread's open bulk group.
__device__ __forceinline__ void box_out(const CUtensorMap* map, int c0, int r0, const float* src,
                                        unsigned long long pol) {
    asm volatile(
        "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group.L2::cache_hint [%0, {%1, %2}], [%3], %4;\n" ::"l"(
            reinterpret_cast<unsigned long long>(map)),
        "r"(c0), "r"(r0), "r"(csl_smem_addr(src)), "l"(pol)
        : "memory");
}

// Block b's walk over the row-by-row upper-triangle list of nt x nt tiles
// (tile_ij's order): tiles b, b + grid, b + 2 grid, ... below ntiles.
struct Walk {
    int tile, ti, tj;
    __device__ __forceinline__ Walk(int nt, int ntiles) : tile(blockIdx.x), ti(0), tj(0) {
        if (tile < ntiles) csl_rank::tile_ij(tile, nt, &ti, &tj);
    }
    __device__ __forceinline__ void next(int nt) {
        tile += gridDim.x;
        tj += gridDim.x;
        while (ti < nt && tj >= nt) {     // past row ti's end: on into row ti + 1, from ti + 1
            tj -= nt;
            ++ti;
            tj += ti;
        }
    }
};

// Half h (0-3) of the tile at (i0, j0): its first row and column in P.
__device__ __forceinline__ void half_at(int h, int i0, int j0, int* r0, int* c0) {
    *r0 = (h < 2 ? i0 : j0) + HALF * (h & 1);
    *c0 = h < 2 ? j0 : i0;
}

// One row kk of a stage: acc[a][b] += G[k, i_a] MG[k, j_b].
__device__ __forceinline__ void fma_row(float (&acc)[8][8], const float* a, const float* b, int tx,
                                        int ty) {
    const float4 a0 = *reinterpret_cast<const float4*>(a + 4 * ty);
    const float4 a1 = *reinterpret_cast<const float4*>(a + 64 + 4 * ty);
    const float4 b0 = *reinterpret_cast<const float4*>(b + 4 * tx);
    const float4 b1 = *reinterpret_cast<const float4*>(b + 64 + 4 * tx);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
}

// acc[i][j0 + b] for a b known only at run time (selects, no local memory).
__device__ __forceinline__ float pick(const float (&acc)[8][8], int i, int j0, int b) {
    const float x01 = b & 1 ? acc[i][j0 + 1] : acc[i][j0];
    const float x23 = b & 1 ? acc[i][j0 + 3] : acc[i][j0 + 2];
    return b & 2 ? x23 : x01;
}

__device__ __forceinline__ void stream_tiles(const float* __restrict__ g, const float* __restrict__ mg,
                                             int d, int ldg, int r, int nt, int ntiles,
                                             const PassMaps& maps, float* smem) {
    float* ring = reinterpret_cast<float*>((reinterpret_cast<size_t>(smem) + 1023) & ~(size_t)1023);
    float* halves = ring + STAGES * STAGE_FLOATS;
    unsigned long long* landed = reinterpret_cast<unsigned long long*>(halves + SLOTS * HALF_FLOATS);
    unsigned long long* summed = landed + SLOTS;
    unsigned long long* stored = summed + SLOTS;
    unsigned long long* full = stored + SLOTS;
    unsigned long long* empty = full + STAGES;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    if (tid == 0) {
        for (int s = 0; s < SLOTS; ++s) {
            bar_init(landed + s, 1);
            bar_init(summed + s, CONSUMERS);
            bar_init(stored + s, 1);
        }
        for (int s = 0; s < STAGES; ++s) {
            bar_init(full + s, 1);
            bar_init(empty + s, CONSUMERS / 32);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    Walk w(nt, ntiles);
    const int nk = (r + BK - 1) / BK;

    if (warp == CONSUMERS / 32 + 2) {
        // The strips' warp: chunk c of a tile, G's rows c BK .. (columns I)
        // and MG's (columns J), into stage c % STAGES of the ring once the
        // consumers are done with its last chunk.
        if (lane != 0) return;
        for (int chunk = 0; w.tile < ntiles; w.next(nt))
            for (int c = 0; c < nk; ++c, ++chunk) {
                const int s = chunk % STAGES;
                if (chunk >= STAGES) bar_wait(empty + s, ((chunk / STAGES) + 1) & 1);
                float* st = ring + s * STAGE_FLOATS;
                bar_expect(full + s, STAGE_FLOATS * sizeof(float));
                box_in(st, &maps.g, w.ti * T, c * BK, full + s, 0x1000000000000000ull);
                box_in(st + BK * T, &maps.mg, w.tj * T, c * BK, full + s, 0x1000000000000000ull);
            }
    } else if (warp == CONSUMERS / 32) {
        // P's warp: half q into slot q % SLOTS once out's warp has stored
        // that slot's last (q - SLOTS).
        if (lane != 0) return;
        const unsigned long long pol = evict_first();
        for (int q = 0; w.tile < ntiles; w.next(nt)) {
            for (int h = 0; h < (w.ti == w.tj ? 2 : 4); ++h, ++q) {
                const int s = q % SLOTS;
                if (q >= SLOTS) bar_wait(stored + s, ((q / SLOTS) + 1) & 1);
                int r0, c0;
                half_at(h, w.ti * T, w.tj * T, &r0, &c0);
                bar_expect(landed + s, HALF_FLOATS * sizeof(float));
                for (int bx = 0; bx < T / 32; ++bx)
                    box_in(halves + s * HALF_FLOATS + bx * HALF * 32, &maps.p, c0 + 32 * bx, r0,
                           landed + s, pol);
            }
        }
    } else if (warp == CONSUMERS / 32 + 1) {
        // Out's warp: half q once its sums are in.
        if (lane != 0) return;
        const unsigned long long pol = evict_first();
        for (int q = 0; w.tile < ntiles; w.next(nt)) {
            for (int h = 0; h < (w.ti == w.tj ? 2 : 4); ++h, ++q) {
                const int s = q % SLOTS;
                bar_wait(summed + s, (q / SLOTS) & 1);
                int r0, c0;
                half_at(h, w.ti * T, w.tj * T, &r0, &c0);
                for (int bx = 0; bx < T / 32; ++bx)
                    box_out(&maps.out, c0 + 32 * bx, r0, halves + s * HALF_FLOATS + bx * HALF * 32, pol);
                asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
                asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
                bar_arrive(stored + s);
            }
        }
        asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    } else {
        const int tx = tid & 15, ty = tid >> 4;
        const int rot = (tx >> 1) & 3;      // the order of a thread's rows in P[J, I]'s halves
        for (int q = 0, chunk = 0; w.tile < ntiles; w.next(nt)) {
            const bool diag = w.ti == w.tj;
            float acc[8][8];
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
            for (int c = 0; c < nk; ++c, ++chunk) {
                const int s = chunk % STAGES, kn = min(BK, r - c * BK);
                bar_wait(full + s, (chunk / STAGES) & 1);
                const float* as = ring + s * STAGE_FLOATS;
                const float* bs = as + BK * T;
                if (kn == BK) {
#pragma unroll
                    for (int kk = 0; kk < BK; ++kk) fma_row(acc, as + kk * T, bs + kk * T, tx, ty);
                } else {
#pragma unroll 1
                    for (int kk = 0; kk < kn; ++kk) fma_row(acc, as + kk * T, bs + kk * T, tx, ty);
                }
                __syncwarp();
                if (lane == 0) bar_arrive(empty + s);
            }
            if (r % csl_rank::BK) {
#pragma unroll
                for (int i = 0; i < 8; ++i)
#pragma unroll
                    for (int j = 0; j < 8; ++j) acc[i][j] = __fadd_rn(acc[i][j], 0.f);
            }

            if (diag) {
                // Both halves of P[I, I]: (u, v) and (v, u), u <= v, from
                // acc's (u, v).
                float* h0 = halves + (q % SLOTS) * HALF_FLOATS;
                float* h1 = halves + ((q + 1) % SLOTS) * HALF_FLOATS;
                bar_wait(landed + q % SLOTS, (q / SLOTS) & 1);
                bar_wait(landed + (q + 1) % SLOTS, ((q + 1) / SLOTS) & 1);
                auto at = [&](int u, int v) -> float& { return (u < HALF ? h0 : h1)[sw(u & (HALF - 1), v)]; };
#pragma unroll
                for (int i = 0; i < 8; ++i)
#pragma unroll
                    for (int j = 0; j < 8; ++j) {
                        const int u = 64 * (i >> 2) + 4 * ty + (i & 3);
                        const int v = 64 * (j >> 2) + 4 * tx + (j & 3);
                        if (u <= v) at(u, v) = at(u, v) + acc[i][j];
                        if (u < v) at(v, u) = at(v, u) + acc[i][j];
                    }
                asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
                bar_arrive(summed + q % SLOTS);
                bar_arrive(summed + (q + 1) % SLOTS);
                q += 2;
                continue;
            }
            // P[I, J]'s halves f + acc's rows 4 f .. 4 f + 3; then P[J, I]'s
            // halves h + acc's columns 4 h .. 4 h + 3, transposed.
#pragma unroll
            for (int f = 0; f < 2; ++f, ++q) {
                float* hb = halves + (q % SLOTS) * HALF_FLOATS;
                bar_wait(landed + q % SLOTS, (q / SLOTS) & 1);
#pragma unroll
                for (int a = 0; a < 4; ++a)
#pragma unroll
                    for (int hh = 0; hh < 2; ++hh) {
                        float4* x = reinterpret_cast<float4*>(hb + sw(4 * ty + a, 64 * hh + 4 * tx));
                        const float4 o = *x;
                        const float* s = acc[4 * f + a] + 4 * hh;
                        *x = make_float4(o.x + s[0], o.y + s[1], o.z + s[2], o.w + s[3]);
                    }
                asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
                bar_arrive(summed + q % SLOTS);
            }
#pragma unroll
            for (int h = 0; h < 2; ++h, ++q) {
                float* hb = halves + (q % SLOTS) * HALF_FLOATS;
                bar_wait(landed + q % SLOTS, (q / SLOTS) & 1);
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    const int b = (k + rot) & 3;
#pragma unroll
                    for (int ff = 0; ff < 2; ++ff) {
                        float4* x = reinterpret_cast<float4*>(hb + sw(4 * tx + b, 64 * ff + 4 * ty));
                        const float4 o = *x;
                        *x = make_float4(o.x + pick(acc, 4 * ff, 4 * h, b), o.y + pick(acc, 4 * ff + 1, 4 * h, b),
                                         o.z + pick(acc, 4 * ff + 2, 4 * h, b),
                                         o.w + pick(acc, 4 * ff + 3, 4 * h, b));
                    }
                }
                asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
                bar_arrive(summed + q % SLOTS);
            }
        }
    }
}

}  // namespace csl_sp

// The body of a frame's P-pass kernel on route R (each frame declares its
// own __global__ kernel around it, with __launch_bounds__(PassShape<R>::NT,
// PassShape<R>::MIN_BLOCKS), so that a profile tells the two frames
// apart).  VECP: P's rows take 16-byte accesses (PASS_128 only with it).
// maps: P's and out's tensor maps (PASS_128's).  stamps, when not null,
// are the pass's rows of the frame's stamps (row stride `stride`): each
// block writes [b, 0] as it starts its tiles (past its wait for the frame
// kernel) and [b, 1] when done.
template <int R, bool VECP>
__device__ __forceinline__ void pass_tiles(const float* __restrict__ p, const float* __restrict__ g,
                                           const float* __restrict__ mg, float* __restrict__ out,
                                           int d, int ldg, int r, int nt, int ntiles,
                                           unsigned long long* stamps, int stride,
                                           const PassMaps& maps) {
    using S = PassShape<R>;
    static_assert(R != PASS_128 || VECP, "the streamed pass takes 16-byte P rows");
    extern __shared__ __align__(16) float smem[];
    // The frame kernel is complete and its G and MG visible (a no-op when
    // this launch was not made dependent on it).
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    if (stamps != nullptr && threadIdx.x == 0) stamps[(size_t)blockIdx.x * stride] = globaltimer();
    if constexpr (R == PASS_128) {
        csl_sp::stream_tiles(g, mg, d, ldg, r, nt, ntiles, maps, smem);
    } else {
        for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
            int ti, tj;
            csl_rank::tile_ij(tile, nt, &ti, &tj);
            csl_rank::tile<S::TILE, true, VECP, csl_rank::BlockSync, true, true>(
                p, g, mg, out, d, ldg, r, ti * S::TILE, tj * S::TILE, smem, threadIdx.x,
                csl_rank::BlockSync{});
        }
    }
    if (stamps != nullptr) {
        __syncthreads();
        if (threadIdx.x == 0) stamps[(size_t)blockIdx.x * stride + 1] = globaltimer();
    }
}

// The P pass's plan at D = d.  At PASS_32, one block a tile: the hardware
// hands out the tiles as blocks retire, so the blocks that become resident
// early (on the SMs whose frame-kernel block left first, before the frame
// kernel ends) take no larger share of the tiles than the others;
// persistent blocks, as H4 plans them, would.  Where P has fewer tiles than
// the card holds blocks at once (D 1024 has 528 tiles of 32, 4 an SM), the
// SMs that the frame kernel frees first would take every tile, up to the
// kernel's occupancy each, and leave the rest idle: there each block asks
// for an SM's shared memory over ceil(tiles / SMs), so that no SM holds
// more blocks than that and the tiles spread over every SM.  The
// persistent route, PASS_128 (at least 8 tiles an SM): one block an SM.
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

template <int R>
constexpr size_t pass_smem_bytes() {
    return R == PASS_128 ? csl_sp::SMEM : csl_rank::Cfg<PASS_SMALL>::SMEM_FLOATS * sizeof(float);
}

template <int R, typename Kernel>
cudaError_t plan_pass(Kernel kernel, int d, PassInfo* info, PassPlan* plan) {
    constexpr size_t ring = pass_smem_bytes<R>();
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
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info->occ, kernel, PassShape<R>::NT,
                                                                ring);
        if (err != cudaSuccess) return err;
        if (info->occ < 1) return cudaErrorInvalidConfiguration;
    }
    plan->nt = (d + PassShape<R>::TILE - 1) / PassShape<R>::TILE;
    plan->ntiles = plan->nt * (plan->nt + 1) / 2;
    plan->smem = ring;
    plan->occ = info->occ;
    if (PassShape<R>::PERSISTENT) {
        plan->grid = std::min(info->sms * info->occ, plan->ntiles);
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

// cuTensorMapEncodeTiled, from the driver through the runtime (no link
// against the driver library).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The tensor map of a rows x cols fp32 matrix at a (16-byte aligned, row
// stride ld, ld % 4 == 0) in boxes of box_cols x box_rows, zeros past the
// edge: P's and out's (D x D, 32 x 64, the 128-byte swizzle) or a strip's
// (r x ldg, 128 x SP_BK, no swizzle).
inline cudaError_t pass_map(CUtensorMap* map, const float* a, int rows, int cols, int ld, int box_cols,
                            int box_rows, CUtensorMapSwizzle swizzle) {
    static EncodeTiled encode = nullptr;
    if (encode == nullptr) {
        void* fn = nullptr;
        cudaDriverEntryPointQueryResult found;
        const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
        if (err != cudaSuccess) return err;
        if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
        encode = reinterpret_cast<EncodeTiled>(fn);
    }
    const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(float)};
    const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
    const cuuint32_t step[2] = {1, 1};
    const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(a), dims, strides,
                                box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Launch the pass `kernel` (pass_tiles<R, VECP> inside) at `plan` on
// `stream`, right behind the frame kernel, as its programmatic dependent.
template <int R, typename Kernel>
cudaError_t launch_pass(Kernel kernel, const PassPlan& plan, const float* p, const float* g,
                        const float* mg, float* out, int d, int ldg, int r,
                        unsigned long long* stamps, cudaStream_t stream) {
    PassMaps maps = {};
    if (R == PASS_128) {
        cudaError_t err = pass_map(&maps.p, p, d, d, d, 32, csl_sp::HALF, CU_TENSOR_MAP_SWIZZLE_128B);
        if (err == cudaSuccess)
            err = pass_map(&maps.out, out, d, d, d, 32, csl_sp::HALF, CU_TENSOR_MAP_SWIZZLE_128B);
        if (err == cudaSuccess)
            err = pass_map(&maps.g, g, r, d, ldg, PASS_BIG, SP_BK, CU_TENSOR_MAP_SWIZZLE_NONE);
        if (err == cudaSuccess)
            err = pass_map(&maps.mg, mg, r, d, ldg, PASS_BIG, SP_BK, CU_TENSOR_MAP_SWIZZLE_NONE);
        if (err != cudaSuccess) return err;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(plan.grid);
    cfg.blockDim = dim3(PassShape<R>::NT);
    cfg.dynamicSmemBytes = plan.smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, kernel, p, g, mg, out, d, ldg, r, plan.nt, plan.ntiles, stamps, maps);
}

}  // namespace csl_res
