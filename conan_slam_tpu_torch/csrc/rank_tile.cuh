// One triangle tile of out = P + G^T (M G): the P pass of H4 (rank_update.cu)
// and of H9's last phase (frame_step.cu), one routine for both.
//
// A tile (I, J), I <= J, of edge T: acc = G[:, I]^T MG[:, J] over the r rows
// of the strips, in k-chunks of BK rows streamed through a STAGES-deep
// cp.async ring, then out[I, J] = P[I, J] + acc and, for I != J,
// out[J, I] = P[J, I] + acc^T, both through a padded (T + 1) shared tile; a
// diagonal tile mirrors its own upper half.  Each output is one thread's
// fmaf chain over k in order: no atomics, no split-K.
#pragma once

#include "common.cuh"

namespace csl_rank {

constexpr int BK = 16;

template <int T>
struct Cfg {
    static_assert(T == 32 || T == 64 || T == 128, "tile edge");
    static constexpr int F = T == 128 ? 2 : 1;    // 4-wide groups a thread holds a side
    static constexpr int TD = T / (4 * F);        // threads along each tile edge
    static constexpr int NT = TD * TD;            // threads a tile
    static constexpr int M = 4 * F;               // M x M outputs a thread
    static constexpr int STAGES = 4;
    static constexpr int MIN_BLOCKS = T == 128 ? 2 : T == 64 ? 4 : 12;
    static constexpr int RING = STAGES * 2 * BK * T;
    static constexpr int SMEM_FLOATS = RING > T * (T + 1) ? RING : T * (T + 1);
};

// The whole block's barrier (H4: one tile a block).
struct BlockSync {
    __device__ __forceinline__ void operator()() const { __syncthreads(); }
};

// A read of P: evict-first (ld.cs) when STREAM, else through L2 at the
// normal priority (ld.cg).
template <bool STREAM, typename V>
__device__ __forceinline__ V load_p(const V* a) {
    if constexpr (STREAM) return __ldcs(a);
    else return __ldcg(a);
}

// One pass of the epilogue over the T x T block at (r0, c0):
// out[r0 + u][c0 + v] = P[r0 + u][c0 + v] + X[u][v], X = ts^T when
// `transpose`, else ts with a diagonal tile's lower half taken from its
// upper half.  Consecutive threads walk along a row (coalesced); the padded
// tile's row stride T + 1 keeps the transposed reads free of bank
// conflicts.  Every P load of the pass is issued before its first store, so
// a thread keeps a whole pass's loads in flight.  !READP (H4's no-P probe
// entry): P is not read, out = X.  STREAMP: P is read evict-first (ld.cs),
// so that the pass's stream of P does not push out of the L2 what the
// next launch reads (H9's frame kernel: its code and the frame's state);
// otherwise through L2 at the normal priority (ld.cg).
template <int T, int NT, bool VEC, bool READP = true, bool STREAMP = false>
__device__ __forceinline__ void store_pass(const float* __restrict__ p, float* __restrict__ out,
                                           const float* ts, int d, int r0, int c0,
                                           bool transpose, bool diag, int tid) {
    constexpr int TP = T + 1;
    auto x = [&](int u, int v) {
        return (transpose || (diag && u > v)) ? ts[v * TP + u] : ts[u * TP + v];
    };
    if (VEC) {           // D % 4 == 0: 16-byte loads and stores
        constexpr int NV = T * T / 4 / NT;
        float4 pv[NV];
#pragma unroll
        for (int q = 0; q < NV; ++q) {
            const int e = tid + q * NT;
            const int u = e / (T / 4), v = (e % (T / 4)) * 4;
            pv[q] = (READP && r0 + u < d && c0 + v < d)
                        ? load_p<STREAMP>(
                              reinterpret_cast<const float4*>(p + (size_t)(r0 + u) * d + c0 + v))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int q = 0; q < NV; ++q) {
            const int e = tid + q * NT;
            const int u = e / (T / 4), v = (e % (T / 4)) * 4;
            if (r0 + u < d && c0 + v < d) {
                const float4 o = make_float4(pv[q].x + x(u, v), pv[q].y + x(u, v + 1),
                                             pv[q].z + x(u, v + 2), pv[q].w + x(u, v + 3));
                __stcs(reinterpret_cast<float4*>(out + (size_t)(r0 + u) * d + c0 + v), o);
            }
        }
    } else {
        constexpr int NS = T * T / NT;
        float pv[NS];
#pragma unroll
        for (int q = 0; q < NS; ++q) {
            const int e = tid + q * NT;
            const int u = e / T, v = e % T;
            pv[q] = (READP && r0 + u < d && c0 + v < d) ? load_p<STREAMP>(p + (size_t)(r0 + u) * d + c0 + v)
                                                         : 0.f;
        }
#pragma unroll
        for (int q = 0; q < NS; ++q) {
            const int e = tid + q * NT;
            const int u = e / T, v = e % T;
            if (r0 + u < d && c0 + v < d) __stcs(out + (size_t)(r0 + u) * d + c0 + v, pv[q] + x(u, v));
        }
    }
}

// The tile at (i0, j0) = (I T, J T), I <= J, computed by the Cfg<T>::NT
// threads tid = 0, 1, ... that share `smem` (Cfg<T>::SMEM_FLOATS floats)
// and the barrier `sync`.  The strips G and MG have r rows of row stride
// ldg >= d; columns from d on are never stored.  VECG: 16-byte strip copies
// (ldg % 4 == 0, 16-byte aligned strips); VECP: 16-byte P rows (d % 4 == 0).
// The ring's 4-byte copies go through L1 (cp.async.ca): only a caller whose
// strips were written before its launch may take VECG = false.  !READP:
// out = G^T MG, P not read (H4's no-P probe entry).  STREAMP: P read
// evict-first (store_pass).
template <int T, bool VECG, bool VECP, typename Sync, bool READP = true, bool STREAMP = false>
__device__ __forceinline__ void tile(const float* __restrict__ p, const float* g,
                                     const float* mg, float* __restrict__ out, int d, int ldg,
                                     int r, int i0, int j0, float* smem, int tid, Sync sync) {
    using C = Cfg<T>;
    constexpr int TD = C::TD, NT = C::NT, M = C::M, G = T / C::F, TP = T + 1;
    float* ts = smem;     // the epilogue's T x (T + 1) tile, over the drained ring
    const int tx = tid % TD, ty = tid / TD;
    const int nk = (r + BK - 1) / BK;
    const bool diag = i0 == j0;

    auto load = [&](int c) {
        if (c < nk) {
            float* as = smem + (c % C::STAGES) * 2 * BK * T;
            float* bs = as + BK * T;
            const int k0 = c * BK;
            if (VECG) {
#pragma unroll
                for (int q = 0; q < BK * T / 4 / NT; ++q) {
                    const int e = tid + q * NT;
                    const int kk = e / (T / 4), c4 = (e % (T / 4)) * 4;
                    const int k = k0 + kk;
                    const bool ain = k < r && i0 + c4 < d, bin = k < r && j0 + c4 < d;
                    csl_cp_async16(as + kk * T + c4, ain ? g + (size_t)k * ldg + i0 + c4 : g, ain);
                    csl_cp_async16(bs + kk * T + c4, bin ? mg + (size_t)k * ldg + j0 + c4 : mg, bin);
                }
            } else {
#pragma unroll
                for (int q = 0; q < BK * T / NT; ++q) {
                    const int e = tid + q * NT;
                    const int kk = e / T, c1 = e % T;
                    const int k = k0 + kk;
                    const bool ain = k < r && i0 + c1 < d, bin = k < r && j0 + c1 < d;
                    csl_cp_async4(as + kk * T + c1, ain ? g + (size_t)k * ldg + i0 + c1 : g, ain);
                    csl_cp_async4(bs + kk * T + c1, bin ? mg + (size_t)k * ldg + j0 + c1 : mg, bin);
                }
            }
        }
        csl_cp_async_commit();    // an empty group past the end keeps the count
    };

    float acc[M][M];
#pragma unroll
    for (int a = 0; a < M; ++a)
#pragma unroll
        for (int b = 0; b < M; ++b) acc[a][b] = 0.f;

#pragma unroll
    for (int c = 0; c < C::STAGES - 1; ++c) load(c);
    for (int c = 0; c < nk; ++c) {
        csl_cp_async_wait<C::STAGES - 2>();
        sync();              // chunk c landed; every thread is done with chunk c - 1
        load(c + C::STAGES - 1);
        const float* as = smem + (c % C::STAGES) * 2 * BK * T;
        const float* bs = as + BK * T;
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            // Rows g G + 4 ty + (0..3) of G's chunk, columns g G + 4 tx
            // + (0..3) of MG's: 16-byte reads, broadcast along a warp.
            float av[M], bv[M];
#pragma unroll
            for (int f = 0; f < C::F; ++f) {
                const float4 a4 = *reinterpret_cast<const float4*>(as + kk * T + f * G + ty * 4);
                const float4 b4 = *reinterpret_cast<const float4*>(bs + kk * T + f * G + tx * 4);
                av[4 * f] = a4.x, av[4 * f + 1] = a4.y, av[4 * f + 2] = a4.z, av[4 * f + 3] = a4.w;
                bv[4 * f] = b4.x, bv[4 * f + 1] = b4.y, bv[4 * f + 2] = b4.z, bv[4 * f + 3] = b4.w;
            }
#pragma unroll
            for (int a = 0; a < M; ++a)
#pragma unroll
                for (int b = 0; b < M; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
        }
    }
    csl_cp_async_wait<0>();
    sync();                  // the ring becomes the epilogue's tile

#pragma unroll
    for (int a = 0; a < M; ++a) {
        const int il = (a / 4) * G + ty * 4 + a % 4;
#pragma unroll
        for (int b = 0; b < M; ++b) ts[il * TP + (b / 4) * G + tx * 4 + b % 4] = acc[a][b];
    }
    sync();

    // out[I, J], a diagonal tile's lower half from its upper half; then
    // out[J, I] = P[J, I] + acc^T.
    store_pass<T, NT, VECP, READP, STREAMP>(p, out, ts, d, i0, j0, false, diag, tid);
    if (!diag) store_pass<T, NT, VECP, READP, STREAMP>(p, out, ts, d, j0, i0, true, false, tid);
    sync();                  // the tile is the next tile's ring
}

// Tile number `tile` of the upper-triangle list over nt x nt tiles, row by
// row: its (I, J).
__device__ __forceinline__ void tile_ij(int tile, int nt, int* ti, int* tj) {
    int i = 0, rem = tile;
    while (rem >= nt - i) {
        rem -= nt - i;
        ++i;
    }
    *ti = i;
    *tj = i + rem;
}

}  // namespace csl_rank
