// H4 rank_update: out = P + G^T (M G) for row strips G, MG of shape (r, D),
// where G^T M G is symmetric (M symmetric).
//
// Replaces the TPU kernel conan_slam_tpu/ops/pallas_update.py:50
// rank_update_t (pallas_call :164 row panels, :191 2-D tiles), at the fp32
// contract only (the bf16 split3/split4/hi6 tiers are not ported).  On the
// frame's path G = [pht; P e2; e0; e1; e2; 0] and M = blockdiag(-S^-1, K4)
// (frame_kernel._frame_gm); on the gated frame M = blockdiag(B, -S^-1); on
// the pair M = blockdiag(M_A, M_B).  Each M is symmetric, so the update is.
//
// What bounds it on the card: at the frame's shapes FLOPs and P's bytes
// are close.  At D = 2304, r = 136 the symmetric product is D (D + 1) r =
// 0.72 GFLOP (10.8 us at 67 TFLOP/s fp32) against 2 D^2 x 4 B = 42 MB of P
// traffic (12.7 us at 3.35 TB/s).  The fp32 contract (TF32 flips the gated
// path's association gates) keeps it on FFMA, off the tensor cores.
//
// The design:
//   - Only the upper triangle of square T x T tiles (I <= J) is computed:
//     acc = G[:, I]^T MG[:, J], stored as out[I, J] = P[I, J] + acc and,
//     for I != J, out[J, I] = P[J, I] + acc^T; a diagonal tile mirrors its
//     own upper half.  Half the FLOPs, and P comes out exactly symmetric
//     whenever it goes in exactly symmetric.  Both stores go through a
//     padded (T + 1) shared-memory tile, so both are coalesced and
//     conflict-free, and each pass issues all its P loads before its first
//     store.
//   - k-chunks of BK = 16 rows of both strips stream through a 4-deep ring
//     in dynamic shared memory with cp.async (16-byte copies when D % 4 ==
//     0 and the strips are 16-byte aligned, 4-byte ones otherwise; zero
//     fill past the edges), one barrier a chunk, so three chunks are in
//     flight while the FMAs run.  The epilogue reads the tile's P blocks
//     coalesced, every load of a pass issued before its first store.
//   - Persistent blocks walk the list of triangle tiles.  T = 128 (256
//     threads, 8 x 8 outputs each, 2 blocks an SM) when there are at least
//     8 tiles per SM, so that the last wave is well filled, else T = 32 (64
//     threads, 4 x 4 outputs each, up to 12 blocks an SM): 2,628 tiles of
//     32 at D = 2304, 528 at D = 1024, 12,561 tiles of 128 at D = 20,224.
//     csl_rank_update_plan reports the choice.
//   - fp32 FFMA, register-tiled: no tensor cores, no TF32.
//   - Deterministic: no atomics, no split-K; each output is one block's
//     fmaf chain over k in order.  Any D and r; out of place (G holds a row
//     of P on the frame's path).
#include "common.cuh"

namespace {

constexpr int BK = 16;

template <int T>
struct Cfg {
    static_assert(T == 32 || T == 128, "tile edge");
    static constexpr int F = T == 32 ? 1 : 2;     // 4-wide groups a thread holds a side
    static constexpr int TD = T / (4 * F);        // threads along each tile edge
    static constexpr int NT = TD * TD;            // threads a block
    static constexpr int M = 4 * F;               // M x M outputs a thread
    static constexpr int STAGES = 4;
    static constexpr int MIN_BLOCKS = T == 128 ? 2 : 12;
    static constexpr int RING = STAGES * 2 * BK * T;
    static constexpr int SMEM_FLOATS = RING > T * (T + 1) ? RING : T * (T + 1);
};

// One pass of the epilogue over the T x T block at (r0, c0):
// out[r0 + u][c0 + v] = P[r0 + u][c0 + v] + X[u][v], X = ts^T when
// `transpose`, else ts with a diagonal tile's lower half taken from its
// upper half.  Consecutive threads walk along a row (coalesced); the padded
// tile's row stride T + 1 keeps the transposed reads free of bank
// conflicts.  Every P load of the pass is issued before its first store, so
// a thread keeps a whole pass's loads in flight.
template <int T, int NT, bool VEC>
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
            pv[q] = (r0 + u < d && c0 + v < d)
                        ? __ldcg(reinterpret_cast<const float4*>(p + (size_t)(r0 + u) * d + c0 + v))
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
            pv[q] = (r0 + u < d && c0 + v < d) ? __ldcg(p + (size_t)(r0 + u) * d + c0 + v) : 0.f;
        }
#pragma unroll
        for (int q = 0; q < NS; ++q) {
            const int e = tid + q * NT;
            const int u = e / T, v = e % T;
            if (r0 + u < d && c0 + v < d) __stcs(out + (size_t)(r0 + u) * d + c0 + v, pv[q] + x(u, v));
        }
    }
}

template <int T, bool VEC>
__global__ void __launch_bounds__(Cfg<T>::NT, Cfg<T>::MIN_BLOCKS)
rank_update_kernel(const float* __restrict__ p, const float* __restrict__ g,
                   const float* __restrict__ mg, float* __restrict__ out, int d, int r, int nt,
                   int ntiles) {
    using C = Cfg<T>;
    constexpr int TD = C::TD, NT = C::NT, M = C::M, G = T / C::F, TP = T + 1;
    extern __shared__ __align__(16) float smem[];
    float* ts = smem;     // the epilogue's T x (T + 1) tile, over the drained ring
    const int tid = threadIdx.x;
    const int tx = tid % TD, ty = tid / TD;
    const int nk = (r + BK - 1) / BK;

    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        int ti = 0, rem = tile;
        while (rem >= nt - ti) {
            rem -= nt - ti;
            ++ti;
        }
        const int i0 = ti * T, j0 = (ti + rem) * T;
        const bool diag = i0 == j0;

        auto load = [&](int c) {
            if (c < nk) {
                float* as = smem + (c % C::STAGES) * 2 * BK * T;
                float* bs = as + BK * T;
                const int k0 = c * BK;
                if (VEC) {
#pragma unroll
                    for (int q = 0; q < BK * T / 4 / NT; ++q) {
                        const int e = tid + q * NT;
                        const int kk = e / (T / 4), c4 = (e % (T / 4)) * 4;
                        const int k = k0 + kk;
                        const bool ain = k < r && i0 + c4 < d, bin = k < r && j0 + c4 < d;
                        csl_cp_async16(as + kk * T + c4, ain ? g + (size_t)k * d + i0 + c4 : g, ain);
                        csl_cp_async16(bs + kk * T + c4, bin ? mg + (size_t)k * d + j0 + c4 : mg, bin);
                    }
                } else {
#pragma unroll
                    for (int q = 0; q < BK * T / NT; ++q) {
                        const int e = tid + q * NT;
                        const int kk = e / T, c1 = e % T;
                        const int k = k0 + kk;
                        const bool ain = k < r && i0 + c1 < d, bin = k < r && j0 + c1 < d;
                        csl_cp_async4(as + kk * T + c1, ain ? g + (size_t)k * d + i0 + c1 : g, ain);
                        csl_cp_async4(bs + kk * T + c1, bin ? mg + (size_t)k * d + j0 + c1 : mg, bin);
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
            __syncthreads();     // chunk c landed; every thread is done with chunk c - 1
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
        __syncthreads();         // the ring becomes the epilogue's tile

#pragma unroll
        for (int a = 0; a < M; ++a) {
            const int il = (a / 4) * G + ty * 4 + a % 4;
#pragma unroll
            for (int b = 0; b < M; ++b) ts[il * TP + (b / 4) * G + tx * 4 + b % 4] = acc[a][b];
        }
        __syncthreads();

        // out[I, J], a diagonal tile's lower half from its upper half; then
        // out[J, I] = P[J, I] + acc^T.
        store_pass<T, NT, VEC>(p, out, ts, d, i0, j0, false, diag, tid);
        if (!diag) store_pass<T, NT, VEC>(p, out, ts, d, j0, i0, true, false, tid);
        __syncthreads();         // the tile is the next tile's ring
    }
}

struct Plan {
    int tile, grid, ntiles, nt, nthreads;
    size_t smem;
    const void* fn;
};

constexpr int MAX_DEVICES = 64;

// Per device, cached on first use: the SM count, and each variant's
// resident blocks a SM (its shared-memory cap raised once).
struct DeviceInfo {
    int sms = 0;
    int occ[4] = {0, 0, 0, 0};
};
DeviceInfo g_info[MAX_DEVICES];

template <int T, bool VEC>
cudaError_t plan_with(int d, DeviceInfo& info, int slot, Plan* plan) {
    using C = Cfg<T>;
    const auto fn = rank_update_kernel<T, VEC>;
    const size_t smem = (size_t)C::SMEM_FLOATS * sizeof(float);
    if (info.occ[slot] == 0) {
        cudaError_t err = csl_allow_smem(fn, smem);
        int occ = 0;
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, C::NT, smem);
        if (err != cudaSuccess) return err;
        if (occ < 1) return cudaErrorInvalidConfiguration;
        info.occ[slot] = occ;
    }
    const int nt = (d + T - 1) / T;
    const int ntiles = nt * (nt + 1) / 2;
    const int slots = info.sms * info.occ[slot];
    plan->tile = T;
    plan->nthreads = C::NT;
    plan->nt = nt;
    plan->ntiles = ntiles;
    plan->grid = ntiles < slots ? ntiles : slots;
    plan->smem = smem;
    plan->fn = reinterpret_cast<const void*>(fn);
    return cudaSuccess;
}

// 16-byte strip copies need D % 4 == 0 and 16-byte aligned strips.
cudaError_t make_plan(int d, bool vec, Plan* plan) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
    DeviceInfo& info = g_info[dev];
    if (info.sms == 0) {
        err = cudaDeviceGetAttribute(&info.sms, cudaDevAttrMultiProcessorCount, dev);
        if (err != cudaSuccess) return err;
    }
    auto tiles = [](int d, int t) {
        const int n = (d + t - 1) / t;
        return n * (n + 1) / 2;
    };
    if (tiles(d, 128) >= 8 * info.sms)
        return vec ? plan_with<128, true>(d, info, 0, plan) : plan_with<128, false>(d, info, 1, plan);
    return vec ? plan_with<32, true>(d, info, 2, plan) : plan_with<32, false>(d, info, 3, plan);
}

bool aligned16(const void* p) { return (reinterpret_cast<size_t>(p) & 15) == 0; }

}  // namespace

extern "C" int csl_rank_update(const float* p, const float* g, const float* mg, float* out,
                               int d, int r, void* stream) {
    if (d <= 0 || r <= 0) return (int)cudaErrorInvalidValue;
    Plan plan;
    cudaError_t err = make_plan(d, d % 4 == 0 && aligned16(g) && aligned16(mg), &plan);
    if (err != cudaSuccess) return (int)err;
    void* args[] = {(void*)&p, (void*)&g, (void*)&mg, (void*)&out,
                    (void*)&d, (void*)&r, (void*)&plan.nt, (void*)&plan.ntiles};
    const int nthreads = plan.nthreads;
    err = cudaLaunchKernel(plan.fn, dim3(plan.grid), dim3(nthreads), args, plan.smem,
                           (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

// The tile edge and grid csl_rank_update takes for D = d (with aligned
// strips) on the current device; launches nothing.
extern "C" int csl_rank_update_plan(int d, int* tile, int* grid) {
    if (d <= 0) return (int)cudaErrorInvalidValue;
    Plan plan;
    const cudaError_t err = make_plan(d, d % 4 == 0, &plan);
    if (err != cudaSuccess) return (int)err;
    *tile = plan.tile;
    *grid = plan.grid;
    return (int)cudaSuccess;
}
