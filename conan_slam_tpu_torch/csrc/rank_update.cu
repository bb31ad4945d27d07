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
//   - The tile pass is rank_tile.cuh, which H9 (frame_step.cu) runs too.
//
// Two probe entries (csl_rank_update_tile), the counterparts of the
// schedule variants of benchmarks/probe_rankpass.py (make_variant :105,
// :121, mm_step :163, make_stacked :198): the plan forced (a tile edge of
// 32, 64 or 128 and a grid, e.g. one tile a block instead of persistent
// blocks), and out = G^T MG with no P read (READP = false).  They run the
// same tile routine; at the plan's own tile and grid the forced entry is the
// default entry, bit for bit.
#include "rank_tile.cuh"

namespace {

using csl_rank::Cfg;

template <int T, bool VEC, bool READP = true>
__global__ void __launch_bounds__(Cfg<T>::NT, Cfg<T>::MIN_BLOCKS)
rank_update_kernel(const float* __restrict__ p, const float* __restrict__ g,
                   const float* __restrict__ mg, float* __restrict__ out, int d, int r, int nt,
                   int ntiles) {
    extern __shared__ __align__(16) float smem[];
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        int ti, tj;
        csl_rank::tile_ij(tile, nt, &ti, &tj);
        csl_rank::tile<T, VEC, VEC, csl_rank::BlockSync, READP>(
            p, g, mg, out, d, d, r, ti * T, tj * T, smem, threadIdx.x, csl_rank::BlockSync{});
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

namespace {

// The probe entry's variants (16-byte strips only): one a tile edge and
// P read or not, each with its shared-memory cap raised once a device.
template <int T, bool READP>
cudaError_t launch_tile(const float* p, const float* g, const float* mg, float* out, int d, int r,
                        int grid, cudaStream_t stream) {
    using C = Cfg<T>;
    static bool raised[MAX_DEVICES] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
    const auto fn = rank_update_kernel<T, true, READP>;
    const size_t smem = (size_t)C::SMEM_FLOATS * sizeof(float);
    if (!raised[dev]) {
        err = csl_allow_smem(fn, smem);
        if (err != cudaSuccess) return err;
        raised[dev] = true;
    }
    const int nt = (d + T - 1) / T, ntiles = nt * (nt + 1) / 2;
    rank_update_kernel<T, true, READP><<<grid < ntiles ? grid : ntiles, C::NT, smem, stream>>>(
        p, g, mg, out, d, r, nt, ntiles);
    return cudaGetLastError();
}

}  // namespace

// H4 with its plan forced: tile edge 32, 64 or 128, `grid` blocks (at most
// one a tile; 0: one a tile), and P read (readp = 1: out = P + G^T MG) or
// not (readp = 0: out = G^T MG, p unused).  D % 4 == 0 and 16-byte aligned
// strips.
extern "C" int csl_rank_update_tile(const float* p, const float* g, const float* mg, float* out,
                                    int d, int r, int tile, int grid, int readp, void* stream) {
    if (d <= 0 || r <= 0 || grid < 0 || d % 4 || !aligned16(g) || !aligned16(mg) ||
        !aligned16(out) || (readp && !aligned16(p)))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    const int g0 = grid == 0 ? 1 << 30 : grid;
    switch (tile * 2 + (readp ? 1 : 0)) {
        case 65: return (int)launch_tile<32, true>(p, g, mg, out, d, r, g0, st);
        case 64: return (int)launch_tile<32, false>(p, g, mg, out, d, r, g0, st);
        case 129: return (int)launch_tile<64, true>(p, g, mg, out, d, r, g0, st);
        case 128: return (int)launch_tile<64, false>(p, g, mg, out, d, r, g0, st);
        case 257: return (int)launch_tile<128, true>(p, g, mg, out, d, r, g0, st);
        case 256: return (int)launch_tile<128, false>(p, g, mg, out, d, r, g0, st);
        default: return (int)cudaErrorInvalidValue;
    }
}
