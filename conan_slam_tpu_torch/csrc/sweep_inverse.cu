// H1 sweep_inverse: S^-1 of an SPD matrix of even size mp: in ONE block with
// the matrix held in registers up to mp = 224, past it in one cooperative
// launch with the matrix's rows spread over the blocks' shared memory.
//
// Replaces the TPU kernel conan_slam_tpu/ops/spd_inverse.py:135 spd_inverse
// (_sweep_pallas :114, kernel body _sweep_kernel :109 / sweep_ref_inverse
// :33) and the in-kernel conan_slam_tpu/ops/frame_kernel.py:192 _sweep_si
// of the chain kernel: on the port's frame path it is its own launch,
// between H2 (which writes S) and H3 (which reads S^-1).
//
// What bounds it on the card: latency, not bytes or FLOPs.  At the frame's
// shape (mp = 128, ~40 valid pivot blocks) the sweep is ~40 dependent
// rank-2 updates of a 64 KB matrix.  Spreading the chain over blocks would
// cost a grid barrier a pivot, more than the work it spreads, so it stays
// in one block of 16 warps, which keep the swept block of A in registers
// for the whole sweep (sweep_block), and a pivot costs one block barrier
// and the latency of one warp forming the next pivot.  The phases around
// the sweep (load, symmetrize and scale, unscale and symmetrize again,
// store) read the transpose through a padded (mp + 1) shared tile, free of
// bank conflicts.  nblk is read on the device, so the host never waits for
// it.
//
// Past mp = 224 the registers of one block no longer hold the matrix (nor
// does its shared memory, from mp = 238), while the reference still runs its
// sweep kernel wherever its VMEM holds S (to mp ~ 700).  There H1 is one
// cooperative launch (sweep_inverse_kernel_coop): block b holds `band`
// consecutive rows of the scaled matrix in shared memory for the whole
// sweep.  A pivot is the block that holds its two rows publishing them to a
// double buffer in the caller's scratch, one grid barrier, and every block
// forming the pivot's factors from them and updating its rows, as the
// register sweep does.  Its time is a grid barrier a pivot, not the work.
#include <cooperative_groups.h>

#include "sweep.cuh"

namespace cg = cooperative_groups;

namespace {

using csl_sweep::NT;

constexpr int MAX_DEVICES = 64;
constexpr int REG_MAX_MP = 224;      // the register sweep's largest mp: 7 x 7 elements a thread
constexpr int COOP_MAX_MP = 2048;    // the cooperative sweep's largest
constexpr int COOP_BLOCKS = 32;      // the cooperative sweep's blocks, where shared memory allows

template <int RX>
__global__ void __launch_bounds__(NT, 1)
sweep_inverse_kernel(const float* __restrict__ s, const int* __restrict__ nblk,
                     float* __restrict__ out, int mp) {
    extern __shared__ __align__(16) float smem[];
    csl_sweep::inverse<RX, false>(s, __ldg(nblk), out, mp, smem);
}

template <int RX>
cudaError_t launch(const float* s, const int* nblk, float* out, int mp, cudaStream_t stream) {
    constexpr int W = 32 * RX;
    // The shared-memory cap, raised once a device for the largest mp of
    // this variant.
    static bool raised[MAX_DEVICES] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
    if (!raised[dev]) {
        err = csl_allow_smem(sweep_inverse_kernel<RX>, csl_sweep::smem_bytes(W, W));
        if (err != cudaSuccess) return err;
        raised[dev] = true;
    }
    sweep_inverse_kernel<RX><<<1, NT, csl_sweep::smem_bytes(mp, W), stream>>>(s, nblk, out, mp);
    return cudaGetLastError();
}

// The cooperative sweep's rows a block (even: a pivot's two rows in one
// block), COOP_BLOCKS blocks where its shared memory holds their rows, and
// its shared memory: the rows, the scale, the pivot's two rows and factors.
int coop_band(int mp) {
    const int want = 2 * ((mp + 2 * COOP_BLOCKS - 1) / (2 * COOP_BLOCKS));
    const int fit = ((CSL_MAX_SMEM / 4 - 5 * mp) / mp) & ~1;
    return want < fit ? want : fit;
}
size_t coop_smem_bytes(int mp) { return (size_t)(coop_band(mp) + 5) * mp * sizeof(float); }

// csl_sweep::inverse on `band` rows a block, A in shared memory.  scratch:
// two buffers of a pivot's two rows (4 mp floats), then one flag a block.
__global__ void __launch_bounds__(NT, 1)
sweep_inverse_kernel_coop(const float* __restrict__ s, const int* __restrict__ nblk,
                          float* out, float* scratch, int mp, int band) {
    extern __shared__ __align__(16) float smem[];
    cg::grid_group grid = cg::this_grid();
    float* rows = smem;                // (band, mp) this block's rows of A
    float* dsc = rows + band * mp;     // (mp,) the Jacobi scale
    float* r0 = dsc + mp;              // (mp,) the pivot's rows k0 and k1
    float* r1 = r0 + mp;
    float* g0 = r1 + mp;               // (mp,) the pivot's column factors
    float* g1 = g0 + mp;
    int* flags = reinterpret_cast<int*>(scratch + 4 * mp);
    const int tid = threadIdx.x, i0 = blockIdx.x * band;
    const int n = max(0, min(band, mp - i0)) * mp;   // this block's elements
    const int nb = min(max(__ldg(nblk), 0), mp / 2);

    for (int j = tid; j < mp; j += NT) dsc[j] = rsqrtf(fmaxf(__ldg(s + j * mp + j), 1e-30f));
    __syncthreads();
    // sym(S), scaled: ((0.5 (S_lo,hi + S_hi,lo)) dsc_lo) dsc_hi, the same
    // number at (i, j) and (j, i), whichever block forms it.
    for (int e = tid; e < n; e += NT) {
        const int i = i0 + e / mp, j = e % mp;
        const int lo = min(i, j), hi = max(i, j);
        rows[e] = 0.5f * (__ldg(s + lo * mp + hi) + __ldg(s + hi * mp + lo)) * dsc[lo] * dsc[hi];
    }
    for (int k = 0; k < nb; ++k) {
        const int k0 = 2 * k;
        float* buf = scratch + (k & 1) * 2 * mp;
        __syncthreads();   // this block's last update is done
        if (k0 / band == (int)blockIdx.x)
            for (int e = tid; e < 2 * mp; e += NT) buf[e] = rows[(k0 - i0) * mp + e];
        grid.sync();       // the pivot's rows are published; the other buffer is free
        for (int e = tid; e < 2 * mp; e += NT) r0[e] = __ldcg(buf + e);
        __syncthreads();
        const float e00 = r0[k0], e01 = r0[k0 + 1], e11 = r1[k0 + 1];
        const float det = e00 * e11 - e01 * e01;
        const bool ok = det > 1e-30f && e00 > 1e-20f;
        const float idet = ok ? __frcp_rn(det) : 0.0f;
        const float i00 = e11 * idet, i01 = -e01 * idet, i11 = e00 * idet;
        for (int j = tid; j < mp; j += NT) {   // as csl_sweep::sweep_pivot
            const float x0 = r0[j], x1 = r1[j];
            float f0 = i00 * x0 + i01 * x1, f1 = i01 * x0 + i11 * x1;
            if (j == k0) {
                f0 -= i00;
                f1 -= i01;
            } else if (j == k0 + 1) {
                f0 -= i01;
                f1 -= i11;
            }
            g0[j] = f0;
            g1[j] = f1;
        }
        __syncthreads();
        const float piv = ok ? 2.f : 0.f;
        for (int e = tid; e < n; e += NT) {   // as apply_pivot, apply_pivot_diag
            const int i = i0 + e / mp, j = e % mp;
            const float hx = i == k0 ? r0[i] - 1.f : r0[i];
            const float hy = i == k0 + 1 ? r1[i] - 1.f : r1[i];
            if (i == j && (i == k0 || i == k0 + 1)) {
                float t = hx * g0[j] + hy * g1[j];
                t += piv;
                rows[e] -= t;
            } else {
                rows[e] = fmaf(-hy, g1[j], fmaf(-hx, g0[j], rows[e]));
            }
        }
    }
    __syncthreads();
    for (int e = tid; e < n; e += NT) out[i0 * mp + e] = rows[e];
    grid.sync();           // every row of A is in out
    // S^-1 = -A, unscaled, then symmetrized, as csl_sweep::inverse: x_ij
    // from this block's row, x_ji from its row in out, so (i, j) and (j, i)
    // come out the same number; zero everywhere on any non-finite value.
    int bad = 0;
    for (int e = tid; e < n; e += NT) {
        const int i = i0 + e / mp, j = e % mp;
        const float xij = __fmul_rn(__fmul_rn(-rows[e], dsc[i]), dsc[j]);
        const float xji = __fmul_rn(__fmul_rn(-__ldcg(out + j * mp + i), dsc[j]), dsc[i]);
        const float v = 0.5f * __fadd_rn(xij, xji);
        bad |= !isfinite(v);
        rows[e] = v;
    }
    bad = __syncthreads_or(bad);
    if (tid == 0) flags[blockIdx.x] = bad;
    grid.sync();           // every x_ji is read; every block's flag is set
    int any = 0;
    for (int b = tid; b < (int)gridDim.x; b += NT) any |= __ldcg(flags + b);
    any = __syncthreads_or(any);
    for (int e = tid; e < n; e += NT) out[i0 * mp + e] = any ? 0.f : rows[e];
}

// One cooperative launch of sweep_inverse_kernel_coop: ceil(mp / band) blocks, one
// an SM, every one resident (checked by the occupancy query).
cudaError_t launch_coop(const float* s, const int* nblk, float* out, float* scratch, int mp,
                        cudaStream_t stream) {
    static bool raised[MAX_DEVICES] = {};
    int dev = 0, sms = 0, occ = 0, coop = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
    const int band = coop_band(mp), blocks = (mp + band - 1) / band;
    const size_t smem = coop_smem_bytes(mp);
    if (!raised[dev]) {
        err = cudaFuncSetAttribute(sweep_inverse_kernel_coop,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, CSL_MAX_SMEM);
        if (err != cudaSuccess) return err;
        raised[dev] = true;
    }
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, sweep_inverse_kernel_coop, NT,
                                                            smem);
    if (err != cudaSuccess) return err;
    if (!coop || occ < 1 || blocks > sms * occ) return cudaErrorCooperativeLaunchTooLarge;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(NT);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, sweep_inverse_kernel_coop, s, nblk, out, scratch, mp, band);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

}  // namespace

// One variant for each 32 columns of mp: the frame's mp = 128 sweeps 2 Q x
// Q elements a thread (Q = 4, or fewer when the unused slots decouple).
// Past 224, the cooperative variant, which alone uses scratch (4 mp + 256
// floats; null is fine below).
extern "C" int csl_sweep_inverse(const float* s, const int* nblk, float* out, float* scratch,
                                 int mp, void* stream) {
    if (mp <= 0 || mp % 2 || mp > COOP_MAX_MP || (mp > REG_MAX_MP && !scratch))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    if (mp > REG_MAX_MP) return (int)launch_coop(s, nblk, out, scratch, mp, st);
    switch ((mp + 31) / 32) {
        case 1: return (int)launch<1>(s, nblk, out, mp, st);
        case 2: return (int)launch<2>(s, nblk, out, mp, st);
        case 3: return (int)launch<3>(s, nblk, out, mp, st);
        case 4: return (int)launch<4>(s, nblk, out, mp, st);
        case 5: return (int)launch<5>(s, nblk, out, mp, st);
        case 6: return (int)launch<6>(s, nblk, out, mp, st);
        default: return (int)launch<7>(s, nblk, out, mp, st);
    }
}

// The registers and local-memory bytes a thread of the register sweep's
// variant for mp (at most 224) takes.
extern "C" int csl_sweep_inverse_attributes(int mp, int* regs, int* local) {
    if (mp <= 0 || mp > REG_MAX_MP) return (int)cudaErrorInvalidValue;
    switch ((mp + 31) / 32) {
        case 1: return (int)csl_func_regs(sweep_inverse_kernel<1>, regs, local);
        case 2: return (int)csl_func_regs(sweep_inverse_kernel<2>, regs, local);
        case 3: return (int)csl_func_regs(sweep_inverse_kernel<3>, regs, local);
        case 4: return (int)csl_func_regs(sweep_inverse_kernel<4>, regs, local);
        case 5: return (int)csl_func_regs(sweep_inverse_kernel<5>, regs, local);
        case 6: return (int)csl_func_regs(sweep_inverse_kernel<6>, regs, local);
        default: return (int)csl_func_regs(sweep_inverse_kernel<7>, regs, local);
    }
}

extern "C" const char* csl_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
