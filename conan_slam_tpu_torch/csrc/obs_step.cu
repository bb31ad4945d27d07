// H10 obs_step: the whole gated frame in ONE cooperative launch: the
// packing, the observe, compact Hc, the frame-factor coupling, S, the sweep
// inverse, the gains, the updated mean, the NIS and the P pass
// P + vtf^T B vtf - pht^T S^-1 pht.
//
// Replaces the TPU kernel conan_slam_tpu/ops/frame_kernel.py:535
// frame_update_obs (pallas_call :607, body _fullframe_kernel :381-489), the
// reference's one-dispatch gated frame.  On the TPU its grid ran in order:
// grid step 0 formed the observe, compact Hc, the hvb coupling, S, the
// sweep S^-1, siv, xn and the NIS into VMEM scratch, and every step then
// wrote one row panel of P + vtf^T B vtf - (pht^T_panel S^-1) pht.  Hopper
// blocks run in no order, so the phases here are separated by grid
// barriers (cooperative_groups grid sync; the launch is cooperative, one
// block an SM, every block resident), and what the TPU kept in scratch
// goes through device memory (L2) between phases, as in H9 (frame_step.cu):
//
//   1. Chain.  Each block that owns a band of measurement rows packs the
//      frame's raw inputs itself (the gathered rows [0, 1, 2, 3 + 2 s,
//      4 + 2 s] from the slots clamped to the capacity, zin from the
//      strided range, bearing and mask columns, R, as ops/frame_kernel.py
//      frame_rows and _pack_meas), gathers x[rows], prc rows 0, 1, 2 and its
//      band's slot rows from P, reads vtf[:, rows] and B where they lie,
//      and runs the observe, compact Hc, v, hvb and its rows of S
//      (obs_band.cuh, H7's phases).  It writes rowc, hvb and its S rows.
//   2. Block 0 inverts S by H1's register-resident sweep (sweep.cuh) over
//      nblk = last valid slot + 1 pivots and forms siv = v^T S^-1 and the
//      NIS.  Meanwhile the other blocks form pht = Hc P[rows] + hvb vtf in
//      16-column panels into the strip G = [vtf; pht].
//   3. The gains, over 16-column panels: MG = [B vtf; -S^-1 pht] and the
//      mean xn = x + siv pht, heading wrapped.  Where the card has more
//      blocks than panels, the -S^-1 pht rows of a panel are split over
//      several blocks, each staging only its rows of S^-1.
//   4. The P pass: out = P + G^T MG, r = NBP + MP, over the upper-triangle
//      tiles of rank_tile.cuh, each mirrored: P comes out exactly symmetric
//      whenever it goes in exactly symmetric.  Tiles of 32 (8 at a time a
//      block, one on each group of 2 warps with its own named barrier), or
//      of 128 (2 at a time, groups of 8 warps) where D gives at least 8
//      such tiles an SM: the tile edge H4 (rank_update.cu) takes at that D.
//      The tile edge is a template parameter of the kernel, as the sweep's
//      width is: the 128-tile's 8 x 8 accumulators and its epilogue's
//      loads in flight would otherwise set every variant's register
//      budget (one kernel holding both spilled 280 bytes a thread where
//      the 32-tile variant alone spills none).
//
// What bounds it on the card: at BASELINE config 2 (D = 1024, MP = 128,
// NBP = 24) P's bytes, 2 D^2 x 4 B = 8.4 MB (2.5 us at 3.35 TB/s), and
// ~0.3 GFLOP (P pass at r = 152, pht, MG; 4.5 us at 67 TFLOP/s fp32); in
// practice the serial sweep on one block (phase 2) and the barriers.  At
// the 10k-landmark shape (D = 20,224) the P pass, as H4's.  fp32 FMA only
// (TF32 off, no tensor cores: the gated path's association gates flip
// under 16-bit and TF32 split products).  No atomics: every sum is one
// thread's fixed chain or a fixed-order reduction, so two calls are bit
// for bit equal.
//
// Block size: 512 threads for every phase, the sweep's 16 warps.  Shared
// memory is the largest of the phases' needs, not their sum.  Data written
// during the launch is read with __ldcg or cp.async.cg (through L2, never
// from a stale L1 line or the read-only path).  The C entry launches on
// the stream it is given, allocates nothing (the caller hands it one
// scratch buffer) and returns cudaGetLastError(), so the launch can be
// captured in a CUDA graph.
#include "obs_step.cuh"

namespace csl_h10 {

template <int RX>
cudaError_t launch(const Frame& f, cudaStream_t stream) {
    DeviceInfo* info = nullptr;
    const cudaError_t err = device_info(&info);
    if (err != cudaSuccess) return err;
    return pass_tile(f.d, info->sms) == 128 ? launch_big(RX, f, stream)
                                            : launch_tile<RX, 32>(f, stream);
}

template <int RX>
cudaError_t plan_only(int d, int mp, int rp, int nbp, int* grid, int* tile, int* smem) {
    size_t bytes = 0;
    DeviceInfo* info = nullptr;
    cudaError_t err = device_info(&info);
    if (err != cudaSuccess) return err;
    *tile = pass_tile(d, info->sms);
    err = *tile == 128 ? plan_big(RX, mp, rp, nbp, grid, &bytes)
                       : plan<RX, 32>(mp, rp, nbp, grid, &bytes);
    *smem = (int)bytes;
    return err;
}

bool shapes_ok(int d, int mp, int rp, int nbp) {
    return d >= 3 && mp > 0 && mp % 32 == 0 && mp <= OS_MAX_MP && rp >= 3 && rp <= OS_MAX_RP &&
           nbp > 0;
}

}  // namespace csl_h10

using namespace csl_h10;

// The grid, block, dynamic shared memory and P-pass tile edge of a launch
// at (d, mp, rp, nbp) on the current device; launches nothing.
extern "C" int csl_obs_step_plan(int d, int mp, int rp, int nbp, int* grid, int* block,
                                 int* smem, int* tile) {
    if (!shapes_ok(d, mp, rp, nbp)) return (int)cudaErrorInvalidValue;
    *block = OS_THREADS;
    switch (mp / 32) {
        case 1: return (int)plan_only<1>(d, mp, rp, nbp, grid, tile, smem);
        case 2: return (int)plan_only<2>(d, mp, rp, nbp, grid, tile, smem);
        case 3: return (int)plan_only<3>(d, mp, rp, nbp, grid, tile, smem);
        case 4: return (int)plan_only<4>(d, mp, rp, nbp, grid, tile, smem);
        case 5: return (int)plan_only<5>(d, mp, rp, nbp, grid, tile, smem);
        case 6: return (int)plan_only<6>(d, mp, rp, nbp, grid, tile, smem);
        default: return (int)plan_only<7>(d, mp, rp, nbp, grid, tile, smem);
    }
}

// One gated frame: see the top of this file.  slots int64, mask bool (one
// byte); the 1-D inputs with their strides in elements; r_cov (2, 2),
// bmat (nbp, nbp), vtf (nbp, d), p (d, d) and x (d,) contiguous; scratch of
// 2 mp^2 + 9 mp + mp nbp + 2 (nbp + mp) ldg floats, 16-byte aligned: S,
// S^-1, rowc, hvb, siv, G, MG (ops/frame_kernel.py
// _obs_step_scratch_floats); stamps null, or (grid, 8) for each block's
// phase times (see stamp()).  mp = 2 nz rounded up to 32, rp = 3 + 2 nz
// rounded up to 8, ldg = d rounded up to 4.
extern "C" int csl_obs_step(const float* p, const float* x, const long long* slots,
                            const float* zr, const float* zb, const unsigned char* mask,
                            const float* r_cov, const float* bmat, const float* vtf, float* p_out,
                            float* xn, float* nis, float* scratch, unsigned long long* stamps,
                            int slots_st, int zr_st, int zb_st, int mask_st, int d, int nz,
                            int cap, int mp, int rp, int nbp, int ldg, void* stream) {
    if (!shapes_ok(d, mp, rp, nbp) || nz <= 0 || cap <= 0 || mp < 2 * nz || rp < 3 + 2 * nz ||
        ldg < d || ldg % 4 || (reinterpret_cast<size_t>(scratch) & 15u))
        return (int)cudaErrorInvalidValue;
    Frame f;
    f.p = p;
    f.x = x;
    f.slots = slots;
    f.zr = zr;
    f.zb = zb;
    f.mask = mask;
    f.r_cov = r_cov;
    f.bmat = bmat;
    f.vtf = vtf;
    f.p_out = p_out;
    f.xn = xn;
    f.nis = nis;
    f.s = scratch;
    f.si = f.s + (size_t)mp * mp;
    f.rowc = f.si + (size_t)mp * mp;
    f.hvb = f.rowc + 8 * (size_t)mp;
    f.siv = f.hvb + (size_t)mp * nbp;
    f.g = f.siv + mp;
    f.mg = f.g + (size_t)(nbp + mp) * ldg;
    f.stamps = stamps;
    f.slots_st = slots_st;
    f.zr_st = zr_st;
    f.zb_st = zb_st;
    f.mask_st = mask_st;
    f.d = d;
    f.nz = nz;
    f.cap = cap;
    f.mp = mp;
    f.rp = rp;
    f.nbp = nbp;
    f.ldg = ldg;
    f.vecp = d % 4 == 0 && !(reinterpret_cast<size_t>(p) & 15u) &&
             !(reinterpret_cast<size_t>(p_out) & 15u) && !(reinterpret_cast<size_t>(vtf) & 15u);
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
