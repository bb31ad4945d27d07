// H10 obs_step: the whole gated frame in TWO launches on one stream: a
// cooperative frame kernel (the packing, the observe, compact Hc, the
// frame-factor coupling, S, the sweep inverse, siv, the NIS, the gains and
// the updated mean) and the P pass P + vtf^T B vtf - pht^T S^-1 pht,
// launched right behind it with programmatic dependent launch.
//
// Replaces the TPU kernel conan_slam_tpu/ops/frame_kernel.py:535
// frame_update_obs (pallas_call :607, body _fullframe_kernel :381-489), the
// reference's one-dispatch gated frame.  On the TPU its grid ran in order:
// grid step 0 formed the observe, compact Hc, the hvb coupling, S, the
// sweep S^-1, siv, xn and the NIS into VMEM scratch, and every step then
// wrote one row panel of P + vtf^T B vtf - (pht^T_panel S^-1) pht.  Hopper
// blocks run in no order, so the frame kernel's phases are separated by
// grid barriers (cooperative_groups grid sync; the launch is cooperative,
// one block an SM, every block resident), and what the TPU kept in scratch
// goes through device memory (L2) between phases, as in H9 (frame_step.cu),
// whose design this is, carried over to G = [vtf; pht], MG = [B vtf;
// -S^-1 pht], r = NBP + MP:
//
//   1. Chain.  Each block that owns a band of measurement rows packs the
//      frame's raw inputs itself (the gathered rows [0, 1, 2, 3 + 2 s,
//      4 + 2 s] from the slots clamped to the capacity, zin from the
//      strided range, bearing and mask columns, R, as ops/frame_kernel.py
//      frame_rows and _pack_meas), gathers x[rows], prc rows 0, 1, 2 and its
//      band's slot rows from P, reads vtf[:, rows] and B where they lie,
//      and runs the observe, compact Hc, v, hvb and its rows of S
//      (obs_band.cuh, H7's phases).  It writes rowc, hvb and its S rows.
//      Block 0 finds nblk = last valid slot + 1 meanwhile.
//   2. Block 0 inverts S by H1's register-resident sweep (sweep.cuh) over
//      nblk pivots and stores S^-1; nothing else is on its path to the
//      barrier.  Meanwhile every other block takes units of f.unit columns
//      of D (unit_cols: 8 at BASELINE config 2, so D = 1024 is 128 units
//      on the 131 other blocks, one round; up to 32 at large D): it forms
//      the unit's pht = Hc P[rows] + hvb vtf into the strip G and into its
//      own shared memory, which it keeps for phase 3, and writes the unit's
//      vtf rows of G and B vtf rows of MG, which need no S^-1.
//   3. The gains: each block with a unit brings S^-1 into shared memory by
//      bulk copies (TMA) and, for the unit it formed last in phase 2 (its
//      pht still in shared memory; at config 2 its only unit, so one
//      round), forms -S^-1 pht into MG on 8 warps while the other 8 form
//      siv = v^T S^-1 from the same S^-1 and the mean xn = x + siv pht,
//      heading wrapped.  Block 0, beside them, turns its swept tile into
//      S^-1 in place and forms siv (the same bits) and the NIS.
//   4. The P pass (obs_pass_kernel, the second launch): out = P + G^T MG
//      over upper-triangle tiles, each mirrored: P comes out exactly
//      symmetric whenever it goes in exactly symmetric.  Its route is
//      H9's (resident.cuh pass_route, one routine for both frames): H4's
//      32-tiles one block a tile, or, where D gives at least 8 tiles of
//      128 an SM (the 10k-landmark shape), the streamed 128-tiles, one
//      persistent block an SM that brings P in and out by tensor copies
//      under its FMAs (obs_step_big.cu).  The frame kernel lets it launch
//      once every block has passed barrier 2, and it waits
//      (griddepcontrol.wait) until the frame kernel is complete.
//
// Every sum has one fixed order: pht and B vtf, each MG entry and siv one
// fmaf chain over i in order, the mean OS_XG partial chains a column summed
// in order, the NIS, and each P entry one fmaf chain over k in order.  The
// split schedule orders MG's and the mean's sums otherwise; the tests hold
// the two within the fp32 rounding of those sums.
//
// What bounds it on the card: at BASELINE config 2 (D = 1024, MP = 128,
// NBP = 24) P's bytes, 2 D^2 x 4 B = 8.4 MB (2.5 us at 3.35 TB/s), and
// ~0.3 GFLOP (P pass at r = 152, pht, MG; 4.5 us at 67 TFLOP/s fp32); in
// practice the serial sweep on one block (phase 2) and the P pass, which is
// FMA-issue bound at the tiles in flight.  At the 10k-landmark shape (D =
// 20,224) the P pass: P's 3.27 GB in and out (977 us at 3.35 TB/s).  fp32 FMA only (TF32 off, no tensor cores:
// the gated path's association gates flip under 16-bit and TF32 split
// products).  No atomics: every sum is one thread's fixed chain or a
// fixed-order reduction, so two calls are bit for bit equal.
//
// The frame kernel's blocks are 512 threads in every phase, the sweep's 16
// warps.  Its shared memory is the largest of its phases' needs, not their
// sum.  Data written during the launch is read with __ldcg, cp.async.cg or
// bulk copies after a proxy fence (through L2, never from a stale L1 line
// or the read-only path).  The C entry launches both kernels on the stream
// it is given, allocates nothing (the caller hands it one scratch buffer)
// and returns the first launch error, so the pair can be captured in a
// CUDA graph (the programmatic edge included).  If either launch fails the
// call fails: there is no other route.
#include "obs_step.cuh"

namespace csl_h10 {

// The frame kernel's grid for variant RX at `smem` dynamic bytes: one block
// an SM, after checking that a block of OS_THREADS fits an SM at all (the
// cooperative launch needs every block resident) and that there are two
// SMs at least (block 0 sweeps while the others form pht).
template <int RX>
cudaError_t plan_frame(size_t smem, int* grid) {
    DeviceInfo* info = nullptr;
    cudaError_t err = device_info(&info);
    if (err != cudaSuccess) return err;
    const auto fn = obs_step_kernel<RX>;
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
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, OS_THREADS, smem);
        if (err != cudaSuccess) return err;
        info->occ[RX] = occ;
        info->occ_smem[RX] = smem;
    }
    if (info->occ[RX] < 1 || info->sms < 2) return cudaErrorCooperativeLaunchTooLarge;
    *grid = info->sms;
    return cudaSuccess;
}

// The P pass on tiles of 32 (16-byte P rows or not).
cudaError_t plan_pass_32(int d, bool vecp, csl_res::PassPlan* plan) {
    DeviceInfo* info = nullptr;
    const cudaError_t err = device_info(&info);
    if (err != cudaSuccess) return err;
    csl_res::PassInfo* pi = &info->pass32[vecp ? 1 : 0];
    return vecp ? csl_res::plan_pass<csl_res::PASS_32>(obs_pass_kernel<csl_res::PASS_32, true>, d, pi, plan)
                : csl_res::plan_pass<csl_res::PASS_32>(obs_pass_kernel<csl_res::PASS_32, false>, d, pi, plan);
}

// Both launches: the frame kernel (cooperative), then the P pass behind it.
template <int RX>
cudaError_t launch(const Frame& f, cudaStream_t stream) {
    const size_t smem = smem_floats(f.mp, f.rp, f.nbp, f.unit) * sizeof(float);
    int grid = 0;
    cudaError_t err = plan_frame<RX>(smem, &grid);
    if (err != cudaSuccess) return err;
    DeviceInfo* info = nullptr;
    err = device_info(&info);
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
    err = cudaLaunchKernelEx(&cfg, obs_step_kernel<RX>, f);
    if (err != cudaSuccess) return err;
    unsigned long long* stamps = f.stamps ? f.stamps + (size_t)grid * OS_STAMPS : nullptr;
    if (csl_res::pass_route(f.d, info->sms, csl_res::pass_vec(f.p, f.p_out, f.d)) == csl_res::PASS_128) {
        err = launch_pass_big(f, stamps, stream);
    } else {
        using csl_res::PASS_32;
        csl_res::PassPlan plan;
        err = plan_pass_32(f.d, f.vecp != 0, &plan);
        if (err == cudaSuccess)
            err = f.vecp ? csl_res::launch_pass<PASS_32>(obs_pass_kernel<PASS_32, true>, plan, f.p, f.g,
                                                         f.mg, f.p_out, f.d, f.ldg, f.nbp + f.mp,
                                                         stamps, stream)
                         : csl_res::launch_pass<PASS_32>(obs_pass_kernel<PASS_32, false>, plan, f.p,
                                                         f.g, f.mg, f.p_out, f.d, f.ldg, f.nbp + f.mp,
                                                         stamps, stream);
    }
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

// What csl_obs_step_plan reports for variant RX (see there).
template <int RX>
cudaError_t plan_only(int d, int mp, int rp, int nbp, int* out) {
    DeviceInfo* info = nullptr;
    cudaError_t err = device_info(&info);
    if (err != cudaSuccess) return err;
    const int unit = unit_cols((d + 3) & ~3, info->sms - 1, mp, rp, nbp);
    const size_t bytes = smem_floats(mp, rp, nbp, unit) * sizeof(float);
    err = plan_frame<RX>(bytes, &out[0]);
    if (err != cudaSuccess) return err;
    out[1] = OS_THREADS;
    out[2] = (int)bytes;
    err = csl_func_regs(obs_step_kernel<RX>, &out[3], &out[4]);
    if (err != cudaSuccess) return err;
    out[5] = unit;
    const int tile = csl_res::pass_route(d, info->sms, true);
    csl_res::PassPlan pass;
    if (tile == csl_res::PASS_128) {
        err = plan_pass_big(d, &pass);
        if (err == cudaSuccess) err = pass_regs_big(&out[9], &out[10]);
    } else {
        err = plan_pass_32(d, true, &pass);
        if (err == cudaSuccess)
            err = csl_func_regs(obs_pass_kernel<csl_res::PASS_32, true>, &out[9], &out[10]);
    }
    if (err != cudaSuccess) return err;
    out[6] = pass.grid;
    out[7] = tile == csl_res::PASS_128 ? csl_res::PassShape<csl_res::PASS_128>::NT
                                       : csl_res::PassShape<csl_res::PASS_32>::NT;
    out[8] = (int)pass.smem;
    out[11] = pass.occ;
    out[12] = tile;
    out[13] = pass.ntiles;
    return cudaSuccess;
}

bool shapes_ok(int d, int mp, int rp, int nbp) {
    return d >= 3 && mp > 0 && mp % 32 == 0 && mp <= OS_MAX_MP && rp >= 3 && rp <= OS_MAX_RP &&
           nbp > 0;
}

}  // namespace csl_h10

using namespace csl_h10;

// The plan of a gated frame at (d, mp, rp, nbp) on the current device, as
// OS_PLAN ints: the frame kernel's grid, block, dynamic shared memory
// (bytes), registers and local-memory bytes a thread, and its unit
// (columns of D a block takes at a time); the P pass's grid, block, shared
// memory, registers and local bytes a thread (16-byte P rows) and its
// blocks an SM; its tile edge and tiles.  Launches nothing.
extern "C" int csl_obs_step_plan(int d, int mp, int rp, int nbp, int* out) {
    if (!shapes_ok(d, mp, rp, nbp)) return (int)cudaErrorInvalidValue;
    switch (mp / 32) {
        case 1: return (int)plan_only<1>(d, mp, rp, nbp, out);
        case 2: return (int)plan_only<2>(d, mp, rp, nbp, out);
        case 3: return (int)plan_only<3>(d, mp, rp, nbp, out);
        case 4: return (int)plan_only<4>(d, mp, rp, nbp, out);
        case 5: return (int)plan_only<5>(d, mp, rp, nbp, out);
        case 6: return (int)plan_only<6>(d, mp, rp, nbp, out);
        default: return (int)plan_only<7>(d, mp, rp, nbp, out);
    }
}

// One gated frame: see the top of this file.  slots int64, mask bool (one
// byte); the 1-D inputs with their strides in elements; r_cov (2, 2),
// bmat (nbp, nbp), vtf (nbp, d), p (d, d) and x (d,) contiguous; scratch of
// 2 mp^2 + 9 mp + mp nbp + 2 (nbp + mp) ldg floats, 16-byte aligned: S,
// S^-1, rowc, hvb, siv, G, MG (ops/frame_kernel.py
// _obs_step_scratch_floats); stamps null, or (grid + pass grid, OS_STAMPS)
// for each block's phase times (see stamp()).  mp = 2 nz rounded up to 32,
// rp = 3 + 2 nz rounded up to 8, ldg = d rounded up to 4.
extern "C" int csl_obs_step(const float* p, const float* x, const long long* slots,
                            const float* zr, const float* zb, const unsigned char* mask,
                            const float* r_cov, const float* bmat, const float* vtf, float* p_out,
                            float* xn, float* nis, float* scratch, unsigned long long* stamps,
                            int slots_st, int zr_st, int zb_st, int mask_st, int d, int nz,
                            int cap, int mp, int rp, int nbp, int ldg, void* stream) {
    if (!shapes_ok(d, mp, rp, nbp) || nz <= 0 || cap <= 0 || mp < 2 * nz || rp < 3 + 2 * nz ||
        ldg < d || ldg % 4 || (reinterpret_cast<size_t>(scratch) & 15u))
        return (int)cudaErrorInvalidValue;
    DeviceInfo* info = nullptr;
    const cudaError_t err = device_info(&info);
    if (err != cudaSuccess) return (int)err;
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
    f.unit = unit_cols(ldg, info->sms - 1, mp, rp, nbp);
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
