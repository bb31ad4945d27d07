// H15 factor_gate: the gated frame's pre-update in one launch, from the
// frame-start state to the association result.
//
// Replaces two TPU kernels and the host work between them:
//   conan_slam_tpu/ops/factor_kernel.py:266 frame_factors_fused (pallas_call
//   :316): the frame factors, P_frame = P0 + vtf^T B vtf, as the post-frame
//   mean, the pose trace, the (NBP, D) factor strip vtf and the (NBP, NBP)
//   middle matrix B;
//   conan_slam_tpu/ops/gating_kernel.py:170 gating_scores (pallas_call
//   :222): Mahalanobis nearest-neighbour scores of every measurement i
//   against every map slot j, reduced to the best slot;
// and between them the reference's host fold of the virtual correction
// into the innovation blocks (filters/ekf/associate.py _innovation_blocks)
// and the mask rule of associate_gated.
//
// The grid holds two kinds of block.  Every block first reruns the frame's
// coefficient recursion on its first warp (csl_coeff_recursion, coeff.cuh:
// the routine H2 and H9 run too, a few hundred dependent scalar
// operations), because blocks run in no order and there is no "once" to
// share.
//   * Strip blocks (the first ceil(D / 256)) write their columns of
//       vtf[j, n] = p2[n] c_j[0] + e0[n] c_j[1] + e1[n] c_j[2] + e2[n] c_j[3]
//     for the NB coefficient columns c_j (zero for NB <= j < NBP) and
//       xf[n] = pose[n] (n < 3), x0[n] + p2[n] corr0 (map lanes, with the
//     heading observation), x0[n] (without),
//     with p2 = P0 e2 (row 2 of the symmetric P0); block 0 also writes the
//     pose trace and B.
//   * Gating blocks each take a tile of slots.  The strip is rank one in
//     its map rows (vtf[:, n] = p2[n] c[0] for n >= 3), so the virtual
//     covariance P0 + V B V^T that the frame gates against differs from P0,
//     at slot j with p2_j = P0[3 + 2j : 5 + 2j, 2], by
//       pose block   += V3 B V3^T            (once a frame)
//       pose strip   += u p2_j^T,  u = V3 B c0   (3 values a frame)
//       diagonal     += s p2_j p2_j^T,  s = c0^T B c0  (1 value a frame)
//     with V3 the strip's pose rows and c0 the p2 coefficients of the
//     columns.  Warp 0 forms u, s and the pose block from the recursion's
//     columns while warps 1-7 load their slot's P0 entries; each slot's
//     2x2 innovation covariance S_j, log|S_j| and geometry are formed once
//     (H6's scalar algebra, gating_scores: _gating_kernel :74-137, with
//     atan2f and the remainder wrap in place of the Mosaic workarounds),
//     and thread i scores measurement i against the tile:
//       nis_ij = v^T S_j^-1 v,  nd_ij = nis_ij + log |S_j|.
//     The feature is x0 + p2 corr0 by the strip's own expression
//     (fg_feature), so the mean the frame gates with is xf bit for bit.
//
// The cross-block reduction keeps T7's semantics: best nd among active
// slots whose nis is below gate_reject, the LOWEST j on a tie (the
// reference's strict "better" across panels), -1 and 3e38 when no slot
// passes; min nis over active slots.  Each thread posts its measurement's
// (order-preserving nd bits, j) as one packed 64-bit atomicMin and its min
// nis as a 32-bit one; the last gating block (an arrival counter) reads and
// resets the scratch with atomicExch, so the next launch finds it clean,
// and writes best_nd, best_j, min_nis and the association result:
//   known[i] = mask[i] & found,  slots[i] = found ? best_j : 0,
//   new[i]   = mask[i] & !found & (min_nis > gate_augment).
// Nothing is allocated and nothing waits on the host: one launch, which a
// CUDA graph captures.  The scratch (keys, min nis, the counter) belongs to
// one stream: the wrappers keep one a stream (gating_kernel.reduction_scratch).
//
// H5's and H6's own entries (csl_factor_strip, csl_gating_scores) launch
// this device code too: H5 with strip blocks only, H6 with gating blocks
// only over the pvv / pvm / pjj its caller folded, with no recursion.
//
// What bounds it on the card: latency.  At config 2 it moves ~(NBP + 3) D
// floats (~110 KB at D = 1024) and scores 64 x 500 pairs of ~100
// operations; its time is the recursion (sinf/cosf and divisions in a
// dependent chain) plus one launch.  The slots' loads overlap the
// recursion; the gating tiles are sized so that the gating blocks fill the
// SMs about twice at any K (FG_MAX_TILE slots a block at most).
#include "coeff.cuh"

#define FG_THREADS 256
#define FG_MAX_TILE 224     // slots a gating block: one a thread of warps 1-7
#define FG_STAMPS 5         // %globaltimer stamps a block (fg_stamp)
#define FG_BIG 3.0e38f      // "no slot passed the gate": callers read best_nd < 1e38

enum { FG_STRIP = 1, FG_GATE = 2, FG_FUSED = 3 };

struct FgArgs {
    // The frame factors (H5): the raw controls (any stride), Q, the
    // frame-start mean and P0's row 2.
    const float* vns;
    const float* swans;
    const float* phis;
    const unsigned char* actives;
    long long vns_st, swans_st, phis_st, actives_st;
    const float* q_cov;
    const float* x0;
    const float* p2;
    float* xf;
    float* pt;
    float* vtf;
    float* bm;
    int S, nbp, d;
    float wheel_base, dt, sigma_heading;
    int use_heading;
    int n_strip;            // strip blocks: blocks [0, n_strip)
    // Gating (H6): measurements, R and the gates.
    const float* z;         // (NZ, 2)
    const float* rsc;       // (2, 2)
    int nz, k, tile;
    float gate_reject, gate_augment;
    // The fused frame: P0 (row stride ldp) and the active-slot count.
    const float* p0;
    long long ldp;
    const long long* n_active;
    const unsigned char* zmask;   // (NZ,) the measurements' validity
    // H6's entry: the pose, the slots and the folded blocks, given.
    const float* pose;
    const float* feat;
    const unsigned char* active;
    const float* pvv;
    const float* pvm;
    const float* pjj;
    // Outputs of the gating.
    float* best_nd;
    int* best_j;
    float* min_nis;
    unsigned char* known;
    long long* slots;
    unsigned char* newm;
    // Scratch: keys (NZ u64), min nis (NZ u32), the arrival counter (u32);
    // all ones but the counter (0) between launches.
    unsigned long long* keys;
    unsigned int* nis_min;
    unsigned int* arrive;
    unsigned long long* stamps;   // (grid, FG_STAMPS) or null
};

__device__ __forceinline__ unsigned long long fg_now() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

// Thread 0 stamps slot k of its block's row (stamps of one launch: start,
// recursion done, strip written or slot table built, scores posted, result
// written by the last gating block).
__device__ __forceinline__ void fg_stamp(const FgArgs& a, int k, unsigned long long t) {
    if (a.stamps != nullptr && threadIdx.x == 0) a.stamps[(size_t)blockIdx.x * FG_STAMPS + k] = t;
}

// The post-frame map mean, one expression for the strip's xf and the
// gating's features: the same bits.
__device__ __forceinline__ float fg_feature(float x0n, float p2n, float corr0) {
    return x0n + p2n * corr0;
}

// Float bits whose unsigned order is the floats' order (finite values).
__device__ __forceinline__ unsigned int fg_order(float f) {
    const unsigned int b = __float_as_uint(f);
    return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float fg_unorder(unsigned int e) {
    return __uint_as_float((e & 0x80000000u) ? (e & 0x7fffffffu) : ~e);
}

// Thread groups a gating block splits a tile's slots over: as many as
// hold NZ measurements each in the block.
__device__ __forceinline__ int fg_groups(int nz) { return max(1, FG_THREADS / nz); }

// Post measurement i's minima: (nd, j) packed as the order-preserving nd
// bits over j, so the 64-bit minimum takes the lowest j among equal nd;
// the min nis by its order-preserving bits.  Nothing is posted for a value
// at the sentinel.
__device__ __forceinline__ void fg_post(const FgArgs& a, int i, float nd, int j, float nis) {
    if (nd < FG_BIG) atomicMin(a.keys + i, ((unsigned long long)fg_order(nd) << 32) | (unsigned)j);
    if (nis < FG_BIG) atomicMin(a.nis_min + i, fg_order(nis));
}

// (B x)_c for the middle matrix B of S sub-steps: p22 at (0, 0), 1 at
// (0, 1) and (1, 0), 1 on the 2S noise columns, r_head on the heading ones.
__device__ __forceinline__ float fg_bx(int c, float xc, float x0, float x1, float p22, int S,
                                       float r_head) {
    if (c == 0) return p22 * x0 + x1;
    if (c == 1) return x0;
    return c < 2 + 2 * S ? xc : r_head * xc;
}

template <int MODE>
__device__ __forceinline__ void factor_gate_body(const FgArgs& a) {
    extern __shared__ float coeff[];    // the recursion's (fg_smem_floats(S)): its own, subs, qc
    __shared__ float scal[4];           // pose (3), corr0
    __shared__ float fold[10];          // u (3), s, the pose block q00 q01 q02 q11 q12 q22
    __shared__ float tab[7][FG_MAX_TILE];   // a slot's dist, zpb, i00, i01, i11, log|S|, active
    __shared__ float part_nd[FG_THREADS], part_nis[FG_THREADS];   // the groups' minima
    __shared__ int part_j[FG_THREADS];
    __shared__ int last;
    const unsigned long long t_start = a.stamps != nullptr ? fg_now() : 0ull;
    const bool heading = a.use_heading != 0;
    const float r_head = a.sigma_heading * a.sigma_heading;
    const bool strip = MODE == FG_STRIP || (MODE == FG_FUSED && (int)blockIdx.x < a.n_strip);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

    // Gating blocks: warps 1-7 load their slot's inputs while warp 0 runs
    // the recursion.
    const int g = (int)blockIdx.x - (MODE == FG_GATE ? 0 : a.n_strip);
    const int j0 = g * a.tile;
    const int ls = (int)threadIdx.x - 32;
    const int j = j0 + ls;
    const bool mine = !strip && ls >= 0 && ls < a.tile && j < a.k;
    float fx = 0.f, fy = 0.f, p2a = 0.f, p2b = 0.f, pm[6], pj[4];
    bool act = false;
    // Loaded now, so that no load waits after the recursion: a gating
    // block's thread t first scores measurement t % NZ (its z), the slot
    // threads read R, warp 0 P0's pose block (for the fold); a strip
    // thread its column's p2 and x0.
    float zr0 = 0.f, zb0 = 0.f, r00 = 0.f, r01 = 0.f, r11 = 0.f, p2n = 0.f, x0n = 0.f;
    float q00 = 0.f, q01 = 0.f, q02 = 0.f, q11 = 0.f, q12 = 0.f, q22 = 0.f;   // P0's pose block
    if (!strip && (int)threadIdx.x < a.nz * fg_groups(a.nz)) {
        const int i = threadIdx.x % a.nz;
        zr0 = a.z[2 * i];
        zb0 = a.z[2 * i + 1];
    }
    if (mine) {
        r00 = a.rsc[0];
        r01 = a.rsc[1];
        r11 = a.rsc[3];
    }
    if (MODE == FG_FUSED && !strip && warp == 0) {
        q00 = a.p0[0];
        q01 = a.p0[1];
        q02 = a.p0[2];
        q11 = a.p0[a.ldp + 1];
        q12 = a.p0[a.ldp + 2];
        q22 = a.p0[2 * a.ldp + 2];
    }
    const int n = blockIdx.x * FG_THREADS + threadIdx.x;   // a strip block's column
    if (strip && n < a.d) {
        p2n = a.p2[n];
        x0n = a.x0[n];
    }
    if (mine) {
        if (MODE == FG_FUSED) {
            const size_t m = 3 + 2 * (size_t)j;
            fx = a.x0[m];
            fy = a.x0[m + 1];
            p2a = a.p2[m];
            p2b = a.p2[m + 1];
            for (int r = 0; r < 3; ++r) {
                pm[2 * r] = a.p0[r * a.ldp + m];
                pm[2 * r + 1] = a.p0[r * a.ldp + m + 1];
            }
            pj[0] = a.p0[m * a.ldp + m];
            pj[1] = a.p0[m * a.ldp + m + 1];
            pj[2] = a.p0[(m + 1) * a.ldp + m];
            pj[3] = a.p0[(m + 1) * a.ldp + m + 1];
            act = j < *a.n_active;
        } else {
            fx = a.feat[2 * j];
            fy = a.feat[2 * j + 1];
            for (int e = 0; e < 6; ++e) pm[e] = a.pvm[6 * j + e];
            for (int e = 0; e < 4; ++e) pj[e] = a.pjj[4 * j + e];
            act = a.active[j] != 0;
        }
    }

    if (MODE != FG_GATE && warp == 0) {
        // The controls packed as (4, S) and chol(Q) in closed form (H9's
        // packing: the intrinsics keep l10^2 unfused), then the recursion.
        const float p2h[3] = {a.p2[0], a.p2[1], a.p2[2]};
        float pose[3] = {a.x0[0], a.x0[1], a.x0[2]};
        float* subs = coeff + csl_coeff_smem_floats(a.S);
        float* qc = subs + 4 * a.S;
        for (int k = lane; k < a.S; k += 32) {
            subs[k] = a.vns[(size_t)k * a.vns_st];
            subs[a.S + k] = a.swans[(size_t)k * a.swans_st];
            subs[2 * a.S + k] = a.phis[(size_t)k * a.phis_st];
            subs[3 * a.S + k] = a.actives[(size_t)k * a.actives_st] ? 1.f : 0.f;
        }
        if (lane == 0) {
            const float l00 = sqrtf(a.q_cov[0]);
            const float l10 = a.q_cov[2] / l00;
            qc[0] = l00;
            qc[1] = l10;
            qc[2] = sqrtf(fmaxf(__fsub_rn(a.q_cov[3], __fmul_rn(l10, l10)), 0.f));
        }
        __syncwarp();
        float corr0;
        csl_coeff_recursion(subs, a.S, qc, p2h, pose, a.wheel_base, a.dt, r_head, heading,
                            strip && blockIdx.x == 0 ? a.pt : nullptr, &corr0, coeff);
        if (lane == 0) {
            scal[0] = pose[0];
            scal[1] = pose[1];
            scal[2] = pose[2];
            scal[3] = corr0;
        }
        if (MODE == FG_FUSED && !strip) {
            // u = V3 B c0, s = c0^T B c0 and V3 B V3^T, the columns over the
            // lanes, V3 as the strip writes its pose rows.
            const int nb = csl_coeff_cols(a.S, heading);
            const float p22 = p2h[2];
            float v0[4];        // column 0 and column 1's entries: c0, V3 rows
            float v1[4];
            v0[0] = coeff[0];
            v1[0] = coeff[4];
            for (int r = 0; r < 3; ++r) {
                v0[1 + r] = p2h[r] * coeff[0] + coeff[1 + r];
                v1[1 + r] = p2h[r] * coeff[4] + coeff[5 + r];
            }
            float acc[10] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
            for (int c = lane; c < nb; c += 32) {
                const float* cc = coeff + 4 * c;
                float x[4], bx[4];
                x[0] = cc[0];
                for (int r = 0; r < 3; ++r) x[1 + r] = p2h[r] * cc[0] + cc[1 + r];
                for (int e = 0; e < 4; ++e) bx[e] = fg_bx(c, x[e], v0[e], v1[e], p22, a.S, r_head);
                for (int r = 0; r < 3; ++r) acc[r] += x[1 + r] * bx[0];
                acc[3] += x[0] * bx[0];
                acc[4] += x[1] * bx[1];
                acc[5] += x[1] * bx[2];
                acc[6] += x[1] * bx[3];
                acc[7] += x[2] * bx[2];
                acc[8] += x[2] * bx[3];
                acc[9] += x[3] * bx[3];
            }
            for (int off = 16; off > 0; off >>= 1)    // ten independent sums a level
                for (int e = 0; e < 10; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
            if (lane == 0) {
                for (int e = 0; e < 4; ++e) fold[e] = acc[e];
                fold[4] = q00 + acc[4];
                fold[5] = q01 + acc[5];
                fold[6] = q02 + acc[6];
                fold[7] = q11 + acc[7];
                fold[8] = q12 + acc[8];
                fold[9] = q22 + acc[9];
            }
        }
    }
    if (MODE == FG_GATE && threadIdx.x == 0) {
        scal[0] = a.pose[0];
        scal[1] = a.pose[1];
        scal[2] = a.pose[2];
        scal[3] = 0.f;
        for (int e = 0; e < 4; ++e) fold[e] = 0.f;
        fold[4] = a.pvv[0];
        fold[5] = a.pvv[1];
        fold[6] = a.pvv[2];
        fold[7] = a.pvv[4];
        fold[8] = a.pvv[5];
        fold[9] = a.pvv[8];
    }
    __syncthreads();
    const unsigned long long t_rec = a.stamps != nullptr ? fg_now() : 0ull;

    if (strip) {
        const int nb = csl_coeff_cols(a.S, heading);
        if (n < a.d) {
            for (int c = 0; c < nb; ++c) {
                const float* cc = coeff + 4 * c;
                a.vtf[(size_t)c * a.d + n] = p2n * cc[0] + (n < 3 ? cc[1 + n] : 0.f);
            }
            for (int c = nb; c < a.nbp; ++c) a.vtf[(size_t)c * a.d + n] = 0.f;
            a.xf[n] = n < 3 ? scal[n] : (heading ? fg_feature(x0n, p2n, scal[3]) : x0n);
        }
        if (blockIdx.x == 0) {
            const float p22 = a.p2[2];
            for (int e = threadIdx.x; e < a.nbp * a.nbp; e += FG_THREADS) {
                const int r = e / a.nbp, c = e % a.nbp;
                float v = 0.f;
                if (r == 0 && c == 0) v = p22;
                else if ((r == 0 && c == 1) || (r == 1 && c == 0)) v = 1.f;
                else if (r == c && r >= 2 && r < 2 + 2 * a.S) v = 1.f;
                else if (r == c && r >= 2 + 2 * a.S && r < nb) v = r_head;
                a.bm[e] = v;
            }
        }
        if (a.stamps != nullptr) {
            __syncthreads();
            fg_stamp(a, 0, t_start);
            fg_stamp(a, 1, t_rec);
            fg_stamp(a, 2, fg_now());
        }
        return;
    }

    // The slot table: S_j of each slot once (H6's algebra), against the
    // virtual pose block and the slot's folded strip and diagonal block.
    const float px = scal[0], py = scal[1], phi = scal[2];
    if (ls >= 0 && ls < a.tile) {
        float ok = 0.f;
        for (int e = 0; e < 6; ++e) tab[e][ls] = 0.f;   // an inactive slot scores zeros, unused
        if (mine && act) {
            if (MODE == FG_FUSED) {
                const float corr0 = scal[3];
                if (heading) {
                    fx = fg_feature(fx, p2a, corr0);
                    fy = fg_feature(fy, p2b, corr0);
                }
                const float s = fold[3];
                for (int r = 0; r < 3; ++r) {
                    pm[2 * r] = pm[2 * r] + fold[r] * p2a;
                    pm[2 * r + 1] = pm[2 * r + 1] + fold[r] * p2b;
                }
                pj[0] = pj[0] + s * p2a * p2a;
                pj[1] = pj[1] + s * p2a * p2b;
                pj[2] = pj[2] + s * p2b * p2a;
                pj[3] = pj[3] + s * p2b * p2b;
            }
            const float v00 = fold[4], v01 = fold[5], v02 = fold[6];
            const float v11 = fold[7], v12 = fold[8], v22 = fold[9];
            const float dx = fx - px, dy = fy - py;
            const float d2 = fmaxf(dx * dx + dy * dy, 1e-12f);
            const float dist = sqrtf(d2);
            const float zpb = atan2f(dy, dx) - phi;
            const float xd = dx / dist, yd = dy / dist;
            const float xd2 = dx / d2, yd2 = dy / d2;
            // Hv rows a = (-xd, -yd, 0), b = (yd2, -xd2, -1); Hf rows
            // c = (xd, yd), e = (-yd2, xd2).
            const float apa = v00 * xd * xd + 2.f * v01 * xd * yd + v11 * yd * yd;
            const float apb = -xd * (v00 * yd2 - v01 * xd2 - v02) - yd * (v01 * yd2 - v11 * xd2 - v12);
            const float bpb = yd2 * (v00 * yd2 - v01 * xd2 - v02) - xd2 * (v01 * yd2 - v11 * xd2 - v12)
                              - (v02 * yd2 - v12 * xd2 - v22);
            const float apx = -xd * pm[0] - yd * pm[2], apy = -xd * pm[1] - yd * pm[3];
            const float bpx = yd2 * pm[0] - xd2 * pm[2] - pm[4];
            const float bpy = yd2 * pm[1] - xd2 * pm[3] - pm[5];
            const float apc = apx * xd + apy * yd, ape = -apx * yd2 + apy * xd2;
            const float bpc = bpx * xd + bpy * yd, bpe = -bpx * yd2 + bpy * xd2;
            const float p00 = pj[0], p01 = 0.5f * (pj[1] + pj[2]), p11 = pj[3];
            const float cjc = xd * (p00 * xd + p01 * yd) + yd * (p01 * xd + p11 * yd);
            const float cje = -(p00 * xd + p01 * yd) * yd2 + (p01 * xd + p11 * yd) * xd2;
            const float eje = -yd2 * (-p00 * yd2 + p01 * xd2) + xd2 * (-p01 * yd2 + p11 * xd2);
            const float s00 = apa + 2.f * apc + cjc + r00;
            const float s01 = apb + ape + bpc + cje + r01;
            const float s11 = bpb + 2.f * bpe + eje + r11;
            const float det = fmaxf(s00 * s11 - s01 * s01, 1e-30f);
            const float idet = 1.f / det;
            tab[0][ls] = dist;
            tab[1][ls] = zpb;
            tab[2][ls] = s11 * idet;
            tab[3][ls] = -s01 * idet;
            tab[4][ls] = s00 * idet;
            tab[5][ls] = logf(det);
            ok = 1.f;
        }
        tab[6][ls] = ok;
    }
    __syncthreads();
    const unsigned long long t_tab = a.stamps != nullptr ? fg_now() : 0ull;

    // Scores: the block's threads form `groups` groups of NZ (one group
    // when NZ >= 128); thread e scores measurement e % NZ against the
    // tile's slots e / NZ, e / NZ + groups, ... in ascending order, so its
    // strict-less running minimum keeps the lowest j.  The groups' minima
    // merge in shared memory (ties to the lower j), and one thread a
    // measurement posts them; each poster fences once, after its posts.
    const int nt = min(a.tile, a.k - j0);
    const int groups = fg_groups(a.nz);
    for (int e = threadIdx.x; e < a.nz * groups; e += FG_THREADS) {
        const int i = e % a.nz, grp = e / a.nz;
        const float zr = e == (int)threadIdx.x ? zr0 : a.z[2 * i];
        const float zb = e == (int)threadIdx.x ? zb0 : a.z[2 * i + 1];
        float bnd = FG_BIG, mnis = FG_BIG;
        int bj = 0;
#pragma unroll 4
        for (int l = grp; l < nt; l += groups) {
            const bool on = tab[6][l] != 0.f;    // every slot's loads issue; inactive ones score nothing
            const float i00 = tab[2][l], i01 = tab[3][l], i11 = tab[4][l];
            const float vr = zr - tab[0][l], vb = csl_wrap(zb - tab[1][l]);
            const float nis = i00 * vr * vr + 2.f * i01 * vr * vb + i11 * vb * vb;
            const float nd = nis + tab[5][l];
            if (on && nis < mnis) mnis = nis;
            if (on && nis < a.gate_reject && nd < bnd) {
                bnd = nd;
                bj = j0 + l;
            }
        }
        if (groups == 1) {
            fg_post(a, i, bnd, bj, mnis);
        } else {
            part_nd[e] = bnd;
            part_j[e] = bj;
            part_nis[e] = mnis;
        }
    }
    if (groups > 1) {
        __syncthreads();
        if ((int)threadIdx.x < a.nz) {
            const int i = threadIdx.x;
            float bnd = part_nd[i], mnis = part_nis[i];
            int bj = part_j[i];
            for (int g = 1; g < groups; ++g) {
                const float ond = part_nd[g * a.nz + i];
                const int oj = part_j[g * a.nz + i];
                if (ond < bnd || (ond == bnd && oj < bj)) {
                    bnd = ond;
                    bj = oj;
                }
                mnis = fminf(mnis, part_nis[g * a.nz + i]);
            }
            fg_post(a, i, bnd, bj, mnis);
        }
    }
    if ((int)threadIdx.x < (groups == 1 ? a.nz * groups : a.nz)) __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
        fg_stamp(a, 0, t_start);
        fg_stamp(a, 1, t_rec);
        fg_stamp(a, 2, t_tab);
        fg_stamp(a, 3, fg_now());
        const unsigned int n_gate = gridDim.x - (MODE == FG_GATE ? 0 : a.n_strip);
        last = atomicAdd(a.arrive, 1u) == n_gate - 1;
    }
    __syncthreads();
    if (!last) return;

    // The last gating block: every other block's atomics are visible (each
    // fenced them before it arrived).  Read and reset the scratch, decode.
    __threadfence();
    for (int i = threadIdx.x; i < a.nz; i += FG_THREADS) {
        const unsigned long long key = atomicExch(a.keys + i, ~0ull);
        const unsigned int mn = atomicExch(a.nis_min + i, ~0u);
        const bool found = key != ~0ull;
        const float nd = found ? fg_unorder((unsigned int)(key >> 32)) : FG_BIG;
        const int bj = found ? (int)(key & 0xffffffffull) : -1;
        const float mnis = mn == ~0u ? FG_BIG : fg_unorder(mn);
        a.best_nd[i] = nd;
        a.best_j[i] = bj;
        a.min_nis[i] = mnis;
        if (MODE == FG_FUSED) {
            const bool valid = a.zmask[i] != 0;
            a.known[i] = valid && found;
            a.slots[i] = found ? (long long)bj : 0ll;
            a.newm[i] = valid && !found && mnis > a.gate_augment;
        }
    }
    if (threadIdx.x == 0) {
        atomicExch(a.arrive, 0u);
        fg_stamp(a, 4, fg_now());
    }
}

__global__ void __launch_bounds__(FG_THREADS) factor_gate_kernel(const FgArgs a) {
    factor_gate_body<FG_FUSED>(a);
}

__global__ void __launch_bounds__(FG_THREADS) factor_strip_kernel(const FgArgs a) {
    factor_gate_body<FG_STRIP>(a);
}

__global__ void __launch_bounds__(FG_THREADS) gating_scores_kernel(const FgArgs a) {
    factor_gate_body<FG_GATE>(a);
}

static int fg_strip_blocks(int d) { return (d + FG_THREADS - 1) / FG_THREADS; }

static int fg_gate_blocks(int k, int tile) { return k > 0 ? (k + tile - 1) / tile : 1; }

// Dynamic shared memory of a block that runs the recursion (floats): the
// recursion's own, the packed controls (4, S) and chol(Q) (3, padded to 4).
static int fg_smem_floats(int S) { return csl_coeff_smem_floats(S) + 4 * S + 4; }

template <typename Kernel>
static int fg_launch(Kernel kernel, const FgArgs& a, int grid, bool recursion, void* stream) {
    const size_t smem = recursion ? (size_t)fg_smem_floats(a.S) * sizeof(float) : 0;
    const cudaError_t err = csl_allow_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, FG_THREADS, smem, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

static void fg_controls(FgArgs& a, const float* vns, const float* swans, const float* phis,
                        const unsigned char* actives, long long vns_st, long long swans_st,
                        long long phis_st, long long actives_st, const float* q_cov) {
    a.vns = vns;
    a.swans = swans;
    a.phis = phis;
    a.actives = actives;
    a.vns_st = vns_st;
    a.swans_st = swans_st;
    a.phis_st = phis_st;
    a.actives_st = actives_st;
    a.q_cov = q_cov;
}

static bool fg_factor_ok(int S, int nbp, int d, int use_heading) {
    return S > 0 && S <= CSL_MAX_STEPS && d >= 3 && nbp >= csl_coeff_cols(S, use_heading != 0);
}

static bool fg_tile_ok(int tile) { return tile >= 32 && tile <= FG_MAX_TILE && tile % 32 == 0; }

// H15: the frame factors and the association result in one launch.
// scratch: NZ u64 keys, then NZ u32 min nis and the u32 arrival counter,
// all ones but the counter (0) on entry, and so again on return.
extern "C" int csl_factor_gate(const float* vns, const float* swans, const float* phis,
                               const unsigned char* actives, long long vns_st,
                               long long swans_st, long long phis_st, long long actives_st,
                               const float* q_cov, const float* x0, const float* p0,
                               long long ldp, const long long* n_active,
                               const float* z, const unsigned char* zmask, const float* rsc,
                               float* xf, float* pt, float* vtf, float* bm, float* best_nd,
                               int* best_j, float* min_nis, unsigned char* known,
                               long long* slots, unsigned char* newm, void* scratch,
                               unsigned long long* stamps, int S, int nbp, int d, int nz, int k,
                               int tile, float wheel_base, float dt, float sigma_heading,
                               int use_heading, float gate_reject, float gate_augment,
                               void* stream) {
    if (!fg_factor_ok(S, nbp, d, use_heading) || nz <= 0 || k < 0 || 3 + 2 * (long long)k > d ||
        !fg_tile_ok(tile) || ldp < d)
        return (int)cudaErrorInvalidValue;
    FgArgs a = {};
    fg_controls(a, vns, swans, phis, actives, vns_st, swans_st, phis_st, actives_st, q_cov);
    a.x0 = x0;
    a.p2 = p0 + 2 * ldp;
    a.xf = xf;
    a.pt = pt;
    a.vtf = vtf;
    a.bm = bm;
    a.S = S;
    a.nbp = nbp;
    a.d = d;
    a.wheel_base = wheel_base;
    a.dt = dt;
    a.sigma_heading = sigma_heading;
    a.use_heading = use_heading;
    a.n_strip = fg_strip_blocks(d);
    a.z = z;
    a.rsc = rsc;
    a.nz = nz;
    a.k = k;
    a.tile = tile;
    a.gate_reject = gate_reject;
    a.gate_augment = gate_augment;
    a.p0 = p0;
    a.ldp = ldp;
    a.n_active = n_active;
    a.zmask = zmask;
    a.best_nd = best_nd;
    a.best_j = best_j;
    a.min_nis = min_nis;
    a.known = known;
    a.slots = slots;
    a.newm = newm;
    a.keys = static_cast<unsigned long long*>(scratch);
    a.nis_min = reinterpret_cast<unsigned int*>(a.keys + nz);
    a.arrive = a.nis_min + nz;
    a.stamps = stamps;
    return fg_launch(factor_gate_kernel, a, a.n_strip + fg_gate_blocks(k, tile), true, stream);
}

// H5's entry: the frame factors alone (strip blocks only).  p2 is P0's row 2.
extern "C" int csl_factor_strip(const float* vns, const float* swans, const float* phis,
                                const unsigned char* actives, long long vns_st,
                                long long swans_st, long long phis_st, long long actives_st,
                                const float* q_cov, const float* x0, const float* p2,
                                float* xf, float* pt, float* vtf, float* bm,
                                unsigned long long* stamps, int S, int nbp, int d,
                                float wheel_base, float dt, float sigma_heading, int use_heading,
                                void* stream) {
    if (!fg_factor_ok(S, nbp, d, use_heading)) return (int)cudaErrorInvalidValue;
    FgArgs a = {};
    fg_controls(a, vns, swans, phis, actives, vns_st, swans_st, phis_st, actives_st, q_cov);
    a.x0 = x0;
    a.p2 = p2;
    a.xf = xf;
    a.pt = pt;
    a.vtf = vtf;
    a.bm = bm;
    a.S = S;
    a.nbp = nbp;
    a.d = d;
    a.wheel_base = wheel_base;
    a.dt = dt;
    a.sigma_heading = sigma_heading;
    a.use_heading = use_heading;
    a.n_strip = fg_strip_blocks(d);
    a.stamps = stamps;
    return fg_launch(factor_strip_kernel, a, a.n_strip, true, stream);
}

// H6's entry: the scores over blocks its caller folded (gating blocks only,
// no recursion).  scratch as csl_factor_gate's.
extern "C" int csl_gating_scores(const float* z, const float* pose, const float* feat,
                                 const unsigned char* active, const float* pvv,
                                 const float* pvm, const float* pjj, const float* rsc,
                                 float* best_nd, int* best_j, float* min_nis, void* scratch,
                                 int nz, int k, int tile, float gate_reject, void* stream) {
    if (nz <= 0 || k <= 0 || !fg_tile_ok(tile)) return (int)cudaErrorInvalidValue;
    FgArgs a = {};
    a.z = z;
    a.rsc = rsc;
    a.nz = nz;
    a.k = k;
    a.tile = tile;
    a.gate_reject = gate_reject;
    a.pose = pose;
    a.feat = feat;
    a.active = active;
    a.pvv = pvv;
    a.pvm = pvm;
    a.pjj = pjj;
    a.best_nd = best_nd;
    a.best_j = best_j;
    a.min_nis = min_nis;
    a.keys = static_cast<unsigned long long*>(scratch);
    a.nis_min = reinterpret_cast<unsigned int*>(a.keys + nz);
    a.arrive = a.nis_min + nz;
    return fg_launch(gating_scores_kernel, a, fg_gate_blocks(k, tile), false, stream);
}

// Registers and local-memory bytes a thread of H15's kernel (0), H5's (1)
// or H6's (2); launches nothing.
extern "C" int csl_factor_gate_attributes(int which, int* regs, int* local) {
    switch (which) {
        case 0: return (int)csl_func_regs(factor_gate_kernel, regs, local);
        case 1: return (int)csl_func_regs(factor_strip_kernel, regs, local);
        case 2: return (int)csl_func_regs(gating_scores_kernel, regs, local);
        default: return (int)cudaErrorInvalidValue;
    }
}
