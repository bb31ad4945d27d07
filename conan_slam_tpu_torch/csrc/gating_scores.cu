// H6 gating_scores: Mahalanobis nearest-neighbour scores of every
// measurement i against every map slot j, reduced to the best slot.
//
// Replaces the TPU kernel conan_slam_tpu/ops/gating_kernel.py:170
// gating_scores (pallas_call :222, body _gating_kernel :47).  Per pair:
//
//   S_j    = Hv Pvv Hv^T + Hv Pvj Hf^T + (.)^T + Hf Pjj Hf^T + R   (2 x 2)
//   nis_ij = v^T S_j^-1 v,  nd_ij = nis_ij + log |S_j|
//
// expanded to scalar FMAs against the 9 pose-block scalars, the slot's 6
// pose-feature strip entries and its 3 diagonal-block entries, as
// _gating_kernel :74-137 does (with atan2f and the remainder wrap in place
// of the Mosaic workarounds _atan2/_wrap).  Outputs per measurement:
//
//   best_nd = min over active slots with nis < gate_reject of nd, or the
//             sentinel 3e38 when no slot passes (callers read
//             found = best_nd < 1e38)
//   best_j  = the slot of best_nd, the LOWEST such j on a tie (the TPU
//             kernel's panel-wise argmin, :146-155), -1 when none passes
//   min_nis = min over active slots of nis (3e38 with no active slot)
//
// Inactive slots never win and never set min_nis.  The virtual-covariance
// correction (gating against P + V B V^T) is folded into pvv/pvm/pjj by the
// caller (filters/ekf/associate.py _innovation_blocks), as on the TPU.
//
// What bounds it on the card: latency.  At NZ = 64, K = 510 it is 33k
// pairs of ~100 FLOPs and reads ~25 KB; a single wave of blocks.  The
// design is one block per measurement, threads striding over the K slots
// in ascending order (so a thread's strict-less running minimum already
// keeps the lowest j), then a warp-shuffle and shared-memory reduction of
// (nd, j) that breaks ties on j, and of min nis.  Each block recomputes
// S_j for its measurement (~60 FLOPs a slot) rather than stage a (K, 3)
// table through device memory in a second launch.  Any K works (K = 10,110
// at the 10k-landmark shape is ~40 slots a thread).
#include "common.cuh"

#define GS_THREADS 256
#define GS_BIG 3.0e38f

__device__ __forceinline__ void gs_take(float& nd, int& j, float ond, int oj) {
    if (ond < nd || (ond == nd && oj < j)) {
        nd = ond;
        j = oj;
    }
}

__global__ void __launch_bounds__(GS_THREADS)
gating_scores_kernel(const float* __restrict__ z, const float* __restrict__ pose,
                     const float* __restrict__ feat, const unsigned char* __restrict__ active,
                     const float* __restrict__ pvv, const float* __restrict__ pvm,
                     const float* __restrict__ pjj, const float* __restrict__ rsc,
                     float* __restrict__ best_nd, int* __restrict__ best_j,
                     float* __restrict__ min_nis, int k, float gate_reject) {
    __shared__ float red_nd[GS_THREADS / 32], red_nis[GS_THREADS / 32];
    __shared__ int red_j[GS_THREADS / 32];
    const int i = blockIdx.x;
    const float zr = z[2 * i], zb = z[2 * i + 1];
    const float px = pose[0], py = pose[1], phi = pose[2];
    const float q00 = pvv[0], q01 = pvv[1], q02 = pvv[2];
    const float q11 = pvv[4], q12 = pvv[5], q22 = pvv[8];
    const float r00 = rsc[0], r01 = rsc[1], r11 = rsc[3];

    float bnd = GS_BIG, mnis = GS_BIG;
    int bj = 0x7fffffff;
    for (int j = threadIdx.x; j < k; j += GS_THREADS) {
        if (!active[j]) continue;
        const float dx = feat[2 * j] - px, dy = feat[2 * j + 1] - py;
        const float d2 = fmaxf(dx * dx + dy * dy, 1e-12f);
        const float dist = sqrtf(d2);
        const float zpb = atan2f(dy, dx) - phi;
        const float xd = dx / dist, yd = dy / dist;
        const float xd2 = dx / d2, yd2 = dy / d2;

        // Hv rows a = (-xd, -yd, 0), b = (yd2, -xd2, -1); Hf rows
        // c = (xd, yd), e = (-yd2, xd2).
        const float apa = q00 * xd * xd + 2.f * q01 * xd * yd + q11 * yd * yd;
        const float apb = -xd * (q00 * yd2 - q01 * xd2 - q02) - yd * (q01 * yd2 - q11 * xd2 - q12);
        const float bpb = yd2 * (q00 * yd2 - q01 * xd2 - q02) - xd2 * (q01 * yd2 - q11 * xd2 - q12)
                          - (q02 * yd2 - q12 * xd2 - q22);
        const float* pm = pvm + 6 * j;   // (3, 2): [r][x, y]
        const float apx = -xd * pm[0] - yd * pm[2], apy = -xd * pm[1] - yd * pm[3];
        const float bpx = yd2 * pm[0] - xd2 * pm[2] - pm[4];
        const float bpy = yd2 * pm[1] - xd2 * pm[3] - pm[5];
        const float apc = apx * xd + apy * yd, ape = -apx * yd2 + apy * xd2;
        const float bpc = bpx * xd + bpy * yd, bpe = -bpx * yd2 + bpy * xd2;
        const float* pj = pjj + 4 * j;
        const float p00 = pj[0], p01 = 0.5f * (pj[1] + pj[2]), p11 = pj[3];
        const float cjc = xd * (p00 * xd + p01 * yd) + yd * (p01 * xd + p11 * yd);
        const float cje = -(p00 * xd + p01 * yd) * yd2 + (p01 * xd + p11 * yd) * xd2;
        const float eje = -yd2 * (-p00 * yd2 + p01 * xd2) + xd2 * (-p01 * yd2 + p11 * xd2);

        const float s00 = apa + 2.f * apc + cjc + r00;
        const float s01 = apb + ape + bpc + cje + r01;
        const float s11 = bpb + 2.f * bpe + eje + r11;
        const float det = fmaxf(s00 * s11 - s01 * s01, 1e-30f);
        const float idet = 1.f / det;
        const float i00 = s11 * idet, i01 = -s01 * idet, i11 = s00 * idet;

        const float vr = zr - dist, vb = csl_wrap(zb - zpb);
        const float nis = i00 * vr * vr + 2.f * i01 * vr * vb + i11 * vb * vb;
        const float nd = nis + logf(det);
        if (nis < mnis) mnis = nis;
        if (nis < gate_reject && nd < bnd) {
            bnd = nd;
            bj = j;
        }
    }

    for (int off = 16; off > 0; off >>= 1) {
        const float ond = __shfl_down_sync(0xffffffffu, bnd, off);
        const int oj = __shfl_down_sync(0xffffffffu, bj, off);
        const float onis = __shfl_down_sync(0xffffffffu, mnis, off);
        gs_take(bnd, bj, ond, oj);
        mnis = fminf(mnis, onis);
    }
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) {
        red_nd[warp] = bnd;
        red_j[warp] = bj;
        red_nis[warp] = mnis;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int w = 1; w < GS_THREADS / 32; ++w) {
            gs_take(bnd, bj, red_nd[w], red_j[w]);
            mnis = fminf(mnis, red_nis[w]);
        }
        const bool found = bnd < GS_BIG;
        best_nd[i] = found ? bnd : GS_BIG;
        best_j[i] = found ? bj : -1;
        min_nis[i] = mnis;
    }
}

extern "C" int csl_gating_scores(const float* z, const float* pose, const float* feat,
                                 const unsigned char* active, const float* pvv,
                                 const float* pvm, const float* pjj, const float* rsc,
                                 float* best_nd, int* best_j, float* min_nis, int nz, int k,
                                 float gate_reject, void* stream) {
    if (nz <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
    gating_scores_kernel<<<nz, GS_THREADS, 0, (cudaStream_t)stream>>>(
        z, pose, feat, active, pvv, pvm, pjj, rsc, best_nd, best_j, min_nis, k, gate_reject);
    return (int)cudaGetLastError();
}
