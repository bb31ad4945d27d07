// H11 sweep_probe: the sweep variants of the reference's sweep probe, on a
// pre-scaled S (unit diagonal) of even size mp <= 128, sweeping its first
// nblk 2x2 pivot blocks and writing -A, as the probe's kernels do (no
// symmetrization, no scaling: the caller's S is already scaled).
//
// Replaces the TPU kernels of benchmarks/probe_sweep.py:192 make(variant):
// unrolled_sweep (:58, "unroll2", "unroll4") and paired_sweep (:98,
// "wide4").  Its "v0" is H1 itself (sweep_inverse.cu).
//
// What bounds it on the card: latency, as H1's sweep.  At the probe's shape
// (mp = 128, nblk = 40) a pivot is a dependent rank-2 update of a 64 KB
// matrix held in the registers of one block; H1 spends one block barrier
// and the latency of one warp forming the next pivot (a shuffle chain) a
// pivot.  The variants ask which of the two sets the time:
//
//   unroll2 / unroll4: H1's register sweep (sweep.cuh) with UN = 2 / 4
//       pivots a loop body, the loop not unrolled further.  H1 unrolls its
//       loop by U = RY / 2 pivots (one warp's rows), so every row a warp
//       touches is a constant; here the pivot's rows and the next pivot's
//       are found at run time (predicated over the warp's rows).  Same
//       arithmetic as H1, element by element: on an S with an exactly unit
//       diagonal that is exactly symmetric the result is H1's, bit for bit.
//   wide4: the paired sweep.  The warp that holds pivot rows k0 .. k0 + 3
//       applies pivot A (k0, k0 + 1) to rows k0 + 2, k0 + 3 locally, forms
//       pivot B (k0 + 2, k0 + 3) from them, and corrects B's columns by the
//       rank-2 terms of A (probe_sweep.py:133-160); then every row takes one
//       rank-4 update.  One block barrier and one publish of (g0..g3,
//       h0..h3) a PAIR of pivots, not a pivot.  An odd nblk ends with one
//       classic pivot: the reference probe's ragged tail is `pass`
//       (:175-178), which leaves the last pivot unswept (ROADMAP R6).
//
// Layout as H1's: one block of 16 warps; warp ty holds RY = 2 Q rows
// (ty RY + a), lane tx their columns tx + 32 b, Q = 2 (mp <= 64) or 4
// (mp <= 128); rows and columns past mp are zero and take no pivot.  fp32
// FMA; no atomics: two calls are bit for bit equal.
#include "sweep.cuh"

namespace {

using csl_sweep::NT;
using csl_sweep::TY;
using csl_sweep::apply_pivot;
using csl_sweep::apply_pivot_diag;
using csl_sweep::sweep_pivot;

constexpr int MAX_MP = 128;

// A (RY x Q) from S: row ty RY + a, column tx + 32 b; zero past mp.
template <int Q, int RY>
__device__ __forceinline__ void load_rows(const float* __restrict__ s, int mp,
                                          float (&A)[RY][Q]) {
    const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
#pragma unroll
    for (int a = 0; a < RY; ++a) {
        const int i = ty * RY + a;
#pragma unroll
        for (int b = 0; b < Q; ++b) {
            const int j = tx + 32 * b;
            A[a][b] = (i < mp && j < mp) ? __ldg(s + i * mp + j) : 0.f;
        }
    }
}

template <int Q, int RY>
__device__ __forceinline__ void store_neg(float* __restrict__ out, int mp,
                                          const float (&A)[RY][Q]) {
    const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
#pragma unroll
    for (int a = 0; a < RY; ++a) {
        const int i = ty * RY + a;
#pragma unroll
        for (int b = 0; b < Q; ++b) {
            const int j = tx + 32 * b;
            if (i < mp && j < mp) out[i * mp + j] = -A[a][b];
        }
    }
}

// One classic pivot k, applied by every thread to its rows: rows 2k, 2k + 1
// take the pivot diagonal piv, the warp's rows nr, nr + 1 (the next pivot's,
// when `nxt`) are updated first and form pivot k + 1 into (Gn, Hn).  The
// rows are found at run time.  Returns whether the pivot this warp formed
// is usable (`ok` unchanged when it formed none).
template <int Q, int RY>
__device__ __forceinline__ bool classic_step(float (&A)[RY][Q], const float2* G, const float2* H,
                                             int k, float piv, bool nxt, float2* Gn, float2* Hn,
                                             bool ok) {
    const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
    float2 gr[Q], hr[RY];
#pragma unroll
    for (int b = 0; b < Q; ++b) gr[b] = G[tx + 32 * b];
#pragma unroll
    for (int a = 0; a < RY; ++a) hr[a] = H[ty * RY + a];
    const int nr = 2 * k + 2 - ty * RY;   // the next pivot's first row in this warp, if in [0, RY)
    if (nxt && nr >= 0 && nr < RY) {
        float r0[Q], r1[Q];
#pragma unroll
        for (int a = 0; a < RY; a += 2)
            if (a == nr) {
                apply_pivot<Q>(A[a], hr[a], gr);
                apply_pivot<Q>(A[a + 1], hr[a + 1], gr);
#pragma unroll
                for (int b = 0; b < Q; ++b) {
                    r0[b] = A[a][b];
                    r1[b] = A[a + 1][b];
                }
            }
        ok = sweep_pivot<Q>(r0, r1, 2 * k + 2, Gn, Hn);
    }
#pragma unroll
    for (int a = 0; a < RY; ++a) {
        const int i = ty * RY + a;
        if (nxt && (a == nr || a == nr + 1)) continue;
        if (i == 2 * k || i == 2 * k + 1)
            apply_pivot_diag<Q>(A[a], hr[a], gr, i, piv);
        else
            apply_pivot<Q>(A[a], hr[a], gr);
    }
    return ok;
}

// unroll2 / unroll4: the classic sweep, UN pivots a loop body.
template <int Q, int UN>
__global__ void __launch_bounds__(NT, 1)
sweep_unroll_kernel(const float* __restrict__ s, float* __restrict__ out, int mp, int nb) {
    constexpr int W = 32 * Q, RY = W / TY;
    __shared__ __align__(16) float2 buf[4 * W];   // g, h: two buffers each
    float2* GB = buf;
    float2* HB = buf + 2 * W;
    const int ty = threadIdx.x >> 5;
    float A[RY][Q];
    load_rows<Q, RY>(s, mp, A);
    bool ok = false;
    if (ty == 0 && nb > 0) ok = sweep_pivot<Q>(A[0], A[1], 0, GB, HB);
#pragma unroll 1
    for (int k0 = 0; k0 < nb; k0 += UN) {
#pragma unroll
        for (int u = 0; u < UN; ++u) {
            const int k = k0 + u;
            if (k >= nb) break;
            __syncthreads();   // pivot k is published; the other buffer is read
            const int par = k & 1;
            const float piv = ok ? 2.f : 0.f;
            ok = classic_step<Q, RY>(A, GB + par * W, HB + par * W, k, piv, k + 1 < nb,
                                     GB + (par ^ 1) * W, HB + (par ^ 1) * W, ok);
        }
    }
    store_neg<Q, RY>(out, mp, A);
}

// A 2x2 pivot block's inverse (i00, i01, i11) from its entries, and
// whether it is usable, as sweep_pivot forms them.
struct Piv2 {
    float i00, i01, i11;
    bool ok;
};

__device__ __forceinline__ Piv2 piv2(float e00, float e01, float e11) {
    const float det = e00 * e11 - e01 * e01;
    const bool ok = det > 1e-30f && e00 > 1e-20f;
    const float idet = ok ? __frcp_rn(det) : 0.0f;
    return {e11 * idet, -e01 * idet, e00 * idet, ok};
}

// Column j's factors (g0, g1) of pivot (k0, k0 + 1) from the pivot rows'
// entries x0, x1 at j, with the unit shifts at columns k0 and k0 + 1.
__device__ __forceinline__ float2 piv2_col(const Piv2& p, float x0, float x1, int j, int k0) {
    float f0 = p.i00 * x0 + p.i01 * x1, f1 = p.i01 * x0 + p.i11 * x1;
    if (j == k0) {
        f0 -= p.i00;
        f1 -= p.i01;
    } else if (j == k0 + 1) {
        f0 -= p.i01;
        f1 -= p.i11;
    }
    return make_float2(f0, f1);
}

// The pair of pivots (k0, k0 + 1) and (k0 + 2, k0 + 3), k0 % 4 == 0, formed
// by the warp that holds their rows R0..R3 (after every earlier pair), as
// probe_sweep.py paired_sweep: pivot A's factors, rows k0 + 2, k0 + 3 after
// A, pivot B's factors from them, and B's row factors h2, h3 from the
// columns of k0 + 2, k0 + 3 after A (the rank-2 correction of the pre-A
// columns, read as rows by symmetry).  The four columns k0 .. k0 + 3 lie in
// one 32-column block cb: its lanes' values give both 2x2 blocks and the
// correction's coefficients by shuffles first, and then every column is
// formed from scalars alone.  Publishes g = (g0..g3) a column and
// h = (h0..h3) a row; returns pivot A's and B's usability in okA, okB.
template <int Q>
__device__ __forceinline__ void form_pair(const float (&R0)[Q], const float (&R1)[Q],
                                          const float (&R2)[Q], const float (&R3)[Q], int k0,
                                          float4* G, float4* H, bool& okA, bool& okB) {
    const int tx = threadIdx.x & 31;
    const int cb = k0 >> 5, cl = k0 & 31;
    float x0 = 0.f, x1 = 0.f, x2 = 0.f, x3 = 0.f;
#pragma unroll
    for (int b = 0; b < Q; ++b)
        if (b == cb) {
            x0 = R0[b];
            x1 = R1[b];
            x2 = R2[b];
            x3 = R3[b];
        }
    const unsigned all = 0xffffffffu;
    const Piv2 pa = piv2(__shfl_sync(all, x0, cl), __shfl_sync(all, x0, cl + 1),
                         __shfl_sync(all, x1, cl + 1));
    const float a20 = __shfl_sync(all, x2, cl), a21 = __shfl_sync(all, x2, cl + 1);
    const float a30 = __shfl_sync(all, x3, cl), a31 = __shfl_sync(all, x3, cl + 1);
    // Block cb's column after A: pivot B's entries and A's factors at
    // columns k0 + 2, k0 + 3.
    const float2 gc = piv2_col(pa, x0, x1, tx + 32 * cb, k0);
    const float r2c = x2 - a20 * gc.x - a21 * gc.y, r3c = x3 - a30 * gc.x - a31 * gc.y;
    const Piv2 pb = piv2(__shfl_sync(all, r2c, cl + 2), __shfl_sync(all, r2c, cl + 3),
                         __shfl_sync(all, r3c, cl + 3));
    const float g0c2 = __shfl_sync(all, gc.x, cl + 2), g1c2 = __shfl_sync(all, gc.y, cl + 2);
    const float g0c3 = __shfl_sync(all, gc.x, cl + 3), g1c3 = __shfl_sync(all, gc.y, cl + 3);
    okA = pa.ok;
    okB = pb.ok;
#pragma unroll
    for (int b = 0; b < Q; ++b) {
        const int j = tx + 32 * b;
        const float2 ga = piv2_col(pa, R0[b], R1[b], j, k0);
        const float r2 = R2[b] - a20 * ga.x - a21 * ga.y;
        const float r3 = R3[b] - a30 * ga.x - a31 * ga.y;
        const float2 gb = piv2_col(pb, r2, r3, j, k0 + 2);
        const float h0 = j == k0 ? R0[b] - 1.f : R0[b];
        const float h1 = j == k0 + 1 ? R1[b] - 1.f : R1[b];
        const float c2 = R2[b] - h0 * g0c2 - h1 * g1c2;
        const float c3 = R3[b] - h0 * g0c3 - h1 * g1c3;
        G[j] = make_float4(ga.x, ga.y, gb.x, gb.y);
        H[j] = make_float4(h0, h1, j == k0 + 2 ? c2 - 1.f : c2, j == k0 + 3 ? c3 - 1.f : c3);
    }
}

// One row takes a pair: a -= h0 g0 + h1 g1 + h2 g2 + h3 g3 (+ piv on its
// diagonal, at column i, when i >= 0).
template <int Q>
__device__ __forceinline__ void apply_pair(float (&a)[Q], float4 h, const float4 (&g)[Q], int i,
                                           float piv) {
    const int tx = threadIdx.x & 31;
#pragma unroll
    for (int b = 0; b < Q; ++b) {
        float t = h.x * g[b].x + h.y * g[b].y + h.z * g[b].z + h.w * g[b].w;
        if (tx + 32 * b == i) t += piv;
        a[b] -= t;
    }
}

// wide4: the paired sweep.  Warp w holds the PW = RY / 4 pairs w PW ..; the
// loop over pairs is unrolled by PW, so that every row a warp touches is a
// constant, as H1's loop over pivots.
template <int Q>
__global__ void __launch_bounds__(NT, 1)
sweep_wide4_kernel(const float* __restrict__ s, float* __restrict__ out, int mp, int nb) {
    constexpr int W = 32 * Q, RY = W / TY, PW = RY / 4;
    static_assert(RY % 4 == 0, "a warp holds whole pairs");
    __shared__ __align__(16) float4 buf[4 * W];   // g, h: two buffers each
    __shared__ float tail_piv;
    float4* GB = buf;
    float4* HB = buf + 2 * W;
    const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
    float A[RY][Q];
    load_rows<Q, RY>(s, mp, A);
    const int npair = nb / 2;
    bool okA = false, okB = false;
    if (ty == 0 && npair > 0) form_pair<Q>(A[0], A[1], A[2], A[3], 0, GB, HB, okA, okB);
    for (int w = 0; w * PW < npair; ++w) {
#pragma unroll
        for (int u = 0; u < PW; ++u) {
            const int q = w * PW + u;
            if (q >= npair) continue;   // and so every later u
            __syncthreads();   // pair q is published; the other buffer is read
            const int par = q & 1;
            // A row's h is read where the row is updated: with four pivots'
            // factors, holding every row's h at once would not fit the
            // 128 registers of a 512-thread block beside A.
            const float4* hp = HB + par * W + ty * RY;
            float4 gr[Q];
#pragma unroll
            for (int b = 0; b < Q; ++b) gr[b] = GB[par * W + tx + 32 * b];
            const float pivA = okA ? 2.f : 0.f, pivB = okB ? 2.f : 0.f;
            const bool next = q + 1 < npair;
            // Pair q's rows are warp w's rows 4u .. 4u + 3; pair q + 1's its
            // rows 4u + 4 .., or warp w + 1's rows 0 ...
            const int n0 = u + 1 < PW ? 4 * u + 4 : 0;
            const int nw = u + 1 < PW ? w : w + 1;
            if (ty == nw) {   // the next pair's rows first, then the pair is formed
#pragma unroll
                for (int a = n0; a < n0 + 4; ++a) apply_pair<Q>(A[a], hp[a], gr, -1, 0.f);
                if (next)
                    form_pair<Q>(A[n0], A[n0 + 1], A[n0 + 2], A[n0 + 3], 4 * q + 4,
                                 GB + (par ^ 1) * W, HB + (par ^ 1) * W, okA, okB);
            }
#pragma unroll
            for (int a = 0; a < RY; ++a) {
                if (ty == nw && a >= n0 && a < n0 + 4) continue;
                const bool mine = ty == w && a >= 4 * u && a < 4 * u + 4;
                apply_pair<Q>(A[a], hp[a], gr, mine ? ty * RY + a : -1,
                              a - 4 * u < 2 ? pivA : pivB);
            }
        }
    }
    if (nb & 1) {          // the ragged tail: one classic pivot k = 2 npair
        const int k = 2 * npair;
        float2* G2 = reinterpret_cast<float2*>(GB + (npair & 1) * W);
        float2* H2 = reinterpret_cast<float2*>(HB + (npair & 1) * W);
        __syncthreads();   // every thread is done reading the last pair
        const int nr = 2 * k - ty * RY;
        if (nr >= 0 && nr < RY) {
            float r0[Q], r1[Q];
#pragma unroll
            for (int a = 0; a < RY; a += 2)
                if (a == nr) {
#pragma unroll
                    for (int b = 0; b < Q; ++b) {
                        r0[b] = A[a][b];
                        r1[b] = A[a + 1][b];
                    }
                }
            const bool ok = sweep_pivot<Q>(r0, r1, 2 * k, G2, H2);
            if (tx == 0) tail_piv = ok ? 2.f : 0.f;
        }
        __syncthreads();
        classic_step<Q, RY>(A, G2, H2, k, tail_piv, false, nullptr, nullptr, false);
    }
    store_neg<Q, RY>(out, mp, A);
}

template <int Q>
cudaError_t launch(const float* s, float* out, int mp, int nb, int variant, cudaStream_t st) {
    switch (variant) {
        case 0: sweep_unroll_kernel<Q, 2><<<1, NT, 0, st>>>(s, out, mp, nb); break;
        case 1: sweep_unroll_kernel<Q, 4><<<1, NT, 0, st>>>(s, out, mp, nb); break;
        case 2: sweep_wide4_kernel<Q><<<1, NT, 0, st>>>(s, out, mp, nb); break;
        default: return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
}

}  // namespace

// variant 0 = unroll2, 1 = unroll4, 2 = wide4; nblk pivots (clamped to
// [0, mp / 2]); mp even, at most 128.
extern "C" int csl_sweep_probe(const float* s, float* out, int mp, int nblk, int variant,
                               void* stream) {
    if (mp <= 0 || mp % 2 || mp > MAX_MP) return (int)cudaErrorInvalidValue;
    const int nb = nblk < 0 ? 0 : (nblk > mp / 2 ? mp / 2 : nblk);
    const cudaStream_t st = (cudaStream_t)stream;
    return (int)(mp <= 64 ? launch<2>(s, out, mp, nb, variant, st)
                          : launch<4>(s, out, mp, nb, variant, st));
}
