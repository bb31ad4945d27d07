// The register-resident sweep inverse of H1 (sweep_inverse.cu), shared with
// H9 (frame_step.cu), which runs it in one block of its grid: one routine
// for both.  See sweep_inverse.cu for what bounds it and its design.
#pragma once

#include "common.cuh"

namespace csl_sweep {

constexpr int TY = 16;        // warps a block
constexpr int NT = 32 * TY;   // threads a block

// One row of A takes one pivot: a -= h0 g0 + h1 g1, as sweep_ref_inverse,
// in two fused multiply-adds.
template <int Q>
__device__ __forceinline__ void apply_pivot(float (&a)[Q], float2 h, const float2 (&g)[Q]) {
#pragma unroll
    for (int b = 0; b < Q; ++b) a[b] = fmaf(-h.y, g[b].y, fmaf(-h.x, g[b].x, a[b]));
}

// The same for pivot row i (k0 or k1), whose diagonal also takes piv.
template <int Q>
__device__ __forceinline__ void apply_pivot_diag(float (&a)[Q], float2 h, const float2 (&g)[Q],
                                                 int i, float piv) {
    const int tx = threadIdx.x & 31;
#pragma unroll
    for (int b = 0; b < Q; ++b) {
        float t = h.x * g[b].x + h.y * g[b].y;
        if (tx + 32 * b == i) t += piv;
        a[b] -= t;
    }
}

// Pivot k0 / 2, formed by the warp that holds its rows r0 = A[k0] and r1 =
// A[k0 + 1] (lane tx: columns tx + 32 b), once they have taken every
// earlier pivot.  As sweep_ref_inverse: the 2x2 block and its inverse, then
// for every column j (A is symmetric, so a row stands for a column) the
// factor g = (g0, g1), with the unit shift at columns k0 and k1, and the
// row factor h = (h0, h1), the pivot rows with the unit shift at k0 and
// k1; both published to shared memory.  Returns whether the pivot is
// usable.
template <int Q>
__device__ __forceinline__ bool sweep_pivot(const float (&r0)[Q], const float (&r1)[Q], int k0,
                                            float2* G, float2* H) {
    const int tx = threadIdx.x & 31;
    const int cb = k0 >> 5, cl = k0 & 31;
    float x = 0.f, y = 0.f;
#pragma unroll
    for (int b = 0; b < Q; ++b)
        if (b == cb) {
            x = r0[b];
            y = r1[b];
        }
    const float e00 = __shfl_sync(0xffffffffu, x, cl);
    const float e01 = __shfl_sync(0xffffffffu, x, cl + 1);
    const float e11 = __shfl_sync(0xffffffffu, y, cl + 1);
    const float det = e00 * e11 - e01 * e01;
    const bool ok = det > 1e-30f && e00 > 1e-20f;
    const float idet = ok ? __frcp_rn(det) : 0.0f;   // = 1 / det, correctly rounded
    const float i00 = e11 * idet, i01 = -e01 * idet, i11 = e00 * idet;
#pragma unroll
    for (int b = 0; b < Q; ++b) {
        const int j = tx + 32 * b;
        const float x0 = r0[b], x1 = r1[b];
        float g0 = i00 * x0 + i01 * x1, g1 = i01 * x0 + i11 * x1;
        if (j == k0) {                 // column k0's shifts are (i00, i01)
            g0 -= i00;
            g1 -= i01;
        } else if (j == k0 + 1) {      // column k1's (i01, i11)
            g0 -= i01;
            g1 -= i11;
        }
        G[j] = make_float2(g0, g1);
        H[j] = make_float2(j == k0 ? x0 - 1.f : x0, j == k0 + 1 ? x1 - 1.f : x1);
    }
    return ok;
}

// The pivot sweep over the leading W x W block (W = 32 Q) of the scaled
// matrix in ts (row stride tp; entries past mp read as 0).  Warp ty holds
// the RY = 2 Q consecutive rows ty RY + a, lane tx their columns tx + 32 b,
// in registers for the whole sweep, so warp w holds the U = Q pivots
// w U .. w U + U - 1 whole.  The loop over pivots is unrolled by U, so
// that every row a warp touches is known at compile time.  A pivot is one
// block barrier: after it every thread reads its columns' g and its rows'
// h (one of two buffers) and updates its registers as sweep_ref_inverse
// does,
//   A <- A - (h0 g0 + h1 g1 + 2 [pivot diagonal]),
// except the warp holding the next pivot, which first updates that
// pivot's two rows, forms it (sweep_pivot, into the other buffer; two
// shuffles, no barrier) and only then its other rows.
template <int Q>
__device__ __forceinline__ void sweep_block(float* ts, int tp, int mp, float* rows, int nb, int na) {
    constexpr int W = 32 * Q, RY = W / TY, U = RY / 2;
    static_assert(RY * TY == W && RY % 2 == 0, "layout");
    const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
    float A[RY][Q];
#pragma unroll
    for (int a = 0; a < RY; ++a) {
        const int i = ty * RY + a;
#pragma unroll
        for (int b = 0; b < Q; ++b) {
            const int j = tx + 32 * b;
            A[a][b] = (i < mp && j < mp) ? ts[i * tp + j] : 0.f;
        }
    }
    float2* GB = reinterpret_cast<float2*>(rows);   // 2 buffers x W: g
    float2* HB = GB + 2 * W;                         // 2 buffers x W: h
    // Whether the last pivot this warp formed is usable: its rows take the
    // pivot diagonal when it is applied.
    bool ok = false;
    if (ty == 0) ok = sweep_pivot<Q>(A[0], A[1], 0, GB, HB);
    for (int w = 0; w * U < nb; ++w) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int k = w * U + u;
            if (k >= nb) continue;   // and so every later u
            __syncthreads();   // pivot k is published; the other buffer is read
            const int par = k & 1;
            float2 gr[Q], hr[RY];
#pragma unroll
            for (int b = 0; b < Q; ++b) gr[b] = GB[par * W + tx + 32 * b];
#pragma unroll
            for (int a = 0; a < RY; a += 2) {   // two rows' h in one 16-byte read
                const float4 h2 = *reinterpret_cast<const float4*>(HB + par * W + ty * RY + a);
                hr[a] = make_float2(h2.x, h2.y);
                hr[a + 1] = make_float2(h2.z, h2.w);
            }
            const float piv = ok ? 2.f : 0.f;
            float2* Gn = GB + (par ^ 1) * W;
            float2* Hn = HB + (par ^ 1) * W;
            const bool next = k + 1 < nb;
            // Pivot k's rows are warp w's rows 2u, 2u + 1; pivot k + 1's are
            // its rows 2u + 2, 2u + 3, or warp w + 1's rows 0, 1.
            const int n0 = u + 1 < U ? 2 * u + 2 : 0;   // a constant once unrolled
            const int nw = u + 1 < U ? w : w + 1;
            if (ty == nw) {
                apply_pivot<Q>(A[n0], hr[n0], gr);
                apply_pivot<Q>(A[n0 + 1], hr[n0 + 1], gr);
                if (next) ok = sweep_pivot<Q>(A[n0], A[n0 + 1], 2 * k + 2, Gn, Hn);
#pragma unroll
                for (int a = 0; a < RY; ++a) {
                    if (a == n0 || a == n0 + 1) continue;
                    if (ty == w && (a == 2 * u || a == 2 * u + 1))
                        apply_pivot_diag<Q>(A[a], hr[a], gr, ty * RY + a, piv);
                    else
                        apply_pivot<Q>(A[a], hr[a], gr);
                }
            } else if (ty == w) {
#pragma unroll
                for (int a = 0; a < RY; ++a) {
                    if (a == 2 * u || a == 2 * u + 1)
                        apply_pivot_diag<Q>(A[a], hr[a], gr, ty * RY + a, piv);
                    else
                        apply_pivot<Q>(A[a], hr[a], gr);
                }
            } else if (ty * RY < na) {   // rows from na on have h = 0: left as they are
#pragma unroll
                for (int a = 0; a < RY; ++a) apply_pivot<Q>(A[a], hr[a], gr);
            }
        }
    }
    __syncthreads();       // every thread is done reading the published pivots
#pragma unroll
    for (int a = 0; a < RY; ++a) {
        const int i = ty * RY + a;
#pragma unroll
        for (int b = 0; b < Q; ++b) {
            const int j = tx + 32 * b;
            if (i < mp && j < mp) ts[i * tp + j] = A[a][b];
        }
    }
}

// sweep_block<q> for the run-time q in [Q, QMAX].
template <int Q, int QMAX>
__device__ void sweep_blocks(int q, float* ts, int tp, int mp, float* rows, int nb, int na) {
    if constexpr (Q <= QMAX) {
        if (q == Q) sweep_block<Q>(ts, tp, mp, rows, nb, na);
        else sweep_blocks<Q + 1, QMAX>(q, ts, tp, mp, rows, nb, na);
    }
}

// The sweep, run by the NT threads of one block on `smem` (smem_bytes(mp,
// 32 RX) bytes): conan_slam_tpu/ops/spd_inverse.py:33 sweep_ref_inverse as
// wrapped by conan_slam_tpu/ops/frame_kernel.py:192 _sweep_si: symmetrize,
// scale to a unit diagonal, sweep the first nblk 2x2 pivot blocks, unscale,
// symmetrize again, zero everything if anything is non-finite.  Both
// symmetrizations are load-bearing: the sweep reads pivot columns as rows,
// so an asymmetric S (from the row strips of an asymmetric P) would give an
// S^-1 whose asymmetry feeds back into P with gain every frame.  mp <= 32 RX.
// S is read with __ldcg when COHERENT (written earlier in the same launch,
// by other blocks), else with __ldg.  Returns, in every thread, whether a
// value was non-finite (out is then zero); on return the scaled swept tile
// and the scale are still in smem (see the layout below), so a caller can
// form products with S^-1 there without reading out back.
template <int RX, bool COHERENT>
__device__ __forceinline__ bool inverse(const float* s, int nblk, float* out, int mp, float* smem) {
    const int tp = mp + 1;
    float* ts = smem;                  // (mp, mp + 1) padded tile
    float* dsc = ts + mp * tp;         // (mp,) the Jacobi scale
    float* rows = dsc + mp;            // the pivots' g and h, two buffers each
    const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
    const int nb = min(max(nblk, 0), mp / 2);

    // The phases around the sweep touch each element once, so they are
    // short loops (unrolled by 4 only, for loads in flight): a launch runs
    // straight-line code once, and fetching fully unrolled code costs more
    // than its work.  S into the padded tile, warp ty copying rows ty,
    // ty + TY, ...
#pragma unroll 4
    for (int i = ty; i < mp; i += TY)
#pragma unroll
        for (int b = 0; b < RX; ++b) {
            const int j = tx + 32 * b;
            if (j < mp) ts[i * tp + j] = COHERENT ? __ldcg(s + i * mp + j) : __ldg(s + i * mp + j);
        }
    __syncthreads();
    for (int i = threadIdx.x; i < mp; i += NT) dsc[i] = rsqrtf(fmaxf(ts[i * tp + i], 1e-30f));
    __syncthreads();

    // sym(S), scaled, in place: ((0.5 (S_ij + S_ji)) dsc_i) dsc_j, formed
    // once for i <= j by the one thread that reads and writes (i, j) and
    // (j, i).  Rows and columns from 2 nb on take part in no pivot; where
    // they are decoupled from the leading 2 nb (every scaled A[i][j] with
    // i < 2 nb <= j is exactly 0, as for the frame's unused measurement
    // slots), every pivot's h and g vanish there and the update leaves them
    // as they are, so the sweep runs on the leading block alone: the same
    // values, less work.
    int coupled = 0;
#pragma unroll 4
    for (int i = ty; i < mp; i += TY)
#pragma unroll
        for (int b = 0; b < RX; ++b) {
            const int j = tx + 32 * b;
            if (j >= i && j < mp) {
                const float v = 0.5f * (ts[i * tp + j] + ts[j * tp + i]) * dsc[i] * dsc[j];
                ts[i * tp + j] = v;
                ts[j * tp + i] = v;
                coupled |= i < 2 * nb && j >= 2 * nb && v != 0.f;
            }
        }
    const int na = __syncthreads_or(coupled) ? mp : 2 * nb;
    if (nb > 0) sweep_blocks<1, RX>((na + 31) / 32, ts, tp, mp, rows, nb, na);
    __syncthreads();

    // S^-1 = -A, unscaled, then symmetrized; zero on any non-finite value.
    // A thread forms both x_ij and x_ji as their owners would, so
    // 0.5 (x_ij + x_ji) is the same number at (i, j) and (j, i).
    int bad = 0;
#pragma unroll 4
    for (int i = ty; i < mp; i += TY)
#pragma unroll
        for (int b = 0; b < RX; ++b) {
            const int j = tx + 32 * b;
            if (j < mp) {
                // The intrinsics keep the compiler from fusing a product
                // into the sum, which would round (i, j) and (j, i) apart.
                const float xij = __fmul_rn(__fmul_rn(-ts[i * tp + j], dsc[i]), dsc[j]);
                const float xji = __fmul_rn(__fmul_rn(-ts[j * tp + i], dsc[j]), dsc[i]);
                const float v = 0.5f * __fadd_rn(xij, xji);
                bad |= !isfinite(v);
                out[i * mp + j] = v;
            }
        }
    const bool any_bad = __syncthreads_or(bad);
    if (any_bad) {
        for (int i = ty; i < mp; i += TY)
#pragma unroll
            for (int b = 0; b < RX; ++b)
                if (tx + 32 * b < mp) out[i * mp + tx + 32 * b] = 0.f;
    }
    return any_bad;
}

// Shared memory of the sweep: the padded tile, the scale and two buffers of
// the pivots' g and h for a block of w columns.
__host__ __device__ inline size_t smem_bytes(int mp, int w) {
    return (size_t)(mp * (mp + 1) + mp + 8 * w) * sizeof(float);
}

}  // namespace csl_sweep
