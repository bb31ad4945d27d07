// H11 sweep_probe: the sweep variants of the reference's sweep probe, on a
// pre-scaled S (unit diagonal) of even size mp <= 128, sweeping its first
// nblk 2x2 pivot blocks and writing -A, as the probe's kernels do (no
// symmetrization, no scaling: the caller's S is already scaled).
//
// Replaces the TPU kernels of benchmarks/probe_sweep.py:192 make(variant):
// unrolled_sweep (:58, "unroll2", "unroll4") and paired_sweep (:98,
// "wide4").  Its "v0" is H1 itself (sweep_inverse.cu).
//
// What the variants compute (each element's fmaf chain as before):
//   unroll2 / unroll4: the classic pivot, UN = 2 / 4 pivots a loop body
//       (the pivot's rows found at run time, predicated over a warp's
//       rows).  The same arithmetic as H1 element by element: on an S with
//       an exactly unit diagonal that is exactly symmetric, sym(result) is
//       H1's, bit for bit.
//   wide4: the paired sweep.  The warp that holds pivot rows k0 .. k0 + 3
//       applies pivot A (k0, k0 + 1) to rows k0 + 2, k0 + 3 locally, forms
//       pivot B (k0 + 2, k0 + 3) from them, and corrects B's columns by the
//       rank-2 terms of A (probe_sweep.py:133-160); then every row takes one
//       rank-4 update, one publish of (g0..g3, h0..h3) a PAIR of pivots.  An
//       odd nblk ends with one classic pivot: the reference probe's ragged
//       tail is `pass` (:175-178), which leaves the last pivot unswept
//       (ROADMAP R6).
//
// What bounds it on the card: the serial chain.  A step (a pivot, or a
// pair) is a dependent rank-2 (rank-4) update of the 64 KB matrix, which
// lives in registers; the next step's rows must take it before the next
// step can be formed.  The parent held the matrix in one block of 16 warps
// and spent a __syncthreads() of 512 threads a pivot, so the FMA issue of
// a step and the chain (two rows, three shuffles, one __frcp_rn, a
// publish) added up: 0.57-0.71 us a pivot at mp 128.
//
// The design: no block barrier in the loop.  The published steps go
// through a ring of R stages of (g, h) in shared memory, each with a
// "full" and an "empty" mbarrier: a warp waits only on the stage it reads
// (mbarrier.try_wait.parity) and, once its rows have taken the step,
// arrives on that stage's "empty" barrier, which gates the stage's reuse.
// Warp w of CTA c holds the RW consecutive rows c W / C + w RW + a, lane tx
// their columns tx + 32 b; Q = 2 (mp <= 64) or 4 (mp <= 128), W = 32 Q;
// rows and columns past mp are zero and take no pivot.
//   unroll2 / unroll4: one block of 16 warps (RW = 2 Q) and 8 stages.  A
//       warp forms its RW / 2 pivots in one run: its row pair j takes the
//       previous warp's last pivot and the run's earlier pivots, forms and
//       publishes pivot base + j, and only after its last publish do its
//       rows take their own pivots and the rest of the run; every other
//       pivot is a plain consumer step, UN of them a loop body.  The
//       run's chain carries no update but the next pair's.
//   wide4: at mp > 64 a cluster of 8 CTAs of 4 warps (RW = 4), one an SM,
//       so an SM issues an eighth of a pair's FMAs.  The producer writes
//       its stage, arrives on its own CTA's "full" barrier, and copies the
//       stage into each other CTA's by one bulk copy
//       (cp.async.bulk.shared::cluster.shared::cta) that completes on that
//       CTA's "full" barrier by its bytes, with a relaxed remote arrival
//       (a release at the cluster's scope cost ~1,150 cycles a step); the
//       consumers release a stage on every CTA's "empty" barrier.  At
//       mp <= 64 one block of 16 warps, where the cluster was slower.
// The ring's depth, the warps a block and where a variant takes a cluster
// are fixed: each was measured in turns against the other choices (PERF.md
// gives their times and the commit whose source built them;
// benchmarks/redesign_turns.py times a build of any commit's source).
//
// fp32 FMA, no tensor cores: the precision contract (ROADMAP.md) runs every
// product in fp32 with TF32 off, and this fmaf chain is H1's.  No atomics
// in the arithmetic: two calls are bit for bit equal.  The launch
// allocates nothing and is capturable.  A -DSP_STAMPS build records the
// chain's phases (%globaltimer and clock64: each step's publish, and when
// the next step's producer had waited for it), read by
// csl_sweep_probe_stamps.
#include "sweep.cuh"

#define SP_RING 8          // stages of the ring
#define SP_WARPS 16        // warps of one block (a cluster's CTAs: 4 rows a warp)
#define SP_WIDE4_CLUSTER 8 // wide4 at mp > 64: CTAs a cluster (everything else one block)
#define SP_PLAN 10         // values csl_sweep_probe_plan reports

namespace {

using csl_sweep::apply_pivot;
using csl_sweep::apply_pivot_diag;
using csl_sweep::sweep_pivot;

constexpr int MAX_MP = 128;
static_assert(SP_RING >= 2, "the producer of step k + 1 releases step k after publishing");

// Rows a warp: one block splits the W = 32 Q rows over SP_WARPS warps; a
// cluster's CTAs hold 4 rows a warp (whole pairs for wide4).
__host__ __device__ constexpr int warp_rows(int q, int c) { return c == 1 ? 32 * q / SP_WARPS : 4; }

// ---------------------------------------------------------------- stamps

#ifdef SP_STAMPS
#define SP_MAX_STEPS 64
#define SP_NSTAMP ((SP_MAX_STEPS + 8) * 4)
// [step][0, 1]: %globaltimer, clock64 when the step was published;
// [step][2, 3]: when the next step's producer had waited for it;
// [SP_MAX_STEPS + rank][0, 1, 2, 3]: a CTA's start, end (%globaltimer), SM,
// and its clock64 at the start.
__device__ unsigned long long g_sp_stamps[SP_NSTAMP];

__device__ __forceinline__ unsigned long long sp_gtime() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

__device__ __forceinline__ void sp_stamp(int step, int which) {
    if ((threadIdx.x & 31) == 0 && step < SP_MAX_STEPS) {
        g_sp_stamps[step * 4 + which] = sp_gtime();
        g_sp_stamps[step * 4 + which + 1] = clock64();
    }
}

// A CTA's start (which 0) or end (1); at the start CTA 0 also clears the
// rows of CTAs past this launch's `ctas`.
__device__ __forceinline__ void sp_stamp_cta(int rank, int which, int ctas) {
    if (threadIdx.x == 0) {
        if (which == 0 && rank == 0)
            for (int r = ctas; r < 8; ++r)
                for (int e = 0; e < 4; ++e) g_sp_stamps[(SP_MAX_STEPS + r) * 4 + e] = 0;
        unsigned sm;
        asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
        unsigned long long* row = g_sp_stamps + (SP_MAX_STEPS + rank) * 4;
        row[which] = sp_gtime();
        row[2] = sm;
        if (which == 0) row[3] = clock64();
    }
}
#else
__device__ __forceinline__ void sp_stamp(int, int) {}
__device__ __forceinline__ void sp_stamp_cta(int, int, int) {}
#endif

// ------------------------------------------------- barriers and the ring

__device__ __forceinline__ unsigned cta_rank() {
    unsigned r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
    return r;
}

// A shared::cta address in CTA `rank`'s window of the cluster.
__device__ __forceinline__ unsigned map_rank(unsigned addr, unsigned rank) {
    unsigned out;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
    return out;
}

__device__ __forceinline__ void cluster_sync() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Wait for the phase of parity `parity` of the barrier at `bar` to
// complete, acquiring at the cluster's scope when its arrivals may come
// from other CTAs.
template <bool CLUSTER>
__device__ __forceinline__ void bar_wait(unsigned bar, unsigned parity) {
    unsigned done = 0;
    while (!done) {
        if constexpr (CLUSTER)
            asm volatile(
                "{\n .reg .pred p;\n"
                " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
                " selp.u32 %0, 1, 0, p;\n}\n"
                : "=r"(done) : "r"(bar), "r"(parity) : "memory");
        else
            asm volatile(
                "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                " selp.u32 %0, 1, 0, p;\n}\n"
                : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    }
}

__device__ __forceinline__ void arrive_local(unsigned bar) {
    asm volatile("{\n .reg .b64 state;\n mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
                     bar)
                 : "memory");
}

// `count` arrivals at once on another CTA's barrier.
__device__ __forceinline__ void arrive_remote(unsigned bar, unsigned count) {
    asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0], %1;\n" ::"r"(bar),
                 "r"(count)
                 : "memory");
}

// The same with no ordering of this thread's earlier accesses: the
// publish's arrival, whose data the bulk copy's bytes complete.
__device__ __forceinline__ void arrive_remote_relaxed(unsigned bar, unsigned count) {
    asm volatile("mbarrier.arrive.relaxed.cluster.shared::cluster.b64 _, [%0], %1;\n" ::"r"(bar),
                 "r"(count)
                 : "memory");
}

__device__ __forceinline__ void expect_remote(unsigned bar, unsigned bytes) {
    asm volatile("mbarrier.expect_tx.relaxed.cluster.shared::cluster.b64 [%0], %1;\n" ::"r"(bar),
                 "r"(bytes)
                 : "memory");
}

// A bulk copy of `bytes` from this CTA's shared memory into another's,
// completing on that CTA's barrier `bar` by its bytes.
__device__ __forceinline__ void bulk_to_peer(unsigned dst, unsigned src, unsigned bytes,
                                             unsigned bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(dst), "r"(src), "r"(bytes), "r"(bar)
        : "memory");
}

// The ring of one CTA: R stages of (g, h), W entries of type T each (T =
// float2 for a classic pivot, float4 for a pair), then the R "full" and R
// "empty" barriers.  "full" takes one arrival a phase: the producer's lane
// 0 after __syncwarp, or, when the producer lies in another CTA, its
// remote arrival after the bytes of its bulk copy are expected; "empty"
// takes one a warp of the cluster.
constexpr unsigned FULL_ARRIVALS = 1;

template <typename T, int W, int R, int C>
struct Ring {
    T gh[R][2][W];
    unsigned long long full_bar[R];
    unsigned long long empty_bar[R];

    __device__ __forceinline__ T* g(int s) { return gh[s][0]; }
    __device__ __forceinline__ T* h(int s) { return gh[s][1]; }
    __device__ __forceinline__ unsigned full(int s) { return csl_smem_addr(full_bar + s); }
    __device__ __forceinline__ unsigned empty(int s) { return csl_smem_addr(empty_bar + s); }

    // Both barriers of every stage, by one thread, before a block (cluster)
    // barrier.
    __device__ __forceinline__ void init(unsigned empties) {
        for (int r = 0; r < R; ++r) {
            asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(full(r)),
                         "r"(FULL_ARRIVALS) : "memory");
            asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(empty(r)), "r"(empties)
                         : "memory");
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }

    // Step t's stage has been filled.
    __device__ __forceinline__ void wait_full(int t) {
        bar_wait<(C > 1)>(full(t % R), (unsigned)((t / R) & 1));
    }

    // Step t's stage may be filled: every warp of the cluster has released
    // step t - R.
    __device__ __forceinline__ void wait_empty(int t) {
        if (t >= R) bar_wait<(C > 1)>(empty(t % R), (unsigned)(((t / R) & 1) ^ 1));
    }

    // This warp is done reading step t's stage (after __syncwarp): one
    // arrival on the stage's "empty" barrier of every CTA of the cluster.
    __device__ __forceinline__ void release(int t) {
        const int lane = threadIdx.x & 31;
        if constexpr (C == 1) {
            if (lane == 0) arrive_local(empty(t % R));
        } else {
            if (lane < C) arrive_remote(map_rank(empty(t % R), (unsigned)lane), 1u);
        }
    }

    // Publish step t once every lane has written its entries of g and h
    // into its own CTA's stage: lane 0's arrival there, and then, in a
    // cluster, the stage copied into every other CTA's by one bulk copy
    // each (lane r to CTA r), which completes on that CTA's "full" barrier.
    __device__ __forceinline__ void publish(int t) {
        const int s = t % R;
        const int lane = threadIdx.x & 31;
        if constexpr (C > 1)   // this lane's stores, before the copies read them
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncwarp();          // every lane's stores, before lane 0's release
        if (lane == 0) arrive_local(full(s));
        if constexpr (C > 1) {
            if (lane < C && lane != (int)cta_rank()) {
                constexpr unsigned bytes = 2u * W * sizeof(T);
                const unsigned src = csl_smem_addr(gh[s]);
                const unsigned bar = map_rank(full(s), (unsigned)lane);
                expect_remote(bar, bytes);
                bulk_to_peer(map_rank(src, (unsigned)lane), src, bytes, bar);
                arrive_remote_relaxed(bar, FULL_ARRIVALS);
            }
        }
    }
};

// The RW rows row0 + a of S (columns tx + 32 b), zero past mp.
template <int Q, int RW>
__device__ __forceinline__ void load_rows(const float* __restrict__ s, int mp, int row0,
                                          float (&A)[RW][Q]) {
    const int tx = threadIdx.x & 31;
#pragma unroll
    for (int a = 0; a < RW; ++a) {
        const int i = row0 + a;
#pragma unroll
        for (int b = 0; b < Q; ++b) {
            const int j = tx + 32 * b;
            A[a][b] = (i < mp && j < mp) ? __ldg(s + i * mp + j) : 0.f;
        }
    }
}

template <int Q, int RW>
__device__ __forceinline__ void store_neg(float* __restrict__ out, int mp, int row0,
                                          const float (&A)[RW][Q]) {
    const int tx = threadIdx.x & 31;
#pragma unroll
    for (int a = 0; a < RW; ++a) {
        const int i = row0 + a;
#pragma unroll
        for (int b = 0; b < Q; ++b) {
            const int j = tx + 32 * b;
            if (i < mp && j < mp) out[i * mp + j] = -A[a][b];
        }
    }
}

// The wide4 tail, one classic pivot k: every row of the warp takes it,
// rows 2k, 2k + 1 with the pivot diagonal piv.
template <int Q, int RW>
__device__ __forceinline__ void tail_step(float (&A)[RW][Q], const float2* G, const float2* H,
                                          int k, float piv, int row0) {
    const int tx = threadIdx.x & 31;
    float2 gr[Q], hr[RW];
#pragma unroll
    for (int b = 0; b < Q; ++b) gr[b] = G[tx + 32 * b];
#pragma unroll
    for (int a = 0; a < RW; a += 2) {   // two rows' h in one 16-byte read
        const float4 h2 = *reinterpret_cast<const float4*>(H + row0 + a);
        hr[a] = make_float2(h2.x, h2.y);
        hr[a + 1] = make_float2(h2.z, h2.w);
    }
#pragma unroll
    for (int a = 0; a < RW; ++a) {
        const int i = row0 + a;
        if (i == 2 * k || i == 2 * k + 1)
            apply_pivot_diag<Q>(A[a], hr[a], gr, i, piv);
        else
            apply_pivot<Q>(A[a], hr[a], gr);
    }
}

// Rows row0 + 2 j, + 1 (a warp's row pair j) take pivot k from its stage
// (g at the lane's columns, h at the two rows): plainly, or, for the pair's
// own pivot, with the pivot diagonal piv.
template <int Q, int RW>
__device__ __forceinline__ void take_pivot(float (&A)[RW][Q], const float2* G, const float2* H,
                                           int j, int row0, bool own, float piv) {
    const int tx = threadIdx.x & 31;
    float2 gr[Q];
#pragma unroll
    for (int b = 0; b < Q; ++b) gr[b] = G[tx + 32 * b];
    const float4 h2 = *reinterpret_cast<const float4*>(H + row0 + 2 * j);
    const float2 h0 = make_float2(h2.x, h2.y), h1 = make_float2(h2.z, h2.w);
    if (own) {
        apply_pivot_diag<Q>(A[2 * j], h0, gr, row0 + 2 * j, piv);
        apply_pivot_diag<Q>(A[2 * j + 1], h1, gr, row0 + 2 * j + 1, piv);
    } else {
        apply_pivot<Q>(A[2 * j], h0, gr);
        apply_pivot<Q>(A[2 * j + 1], h1, gr);
    }
}

// Pivots [k0, k1), none of them this warp's: every row takes each plainly,
// UN pivots a loop body.
template <int Q, int RW, int UN, class V>
__device__ __forceinline__ void consume(float (&A)[RW][Q], V& ring, int k0, int k1, int row0) {
    const int tx = threadIdx.x & 31;
#pragma unroll 1
    for (int kb = k0; kb < k1; kb += UN) {
#pragma unroll
        for (int u = 0; u < UN; ++u) {
            const int k = kb + u;
            if (k >= k1) break;
            ring.wait_full(k);
            const float2* G = ring.g(k % SP_RING);
            const float2* H = ring.h(k % SP_RING) + row0;
            float2 gr[Q], hr[RW];
#pragma unroll
            for (int b = 0; b < Q; ++b) gr[b] = G[tx + 32 * b];
#pragma unroll
            for (int a = 0; a < RW; a += 2) {   // two rows' h in one 16-byte read
                const float4 h2 = *reinterpret_cast<const float4*>(H + a);
                hr[a] = make_float2(h2.x, h2.y);
                hr[a + 1] = make_float2(h2.z, h2.w);
            }
#pragma unroll
            for (int a = 0; a < RW; ++a) apply_pivot<Q>(A[a], hr[a], gr);
            __syncwarp();
            ring.release(k);
        }
    }
}

// unroll2 / unroll4: the classic sweep, UN pivots a consumer loop body;
// pivot k is step k of the ring.  Warp w holds the P = RW / 2 pivots
// base = row0 / 2 .. base + P - 1 (those below nb) and forms them in one
// run: its row pair j takes pivot base - 1 (the previous warp's last) and
// the pivots base .. base + j - 1 it formed itself, and forms and publishes
// pivot base + j; only after its last publish does each pair take its own
// pivot (with the diagonal) and the later ones of the run.  So the run's
// chain carries no update but the next pair's, and the warp's other pivots
// are plain consumer steps.  Each row takes the pivots in H1's order with
// H1's fmaf chain.  One block of SP_WARPS warps.
template <int Q, int UN>
__global__ void __launch_bounds__(32 * SP_WARPS, 1)
sweep_unroll_kernel(const float* __restrict__ s, float* __restrict__ out, int mp, int nb) {
    constexpr int W = 32 * Q, RW = warp_rows(Q, 1), R = SP_RING, P = RW / 2;
    static_assert(R >= P + 2, "a run holds its stages and the one before until its end");
    __shared__ __align__(16) Ring<float2, W, R, 1> ring;
    const int row0 = (int)(threadIdx.x >> 5) * RW, base = row0 / 2;
    sp_stamp_cta(0, 0, 1);
    float A[RW][Q];
    load_rows<Q, RW>(s, mp, row0, A);
    if (threadIdx.x == 0) ring.init(SP_WARPS);
    __syncthreads();
    if (base >= nb) {
        consume<Q, RW, UN>(A, ring, 0, nb, row0);
    } else {
        const int end = min(base + P, nb);   // this warp's run: pivots base .. end - 1
        consume<Q, RW, UN>(A, ring, 0, max(base - 1, 0), row0);
        if (base > 0) {
            ring.wait_full(base - 1);
            sp_stamp(base - 1, 2);
        }
        bool ok[P];
#pragma unroll
        for (int j = 0; j < P; ++j) {
            ok[j] = false;
            if (base > 0)
                take_pivot<Q, RW>(A, ring.g((base - 1) % R), ring.h((base - 1) % R), j, row0,
                                  false, 0.f);
#pragma unroll
            for (int i = 0; i < j; ++i)
                if (base + i < end)
                    take_pivot<Q, RW>(A, ring.g((base + i) % R), ring.h((base + i) % R), j, row0,
                                      false, 0.f);
            if (base + j < end) {
                const int k = base + j;
                if (j > 0) sp_stamp(k - 1, 2);
                ring.wait_empty(k);
                ok[j] = sweep_pivot<Q>(A[2 * j], A[2 * j + 1], 2 * k, ring.g(k % R), ring.h(k % R));
                ring.publish(k);
                sp_stamp(k, 0);
            }
        }
#pragma unroll
        for (int j = 0; j < P; ++j)
#pragma unroll
            for (int i = j; i < P; ++i)
                if (base + i < end)
                    take_pivot<Q, RW>(A, ring.g((base + i) % R), ring.h((base + i) % R), j, row0,
                                      i == j, ok[j] ? 2.f : 0.f);
        __syncwarp();
        if (base > 0) ring.release(base - 1);
        for (int k = base; k < end; ++k) ring.release(k);
        consume<Q, RW, UN>(A, ring, end, nb, row0);
    }
    store_neg<Q, RW>(out, mp, row0, A);
    sp_stamp_cta(0, 1, 1);
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
// formed from scalars alone.  Writes g = (g0..g3) a column and h =
// (h0..h3) a row; returns pivot A's and B's usability in okA, okB.
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

// wide4: the paired sweep.  Step q < npair is pair q (pivots 2q, 2q + 1);
// for an odd nb, step npair is the last pivot, classic, its stage read as
// float2.  A row's h is read where the row is updated: with four pivots'
// factors, holding every row's h at once would not fit beside A.
template <int Q, int C>
__global__ void __launch_bounds__(32 * (32 * Q / C / warp_rows(Q, C)), 1)
sweep_wide4_kernel(const float* __restrict__ s, float* __restrict__ out, int mp, int nb) {
    constexpr int W = 32 * Q, RW = warp_rows(Q, C), R = SP_RING;
    constexpr int TW = W / C / RW;
    static_assert(RW % 4 == 0, "a warp holds whole pairs");
    __shared__ __align__(16) Ring<float4, W, R, C> ring;
    const int tx = threadIdx.x & 31;
    const int rank = C > 1 ? (int)cta_rank() : 0;
    const int row0 = rank * (W / C) + (int)(threadIdx.x >> 5) * RW;
    sp_stamp_cta(rank, 0, C);
    float A[RW][Q];
    load_rows<Q, RW>(s, mp, row0, A);
    if (threadIdx.x == 0) ring.init(C * TW);
    if constexpr (C > 1) cluster_sync(); else __syncthreads();
    const int npair = nb / 2;
    const bool tail = nb & 1;
    // The classic tail's stage, read as float2.
    auto g2 = [&](int t) { return reinterpret_cast<float2*>(ring.g(t % R)); };
    auto h2 = [&](int t) { return reinterpret_cast<float2*>(ring.h(t % R)); };
    bool okA = false, okB = false, okT = false;
    if (row0 == 0) {
        if (npair > 0) {
            form_pair<Q>(A[0], A[1], A[2], A[3], 0, ring.g(0), ring.h(0), okA, okB);
            ring.publish(0);
            sp_stamp(0, 0);
        } else if (tail) {
            okT = sweep_pivot<Q>(A[0], A[1], 0, g2(0), h2(0));
            ring.publish(0);
            sp_stamp(0, 0);
        }
    }
#pragma unroll 1
    for (int q = 0; q < npair; ++q) {
        const int st = q % R;
        ring.wait_full(q);
        if (4 * q + 4 >= row0 && 4 * q + 4 < row0 + RW) sp_stamp(q, 2);
        const float4* hp = ring.h(st) + row0;
        float4 gr[Q];
#pragma unroll
        for (int b = 0; b < Q; ++b) gr[b] = ring.g(st)[tx + 32 * b];
        const float pivA = okA ? 2.f : 0.f, pivB = okB ? 2.f : 0.f;
        // The next step's rows: pair q + 1's four, or the tail pivot's two.
        const int nr = 4 * q + 4 - row0;
        const bool next_pair = q + 1 < npair, next_tail = q + 1 == npair && tail;
        const bool nxt = (next_pair || next_tail) && nr >= 0 && nr < RW;
        if (nxt) {
            float r0[Q], r1[Q], r2[Q], r3[Q];
#pragma unroll
            for (int a = 0; a < RW; a += 4)
                if (a == nr) {
#pragma unroll
                    for (int e = 0; e < 4; ++e) apply_pair<Q>(A[a + e], hp[a + e], gr, -1, 0.f);
#pragma unroll
                    for (int b = 0; b < Q; ++b) {
                        r0[b] = A[a][b];
                        r1[b] = A[a + 1][b];
                        r2[b] = A[a + 2][b];
                        r3[b] = A[a + 3][b];
                    }
                }
            ring.wait_empty(q + 1);
            if (next_pair) {
                form_pair<Q>(r0, r1, r2, r3, 4 * q + 4, ring.g((q + 1) % R), ring.h((q + 1) % R),
                             okA, okB);
                ring.publish(q + 1);
            } else {
                okT = sweep_pivot<Q>(r0, r1, 4 * q + 4, g2(q + 1), h2(q + 1));
                ring.publish(q + 1);
            }
            sp_stamp(q + 1, 0);
        }
        const int pr = 4 * q - row0;   // the pair's first row in this warp, if in [0, RW)
        if (!nxt && (pr < 0 || pr >= RW)) {   // most warps: every row a plain update
#pragma unroll
            for (int a = 0; a < RW; ++a) apply_pair<Q>(A[a], hp[a], gr, -1, 0.f);
        } else {
#pragma unroll
            for (int a = 0; a < RW; ++a) {
                if (nxt && a >= nr && a < nr + 4) continue;
                const bool mine = a >= pr && a < pr + 4;
                apply_pair<Q>(A[a], hp[a], gr, mine ? row0 + a : -1, a - pr < 2 ? pivA : pivB);
            }
        }
        __syncwarp();
        ring.release(q);
    }
    if (tail) {            // the ragged tail: one classic pivot k = 2 npair
        const int k = 2 * npair;
        ring.wait_full(npair);
        tail_step<Q, RW>(A, g2(npair), h2(npair), k, okT ? 2.f : 0.f, row0);
        __syncwarp();
        ring.release(npair);
    }
    store_neg<Q, RW>(out, mp, row0, A);
    sp_stamp_cta(rank, 1, C);
    if constexpr (C > 1) cluster_sync();   // no CTA leaves while a peer may still reach it
}

// ------------------------------------------------------------------ plan

struct Plan {
    int q;         // 32-column blocks: 2 (mp <= 64) or 4
    int cluster;   // CTAs a cluster (the grid: one cluster)
    int ring;      // stages of the ring
    int rows;      // rows a warp
    int cta_rows;  // rows a CTA
    int block;     // threads a CTA
    int smem;      // static shared memory a CTA, bytes
};

Plan make_plan(int mp, int variant) {
    const int q = mp <= 64 ? 2 : 4, w = 32 * q;
    const int c = variant == 2 && q == 4 ? SP_WIDE4_CLUSTER : 1;
    const int rows = warp_rows(q, c), cta_rows = w / c;
    const int entry = variant == 2 ? 16 : 8;   // bytes of (g or h) an entry: float4 or float2
    return Plan{q, c, SP_RING, rows, cta_rows, 32 * (cta_rows / rows),
                SP_RING * (2 * w * entry + 16)};
}

template <int Q, int C, bool WIDE>
cudaError_t launch_q(const Plan& p, const float* s, float* out, int mp, int nb, int variant,
                     cudaStream_t st, int* regs, int* local) {
    void (*kernel)(const float*, float*, int, int) = nullptr;
    if constexpr (WIDE)
        kernel = sweep_wide4_kernel<Q, C>;
    else
        kernel = variant == 0 ? sweep_unroll_kernel<Q, 2> : sweep_unroll_kernel<Q, 4>;
    if (regs) return csl_func_regs(kernel, regs, local);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(C);
    cfg.blockDim = dim3(p.block);
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = C > 1 ? 1 : 0;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, s, out, mp, nb);
    return err != cudaSuccess ? err : cudaGetLastError();
}

// The kernel of the plan: launched on (s, out, mp, nb), or, with regs, its
// registers and local bytes a thread reported instead.
cudaError_t run(const Plan& p, const float* s, float* out, int mp, int nb, int variant,
                cudaStream_t st, int* regs = nullptr, int* local = nullptr) {
    const bool wide = variant == 2;
    if (p.q == 2)
        return wide ? launch_q<2, 1, true>(p, s, out, mp, nb, variant, st, regs, local)
                    : launch_q<2, 1, false>(p, s, out, mp, nb, variant, st, regs, local);
    return wide ? launch_q<4, SP_WIDE4_CLUSTER, true>(p, s, out, mp, nb, variant, st, regs, local)
                : launch_q<4, 1, false>(p, s, out, mp, nb, variant, st, regs, local);
}

bool shapes_ok(int mp, int variant) {
    return mp > 0 && mp % 2 == 0 && mp <= MAX_MP && variant >= 0 && variant <= 2;
}

}  // namespace

// The plan at (mp, variant) as SP_PLAN ints: the 32-column blocks Q, the
// CTAs a cluster, the ring's stages, rows a warp, rows a CTA, threads a
// CTA, shared memory a CTA (bytes), the kernel's registers and local bytes
// a thread, and the grid (one cluster).  Launches nothing.
extern "C" int csl_sweep_probe_plan(int mp, int variant, int* out) {
    if (!shapes_ok(mp, variant)) return (int)cudaErrorInvalidValue;
    const Plan p = make_plan(mp, variant);
    int regs = 0, local = 0;
    const cudaError_t err = run(p, nullptr, nullptr, mp, 0, variant, nullptr, &regs, &local);
    if (err != cudaSuccess) return (int)err;
    const int vals[SP_PLAN] = {p.q, p.cluster, p.ring, p.rows, p.cta_rows, p.block, p.smem,
                               regs, local, p.cluster};
    for (int k = 0; k < SP_PLAN; ++k) out[k] = vals[k];
    return (int)cudaSuccess;
}

#ifdef SP_STAMPS
// The diagnostic build's stamps of the last launch: n values of
// g_sp_stamps into host memory.
extern "C" int csl_sweep_probe_stamps(unsigned long long* out, int n) {
    if (n < 0 || n > SP_NSTAMP) return (int)cudaErrorInvalidValue;
    return (int)cudaMemcpyFromSymbol(out, g_sp_stamps, (size_t)n * sizeof(unsigned long long));
}
#endif

// variant 0 = unroll2, 1 = unroll4, 2 = wide4; nblk pivots (clamped to
// [0, mp / 2]); mp even, at most 128.
extern "C" int csl_sweep_probe(const float* s, float* out, int mp, int nblk, int variant,
                               void* stream) {
    if (!shapes_ok(mp, variant)) return (int)cudaErrorInvalidValue;
    const int nb = nblk < 0 ? 0 : (nblk > mp / 2 ? mp / 2 : nblk);
    return (int)run(make_plan(mp, variant), s, out, mp, nb, variant, (cudaStream_t)stream);
}
