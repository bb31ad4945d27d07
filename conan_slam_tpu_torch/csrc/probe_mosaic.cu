// H13 probe_dots and H14 probe_observe: the two probes of the reference's
// Mosaic lowering checks, each one construct of the gated frame on its own.
//
// H13 replaces the TPU kernel benchmarks/probe_mosaic.py:62 probe_dots (its
// pallas_call of three transposed contractions):
//
//   phtt   = prows^T hc^T      (D, MP)     contract the gathered rows
//   sipht  = si phtt^T         (MP, D)
//   sivpht = siv phtt^T        (1, D)
//
// in the orientations H8 and H10 read these strips: prows (RP, D) by rows,
// hc (MP, RP) transposed.  What bounds it on the card: at the probe's shape
// (D 512, MP 128, RP 136) 35 MFLOP (0.52 us of fp32 FMA on 132 SMs) and
// 0.9 MB (0.27 us), so latency and the SMs it reaches.  The parent ran one
// block a 32-column panel (16 blocks on 132 SMs), staged all of hc and si
// in every block by scalar loads (132 KB: one block an SM) and read one
// shared value an FMA.
//
// The design (probe_dots_plan in ops/probes.py mirrors make_plan):
//   - A cluster of PD_G = 4 CTAs a panel of PD_W = 16 columns (D 512: 32
//     panels, 128 CTAs), the MP rows split over the cluster: CTA g holds
//     rows [g R, g R + R), R = MP / 4 rounded up to even.  Each CTA forms
//     phtt for its rows of the panel, reading only its rows of hc, into
//     the (MP, W) panel of phtt in the shared memory of every CTA of the
//     cluster (its own by stores, the others' by distributed shared
//     memory); after one cluster barrier every CTA forms sipht for its
//     rows, reading only its rows of si; CTA 0 forms sivpht, summed in one
//     fixed order (8 segments of l, then the segments in order).
//   - Staging by cp.async (16-byte where aligned, zero-filled past the
//     edges), all in flight at entry in two groups: the panel of prows and
//     the CTA's rows of hc, then its rows of si and siv, which land while
//     phtt is formed.
//   - Register tiles: a thread forms 2 rows x 2 columns, reading four k
//     (or l) of a row in one 16-byte load and two columns in one 8-byte
//     load, so every staged value feeds two FMAs, the next four k's loads
//     in flight while the current four are summed; row strides padded so
//     a warp's reads fall on distinct banks.
// fp32 FMA, no tensor cores: the precision contract (ROADMAP.md) runs
// every product in fp32 with TF32 off.  Each output is one fmaf chain in
// ascending k (l), no atomics: two calls are bit for bit equal; the launch
// allocates nothing and is capturable.  Columns past D and rows past MP
// are masked: any D, any MP <= 128, any RP.  A -DPD_STAMPS build records
// each CTA's phases (%globaltimer), read by csl_probe_dots_stamps.
//
// H14 replaces the TPU kernel benchmarks/probe_mosaic.py:122 probe_observe
// (_observe_core alone in one pallas_call).  It runs the port's observe
// device code alone on (xrows, zin, rsc) and writes the dense operator Hc
// (MP, RP), block-diagonal R (MP, MP) (identity on masked rows) and the
// innovation v (MP,):
//   path 0: the known frame's csl_chain_observe (chain_band.cuh), which H2
//           and H9 run, with the frame scalars at the given pose and no
//           heading correction (corr0 = 0, g = 0, P e2 = 0);
//   path 1: the gated frame's csl_obs_observe (obs_band.cuh), which H7 and
//           H10 run.
// So a change to that device code shows here.  What bounds it on the card:
// at the probe's shape (MP 128, RP 136) 137 KB of output (0.041 us) and
// ~0.5 us of one measurement's dependent sqrtf, atan2f and divisions, so
// latency: the launch, one load, the observe, the stores.  The parent ran
// one block of 256 threads on one SM, formed every measurement, then wrote
// the 34k entries of Hc and R as scalars with a division an entry.
//
// The design (probe_observe_plan in ops/probes.py mirrors it):
//   - A CTA of PO_THREADS threads a band of PO_ROWS output rows (whole
//     measurements): MP / PO_ROWS CTAs (64 at the probe's MP).
//   - Each CTA forms only its own measurements, through the unchanged
//     observe functions: it stages the pose and its measurements' feature
//     rows as a gathered mean of its own (xr[3 + 2 l'] = xrows[3 + 2 (l0 +
//     l')]) against RP - 2 l0, so the functions' masks (cx < rp) and every
//     value are those of the whole probe, bit for bit.
//   - Its inputs (a handful of floats) are loaded at entry, one a thread,
//     all in flight together; R's rows need none of the observe and are
//     written while its thread runs; then a warp a row of Hc, its column
//     from the lane (no division), 4-byte stores.
// Measured against it on the card (redesign_turns, PERF.md): 4 or 8 rows a
// CTA, 32, 64 or 256 threads, 16-byte stores, Hc's rows over every warp,
// and the zero pieces stored at entry or during the observe are slower or
// no faster.
// No atomics: two calls are bit for bit equal; the launch allocates nothing
// and is capturable.  A -DPO_STAMPS build records each CTA's phases
// (%globaltimer), read by csl_probe_observe_stamps.
#include <cooperative_groups.h>

#include "chain_band.cuh"
#include "obs_band.cuh"

namespace cg = cooperative_groups;

#define PD_W 16             // H13's columns a panel
#define PD_G 4              // its CTAs a cluster (a panel)
#define PD_THREADS 128      // a CTA: (PD_W / 2) column pairs x 16 row pairs
#define PD_MAX_MP 128       // 2 x 16 row pairs x PD_G
#define PD_PLAN 10          // values csl_probe_dots_plan reports

#define PO_ROWS 2           // H14's output rows a CTA (even: whole measurements)
#define PO_THREADS 128      // its threads a CTA
#define PO_PLAN 6           // values csl_probe_observe_plan reports

namespace {

// Phase stamps of a diagnostic build (-DPD_STAMPS): thread 0 of CTA b
// writes its %globaltimer (ns) into g_pd_stamps[b][k] at the kernel's
// phase boundaries (the calls of pd_stamp), and its SM into [b][6].
#ifdef PD_STAMPS
#define PD_NSTAMP 7
#define PD_STAMP_BLOCKS 4096
__device__ unsigned long long g_pd_stamps[PD_STAMP_BLOCKS * PD_NSTAMP];

__device__ __forceinline__ void pd_stamp(int k) {
    if (threadIdx.x == 0 && blockIdx.x < PD_STAMP_BLOCKS) {
        unsigned long long t;
        unsigned sm;
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
        asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
        g_pd_stamps[blockIdx.x * PD_NSTAMP + k] = t;
        g_pd_stamps[blockIdx.x * PD_NSTAMP + 6] = sm;
    }
}
#else
__device__ __forceinline__ void pd_stamp(int) {}
#endif

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }
// A staged row's stride: at least n4 + 4 and 4 mod 8 floats, so that the
// rows 2 apart that a warp reads start 8 or 24 banks apart.
__host__ __device__ constexpr int pad_ld(int n4) { return ((n4 + 7) & ~7) + 4; }
// Rows of MP a CTA: MP / PD_G rounded up to even (a thread's two rows).
__host__ __device__ constexpr int pd_rows(int mp) { return ((mp + PD_G - 1) / PD_G + 1) & ~1; }

// Shared memory of a CTA in floats: the prows panel (RP4, W), the CTA's
// rows of hc (R, pad_ld(RP4)), its rows of si (R, pad_ld(MP4)), the phtt
// panel (MP4, W), siv (MP4) and sivpht's partial sums (8, W).
__host__ __device__ constexpr int pd_smem_floats(int mp, int rp) {
    return round4(rp) * PD_W + pd_rows(mp) * pad_ld(round4(rp)) + pd_rows(mp) * pad_ld(round4(mp)) +
           round4(mp) * PD_W + round4(mp) + 8 * PD_W;
}

// 16 bytes from src, of which the first `bytes` are read and the rest zero.
__device__ __forceinline__ void cp_async16_n(float* dst, const float* src, int bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(csl_smem_addr(dst)),
                 "l"(src), "r"(bytes)
                 : "memory");
}

// Rows [0, rows_all) x columns [0, n4) of dst (row stride ld) from src (row
// stride lds): rows < rows and columns < n copied, the rest zero-filled;
// 16-byte copies when `vec` (src and lds 16-byte aligned), else 4-byte ones.
// The caller commits.
__device__ __forceinline__ void stage_rows(float* dst, int ld, const float* src, long long lds,
                                           int rows, int rows_all, int n, int n4, bool vec) {
    const int tid = threadIdx.x;
    if (vec) {
        const int c4 = n4 / 4;
        for (int e = tid; e < rows_all * c4; e += PD_THREADS) {
            const int r = e / c4, c = 4 * (e - r * c4);
            const int valid = r < rows ? min(max(n - c, 0), 4) : 0;
            cp_async16_n(dst + r * ld + c, valid ? src + r * lds + c : src, 4 * valid);
        }
    } else {
        for (int e = tid; e < rows_all * n4; e += PD_THREADS) {
            const int r = e / n4, c = e - r * n4;
            const bool in = r < rows && c < n;
            csl_cp_async4(dst + r * ld + c, in ? src + r * lds + c : src, in);
        }
    }
}

__device__ __forceinline__ bool aligned16(const void* p) {
    return (reinterpret_cast<unsigned long long>(p) & 15u) == 0;
}

// A thread's 2 x 2 tile: acc[i][j] += sum over k < k4 of rows[i][k] cols[k][j],
// rows[i] = the tile's row i (16-byte aligned, stride ld), cols[k] the
// tile's two columns in the (k4, PD_W) panel; k ascending, one fmaf each.
// The next four k's operands are loaded while the current four are summed.
__device__ __forceinline__ void tile_dots(const float* rows, int ld, const float* cols, int k4,
                                          float (&acc)[2][2]) {
    float4 a0 = *reinterpret_cast<const float4*>(rows);
    float4 a1 = *reinterpret_cast<const float4*>(rows + ld);
    float2 c[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) c[e] = *reinterpret_cast<const float2*>(cols + e * PD_W);
    for (int k = 0; k < k4; k += 4) {
        const int kn = k + 4 < k4 ? k + 4 : k;   // the last block loads itself again
        const float4 n0 = *reinterpret_cast<const float4*>(rows + kn);
        const float4 n1 = *reinterpret_cast<const float4*>(rows + ld + kn);
        float2 nc[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) nc[e] = *reinterpret_cast<const float2*>(cols + (kn + e) * PD_W);
        const float x0[4] = {a0.x, a0.y, a0.z, a0.w}, x1[4] = {a1.x, a1.y, a1.z, a1.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            acc[0][0] = fmaf(x0[e], c[e].x, acc[0][0]);
            acc[0][1] = fmaf(x0[e], c[e].y, acc[0][1]);
            acc[1][0] = fmaf(x1[e], c[e].x, acc[1][0]);
            acc[1][1] = fmaf(x1[e], c[e].y, acc[1][1]);
        }
        a0 = n0;
        a1 = n1;
#pragma unroll
        for (int e = 0; e < 4; ++e) c[e] = nc[e];
    }
}

__global__ void __cluster_dims__(PD_G, 1, 1) __launch_bounds__(PD_THREADS)
probe_dots_kernel(const float* __restrict__ prows, const float* __restrict__ hc,
                  const float* __restrict__ si, const float* __restrict__ siv,
                  float* __restrict__ phtt, float* __restrict__ sipht,
                  float* __restrict__ sivpht, int d, int mp, int rp) {
    extern __shared__ __align__(16) float smem[];
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int rp4 = round4(rp), mp4 = round4(mp), rows = pd_rows(mp);
    const int ldh = pad_ld(rp4), lds = pad_ld(mp4);
    float* pp = smem;                    // (rp4, W) the panel of prows
    float* hs = pp + rp4 * PD_W;         // (rows, ldh) this CTA's rows of hc
    float* ss = hs + rows * ldh;         // (rows, lds) its rows of si
    float* ph = ss + rows * lds;         // (mp4, W) the panel of phtt, by rows of MP
    float* sv = ph + mp4 * PD_W;         // (mp4,) siv
    float* red = sv + mp4;               // (8, W) sivpht's partial sums
    const int tid = threadIdx.x, np = tid % (PD_W / 2), mq = tid / (PD_W / 2);
    const int n0 = (int)(blockIdx.x / PD_G) * PD_W, m0 = rank * rows;
    const int here = min(max(mp - m0, 0), rows);   // this CTA's rows inside MP
    const bool dvec = (d & 3) == 0 && aligned16(prows);
    pd_stamp(0);
    // This CTA has started: the others may write into it once they have
    // waited for this (before their first store into it).
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

    // Everything in flight at entry: the operands of phtt, then those of
    // sipht and sivpht.
    stage_rows(pp, PD_W, prows + n0, d, rp, rp4, min(PD_W, d - n0), PD_W, dvec);
    stage_rows(hs, ldh, hc + (size_t)m0 * rp, rp, here, rows, rp, rp4,
               (rp & 3) == 0 && aligned16(hc));
    csl_cp_async_commit();
    const bool svec = (mp & 3) == 0 && aligned16(si);
    stage_rows(ss, lds, si + (size_t)m0 * mp, mp, here, rows, mp, mp4, svec);
    stage_rows(sv, mp4, siv, 0, 1, 1, mp, mp4, (mp & 3) == 0 && aligned16(siv));
    csl_cp_async_commit();
    csl_cp_async_wait<1>();
    __syncthreads();
    pd_stamp(1);

    // phtt[n, m] = sum_k prows[k, n] hc[m, k] for this CTA's rows: rows past
    // MP come out 0 from their zero-filled hc rows (the panel's padding).
    const int lm = 2 * mq, n = n0 + 2 * np;
    const bool live = lm < rows;
    float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    if (live) tile_dots(hs + lm * ldh, ldh, pp + 2 * np, rp4, acc);
    // The tile into the panel of every CTA of the cluster (its own and, by
    // distributed shared memory, the others': stores, no round trip), once
    // every CTA of the cluster has started.
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int m = m0 + lm + i;
        if (!live || m >= mp4) continue;
        const float2 v = make_float2(acc[i][0], acc[i][1]);
        float* dst = ph + m * PD_W + 2 * np;
#pragma unroll
        for (int g = 0; g < PD_G; ++g)
            *reinterpret_cast<float2*>(g == rank ? dst : cluster.map_shared_rank(dst, g)) = v;
        if (m < mp) {
#pragma unroll
            for (int j = 0; j < 2; ++j)
                if (n + j < d) phtt[(size_t)(n + j) * mp + m] = acc[i][j];
        }
    }

    // Every CTA's tiles have landed in every panel: after this barrier no
    // CTA touches another's memory.
    pd_stamp(2);
    csl_cp_async_wait<0>();
    cluster.sync();
    pd_stamp(3);

    // sipht[m, n] = sum_l si[m, l] phtt[n, l] for this CTA's rows.
    acc[0][0] = acc[0][1] = acc[1][0] = acc[1][1] = 0.f;
    if (live) tile_dots(ss + lm * lds, lds, ph + 2 * np, mp4, acc);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int m = m0 + lm + i;
        if (!live || m >= mp) continue;
        float* row = sipht + (size_t)m * d;
        if (n + 1 < d && (d & 1) == 0)   // two columns, 8-byte aligned
            *reinterpret_cast<float2*>(row + n) = make_float2(acc[i][0], acc[i][1]);
        else
#pragma unroll
            for (int j = 0; j < 2; ++j)
                if (n + j < d) row[n + j] = acc[i][j];
    }

    pd_stamp(4);
    // sivpht[n] = sum_l siv[l] phtt[n, l], by CTA 0: 8 segments of l, each
    // ascending, then the segments in order.
    if (rank == 0) {
        const int c = tid % PD_W, sg = tid / PD_W, len = (mp4 + 7) / 8;
        float v = 0.f;
        for (int l = sg * len; l < min(mp4, (sg + 1) * len); ++l) v = fmaf(sv[l], ph[l * PD_W + c], v);
        red[sg * PD_W + c] = v;
        __syncthreads();
        if (tid < PD_W && n0 + tid < d) {
            float t = red[tid];
#pragma unroll
            for (int g = 1; g < 8; ++g) t += red[g * PD_W + tid];
            sivpht[n0 + tid] = t;
        }
    }
    pd_stamp(5);
}

// Phase stamps of a diagnostic build (-DPO_STAMPS): thread 0 of CTA b
// writes its %globaltimer (ns) into g_po_stamps[b][k] at entry (0), staged
// (1), observed (2: its observe done), synced (3: after the barrier behind
// the observe and R's rows), its Hc row written (4) and, after a barrier,
// every thread's stores issued (5); its SM into [b][6].
#ifdef PO_STAMPS
#define PO_NSTAMP 7
#define PO_STAMP_BLOCKS 4096
__device__ unsigned long long g_po_stamps[PO_STAMP_BLOCKS * PO_NSTAMP];

__device__ __forceinline__ void po_stamp(int k) {
    if (threadIdx.x == 0 && blockIdx.x < PO_STAMP_BLOCKS) {
        unsigned long long t;
        unsigned sm;
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)::"memory");
        asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
        g_po_stamps[blockIdx.x * PO_NSTAMP + k] = t;
        g_po_stamps[blockIdx.x * PO_NSTAMP + 6] = sm;
    }
}
#else
__device__ __forceinline__ void po_stamp(int) {}
#endif

static_assert(PO_ROWS % 2 == 0 && PO_THREADS % 32 == 0, "whole measurements, whole warps");

// A CTA's shared memory (floats), each piece a multiple of 4: its gathered
// mean xr (the pose and its measurements' feature rows), P e2 at those rows
// (zero), its zin (3, PO_ROWS / 2), its compact Hc and v as structure of
// arrays (8, PO_ROWS), the frame scalars (32) and R's entries (4).
constexpr int PO_XR = (3 + PO_ROWS + 3) & ~3;
constexpr int PO_ZS = (3 * (PO_ROWS / 2) + 3) & ~3;
constexpr int PO_SMEM_FLOATS = 2 * PO_XR + PO_ZS + 8 * PO_ROWS + 32 + 4;

// One row of n floats at dst by one warp, val(c) at column c: a lane a
// column, the warp's 32 stores on one 128-byte line.  (16-byte stores
// measured slower here: redesign_turns, PERF.md.)
template <typename Val>
__device__ __forceinline__ void write_row(float* dst, int n, Val val) {
    for (int c = threadIdx.x & 31; c < n; c += 32) dst[c] = val(c);
}

__global__ void __launch_bounds__(PO_THREADS)
probe_observe_kernel(const float* __restrict__ xrows, const float* __restrict__ zin,
                     const float* __restrict__ rsc, float* __restrict__ hc_out,
                     float* __restrict__ rmat, float* __restrict__ v, int mp, int rp, int path) {
    __shared__ __align__(16) float smem[PO_SMEM_FLOATS];
    float* xr = smem;                  // (PO_XR,) this CTA's gathered mean
    float* p2r = xr + PO_XR;           // (PO_XR,) P e2 at those rows: zero
    float* zs = p2r + PO_XR;           // (3, nl) its zin
    float* hcs = zs + PO_ZS;           // (8, 2 nl) its compact Hc (and v)
    float* ms = hcs + 8 * PO_ROWS;     // (32,) the frame scalars
    float* rs = ms + 32;               // (4,) R's entries
    const int tid = threadIdx.x, warp = tid >> 5, nw = PO_THREADS / 32;
    const int nzl = mp / 2, i0 = blockIdx.x * PO_ROWS, l0 = i0 / 2;
    const int rows = min(PO_ROWS, mp - i0), nl = rows / 2;
    // The CTA's rows of the probe seen from its own measurements: feature
    // column 3 + 2 l' of its mean is the probe's 3 + 2 (l0 + l'), inside
    // RP exactly when 3 + 2 l' < RP - 2 l0.
    const int rpl = rp - 2 * l0;
    po_stamp(0);

    // Every input of the CTA at once, one load a thread: the pose, its
    // feature rows, its three rows of zin, R's four entries.
    constexpr int NX = 3 + PO_ROWS, NZ = 3 * (PO_ROWS / 2), NIN = NX + NZ + 4;
    static_assert(NIN <= PO_THREADS && PO_XR <= PO_THREADS, "one load a thread");
    float in = 0.f;
    int at = -1;                       // where in shared memory it goes
    if (tid < NX) {
        const int c = tid < 3 ? tid : 3 + 2 * l0 + (tid - 3);
        if (tid < 3 || (tid - 3 < rows && c < rp)) in = __ldg(xrows + c);
        at = tid;
    } else if (tid < NX + NZ) {
        const int q = (tid - NX) / (PO_ROWS / 2), l = (tid - NX) - q * (PO_ROWS / 2);
        if (l < nl) {
            in = __ldg(zin + q * nzl + l0 + l);
            at = (int)(zs - smem) + q * nl + l;
        }
    } else if (tid < NIN) {
        in = __ldg(rsc + tid - NX - NZ);
        at = (int)(rs - smem) + tid - NX - NZ;
    }
    if (at >= 0) smem[at] = in;
    if (tid < 3) ms[tid] = in;
    if (tid < PO_XR) p2r[tid] = 0.f;
    if (tid >= 3 && tid < 32) ms[tid] = 0.f;
    __syncthreads();
    po_stamp(1);

    // Its measurements' observe, one thread each; meanwhile the other warps
    // write its rows of R: the 2 x 2 block (identity where masked), zero
    // elsewhere.
    if (path == 0)
        csl_chain_observe(ms, xr, p2r, zs, hcs, rows, rpl);
    else
        csl_obs_observe(xr, zs, hcs, rows, rpl);
    po_stamp(2);
    for (int r = nw - 1 - warp; r < rows; r += nw) {
        const int i = i0 + r, pair = i >> 1, ri = i & 1;
        const bool seen = zs[2 * nl + (r >> 1)] > 0.f;
        const float r0 = seen ? rs[2 * ri] : (ri == 0 ? 1.f : 0.f);
        const float r1 = seen ? rs[2 * ri + 1] : (ri == 1 ? 1.f : 0.f);
        write_row(rmat + (size_t)i * mp, mp,
                  [&](int c) { return (c >> 1) == pair ? ((c & 1) ? r1 : r0) : 0.f; });
    }
    __syncthreads();
    po_stamp(3);

    // Its rows of Hc, a warp a row: the pose columns, the measurement's two
    // columns (those inside RP), zero elsewhere; and v.
    for (int r = warp; r < rows; r += nw) {
        const int i = i0 + r, cx = 3 + 2 * (i >> 1);
        const float h0 = hcs[r], h1 = hcs[rows + r], h2 = hcs[2 * rows + r];
        const float h3 = hcs[3 * rows + r], h4 = hcs[4 * rows + r];
        write_row(hc_out + (size_t)i * rp, rp, [&](int c) {
            return c < 3 ? (c == 0 ? h0 : c == 1 ? h1 : h2) : c == cx ? h3 : c == cx + 1 ? h4 : 0.f;
        });
    }
    const int vr = tid - (PO_THREADS - rows);     // v by the last threads
    if (vr >= 0) v[i0 + vr] = hcs[(path == 0 ? 7 : 5) * rows + vr];
    po_stamp(4);
#ifdef PO_STAMPS
    __syncthreads();
    po_stamp(5);
#endif
}

// The launch floor of H14's geometry: an empty kernel at its grid, block
// and arguments, timed beside it (redesign_turns, chip_smoke.py).
__global__ void __launch_bounds__(PO_THREADS)
probe_observe_floor_kernel(const float*, const float*, const float*, float*, float*, float*, int,
                           int, int) {}

constexpr int MAX_DEVICES = 64;
int g_dots_smem[MAX_DEVICES] = {};

struct DotsPlan {
    int panels;   // panels of PD_W columns
    int grid;     // CTAs: PD_G a panel
    int rows;     // rows of MP a CTA
    size_t smem;  // bytes a CTA
};

bool make_plan(int d, int mp, int rp, DotsPlan* p) {
    if (d <= 0 || mp <= 0 || mp > PD_MAX_MP || rp <= 0) return false;
    const size_t smem = (size_t)pd_smem_floats(mp, rp) * sizeof(float);
    if (smem > CSL_MAX_SMEM) return false;
    const int panels = (d + PD_W - 1) / PD_W;
    *p = DotsPlan{panels, panels * PD_G, pd_rows(mp), smem};
    return true;
}

// Raise the kernel's shared-memory cap on the current device once.
cudaError_t allow_dots_smem(size_t smem) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
    if ((size_t)g_dots_smem[dev] < smem) {
        err = csl_allow_smem(probe_dots_kernel, smem);
        if (err != cudaSuccess) return err;
        g_dots_smem[dev] = (int)smem;
    }
    return cudaSuccess;
}

// The parent's one-block shared memory (floats) at (mp, rp): the entry
// takes exactly the shapes it took, those within 48 KB.
int observe_smem_floats(int mp, int rp) {
    return 2 * ((rp + 3) & ~3) + ((3 * (mp / 2) + 3) & ~3) + 8 * mp + 32;
}

// H14's grid at (mp, rp), or 0 for a shape the entry refuses.
int observe_grid(int mp, int rp) {
    if (mp <= 0 || mp % 2 || rp < 3 || observe_smem_floats(mp, rp) * sizeof(float) > 48 * 1024)
        return 0;
    return (mp + PO_ROWS - 1) / PO_ROWS;
}

}  // namespace

// H13's plan at (d, mp, rp) on the current device, as PD_PLAN ints: the
// panel width, the panels, the grid, the cluster, the block, rows of MP a
// CTA, shared memory a CTA (bytes), the kernel's registers and local bytes
// a thread, and the clusters the card holds at once.  Launches nothing.
extern "C" int csl_probe_dots_plan(int d, int mp, int rp, int* out) {
    DotsPlan p;
    if (!make_plan(d, mp, rp, &p)) return (int)cudaErrorInvalidValue;
    cudaError_t err = allow_dots_smem(p.smem);
    int regs = 0, local = 0, clusters = 0;
    if (err == cudaSuccess) err = csl_func_regs(probe_dots_kernel, &regs, &local);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(p.grid);
    cfg.blockDim = dim3(PD_THREADS);
    cfg.dynamicSmemBytes = p.smem;
    err = cudaOccupancyMaxActiveClusters(&clusters, probe_dots_kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    const int vals[PD_PLAN] = {PD_W, p.panels, p.grid, PD_G, PD_THREADS, p.rows, (int)p.smem,
                               regs, local, clusters};
    for (int k = 0; k < PD_PLAN; ++k) out[k] = vals[k];
    return (int)cudaSuccess;
}

#ifdef PD_STAMPS
// The diagnostic build's stamps of the last launch: n values of
// g_pd_stamps ((CTA, PD_NSTAMP) row-major) into host memory.
extern "C" int csl_probe_dots_stamps(unsigned long long* out, int n) {
    if (n < 0 || n > PD_STAMP_BLOCKS * PD_NSTAMP) return (int)cudaErrorInvalidValue;
    return (int)cudaMemcpyFromSymbol(out, g_pd_stamps, (size_t)n * sizeof(unsigned long long));
}
#endif

extern "C" int csl_probe_dots(const float* prows, const float* hc, const float* si,
                              const float* siv, float* phtt, float* sipht, float* sivpht, int d,
                              int mp, int rp, void* stream) {
    DotsPlan p;
    if (!make_plan(d, mp, rp, &p)) return (int)cudaErrorInvalidValue;
    const cudaError_t err = allow_dots_smem(p.smem);
    if (err != cudaSuccess) return (int)err;
    probe_dots_kernel<<<p.grid, PD_THREADS, p.smem, (cudaStream_t)stream>>>(
        prows, hc, si, siv, phtt, sipht, sivpht, d, mp, rp);
    return (int)cudaGetLastError();
}

// H14's plan at (mp, rp) on the current device, as PO_PLAN ints: rows a
// CTA, the grid, the block, shared memory a CTA (bytes), the kernel's
// registers and local bytes a thread.  Launches nothing.
extern "C" int csl_probe_observe_plan(int mp, int rp, int* out) {
    const int grid = observe_grid(mp, rp);
    if (grid == 0) return (int)cudaErrorInvalidValue;
    int regs = 0, local = 0;
    const cudaError_t err = csl_func_regs(probe_observe_kernel, &regs, &local);
    if (err != cudaSuccess) return (int)err;
    const int vals[PO_PLAN] = {PO_ROWS, grid, PO_THREADS, (int)(PO_SMEM_FLOATS * sizeof(float)),
                               regs, local};
    for (int k = 0; k < PO_PLAN; ++k) out[k] = vals[k];
    return (int)cudaSuccess;
}

#ifdef PO_STAMPS
// The diagnostic build's stamps of the last launch: n values of
// g_po_stamps ((CTA, PO_NSTAMP) row-major) into host memory.
extern "C" int csl_probe_observe_stamps(unsigned long long* out, int n) {
    if (n < 0 || n > PO_STAMP_BLOCKS * PO_NSTAMP) return (int)cudaErrorInvalidValue;
    return (int)cudaMemcpyFromSymbol(out, g_po_stamps, (size_t)n * sizeof(unsigned long long));
}
#endif

// path 0: the known frame's observe, 1: the gated frame's.  mp even.
extern "C" int csl_probe_observe(const float* xrows, const float* zin, const float* rsc,
                                 float* hc, float* rmat, float* v, int mp, int rp, int path,
                                 void* stream) {
    const int grid = observe_grid(mp, rp);
    if (grid == 0 || (path != 0 && path != 1)) return (int)cudaErrorInvalidValue;
    probe_observe_kernel<<<grid, PO_THREADS, 0, (cudaStream_t)stream>>>(xrows, zin, rsc, hc, rmat,
                                                                       v, mp, rp, path);
    return (int)cudaGetLastError();
}

// The empty kernel at H14's launch (its grid, block and arguments): the
// card's floor for a launch of this shape.  Refuses what H14 refuses.
extern "C" int csl_probe_observe_floor(const float* xrows, const float* zin, const float* rsc,
                                       float* hc, float* rmat, float* v, int mp, int rp, int path,
                                       void* stream) {
    const int grid = observe_grid(mp, rp);
    if (grid == 0 || (path != 0 && path != 1)) return (int)cudaErrorInvalidValue;
    probe_observe_floor_kernel<<<grid, PO_THREADS, 0, (cudaStream_t)stream>>>(
        xrows, zin, rsc, hc, rmat, v, mp, rp, path);
    return (int)cudaGetLastError();
}
