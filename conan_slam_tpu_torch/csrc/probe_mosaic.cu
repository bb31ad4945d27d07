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
// hc (MP, RP) transposed (read as a broadcast along a warp).  One block a
// 32-column panel of D, 8 row groups: the block stages its (RP, 32) panel
// of prows, all of hc and all of si in shared memory; thread (tx, ty)
// forms column n0 + tx of phtt for the MP / 8 rows ty, ty + 8, ... in
// registers, one pass over k, keeps the panel in shared memory, then forms
// the same column of sipht the same way and (row group 0) sivpht.  What
// bounds it on the card: at the probe's shape (D 512, MP 128, RP 136) 35
// MFLOP and 0.9 MB, half a microsecond either way; 16 blocks of 256
// threads hold a chain of ~260 FMAs each 16 wide.  fp32 FMA, no tensor
// cores, no cuBLAS.
//
// H14 replaces the TPU kernel benchmarks/probe_mosaic.py:122 probe_observe
// (_observe_core alone in one pallas_call).  One block runs the port's
// observe device code alone on (xrows, zin, rsc) and writes the dense
// operator Hc (MP, RP), block-diagonal R (MP, MP) (identity on masked rows)
// and the innovation v (MP,):
//   path 0: the known frame's csl_chain_observe (chain_band.cuh), which H2
//           and H9 run, with the frame scalars at the given pose and no
//           heading correction (corr0 = 0, g = 0, P e2 = 0);
//   path 1: the gated frame's csl_obs_observe (obs_band.cuh), which H7 and
//           H10 run.
// So a change to that device code shows here.  It is latency: one thread a
// measurement, atan2f and a division chain.
#include "chain_band.cuh"
#include "obs_band.cuh"

namespace {

constexpr int DW = 32;   // H13's columns a block
constexpr int DH = 8;    // its row groups
constexpr int DR = 16;   // rows a thread: MP <= DH DR = 128

__global__ void __launch_bounds__(DW * DH)
probe_dots_kernel(const float* __restrict__ prows, const float* __restrict__ hc,
                  const float* __restrict__ si, const float* __restrict__ siv,
                  float* __restrict__ phtt, float* __restrict__ sipht,
                  float* __restrict__ sivpht, int d, int mp, int rp) {
    extern __shared__ __align__(16) float smem[];
    float* hs = smem;              // (mp, rp) hc
    float* ss = hs + mp * rp;      // (mp, mp) si
    float* pp = ss + mp * mp;      // (rp, DW) this block's columns of prows
    float* ph = pp + rp * DW;      // (mp, DW + 1) this block's columns of phtt, transposed
    const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * DW + tx, nth = DW * DH;
    const int n0 = blockIdx.x * DW, n = n0 + tx;
    const bool live = n < d;
    for (int e = tid; e < mp * rp; e += nth) hs[e] = __ldg(hc + e);
    for (int e = tid; e < mp * mp; e += nth) ss[e] = __ldg(si + e);
    for (int k = ty; k < rp; k += DH)
        pp[k * DW + tx] = live ? __ldg(prows + (size_t)k * d + n) : 0.f;
    __syncthreads();

    // phtt[n, m] = sum_k prows[k, n] hc[m, k], for m = ty + DH j.
    float acc[DR];
#pragma unroll
    for (int j = 0; j < DR; ++j) acc[j] = 0.f;
    for (int k = 0; k < rp; ++k) {
        const float pv = pp[k * DW + tx];
#pragma unroll
        for (int j = 0; j < DR; ++j)
            if (ty + DH * j < mp) acc[j] = fmaf(pv, hs[(ty + DH * j) * rp + k], acc[j]);
    }
#pragma unroll
    for (int j = 0; j < DR; ++j)
        if (ty + DH * j < mp) ph[(ty + DH * j) * (DW + 1) + tx] = acc[j];
    __syncthreads();
    // The panel of phtt (DW rows of D x mp), coalesced along m.
    for (int e = tid; e < DW * mp; e += nth) {
        const int c = e / mp, m = e - c * mp;
        if (n0 + c < d) phtt[(size_t)(n0 + c) * mp + m] = ph[m * (DW + 1) + c];
    }
    // sipht[m, n] = sum_l si[m, l] phtt[n, l]; sivpht[n] = sum_l siv[l] phtt[n, l].
#pragma unroll
    for (int j = 0; j < DR; ++j) acc[j] = 0.f;
    float accv = 0.f;
    for (int l = 0; l < mp; ++l) {
        const float pv = ph[l * (DW + 1) + tx];
#pragma unroll
        for (int j = 0; j < DR; ++j)
            if (ty + DH * j < mp) acc[j] = fmaf(ss[(ty + DH * j) * mp + l], pv, acc[j]);
        if (ty == 0) accv = fmaf(__ldg(siv + l), pv, accv);
    }
    if (live) {
#pragma unroll
        for (int j = 0; j < DR; ++j)
            if (ty + DH * j < mp) sipht[(size_t)(ty + DH * j) * d + n] = acc[j];
        if (ty == 0) sivpht[n] = accv;
    }
}

constexpr int OBS_THREADS = 256;

__global__ void __launch_bounds__(OBS_THREADS)
probe_observe_kernel(const float* __restrict__ xrows, const float* __restrict__ zin,
                     const float* __restrict__ rsc, float* __restrict__ hc_out,
                     float* __restrict__ rmat, float* __restrict__ v, int mp, int rp, int path) {
    extern __shared__ __align__(16) float smem[];
    const int nzl = mp / 2, rpa = (rp + 3) & ~3;
    float* xr = smem;                  // (rp,) the gathered mean
    float* p2r = xr + rpa;             // (rp,) P e2 at the rows: zero
    float* zs = p2r + rpa;             // (3, nzl) zin
    float* hcs = zs + ((3 * nzl + 3) & ~3);   // (8, mp) compact Hc (and v) as structure of arrays
    float* ms = hcs + 8 * mp;          // (32,) the frame scalars
    const int tid = threadIdx.x, nth = blockDim.x;
    for (int e = tid; e < rp; e += nth) {
        xr[e] = __ldg(xrows + e);
        p2r[e] = 0.f;
    }
    for (int e = tid; e < 3 * nzl; e += nth) zs[e] = __ldg(zin + e);
    for (int e = tid; e < 32; e += nth) ms[e] = e < 3 ? __ldg(xrows + e) : 0.f;
    __syncthreads();
    if (path == 0)
        csl_chain_observe(ms, xr, p2r, zs, hcs, mp, rp);
    else
        csl_obs_observe(xr, zs, hcs, mp, rp);
    __syncthreads();
    const int vrow = path == 0 ? 7 : 5;
    for (int e = tid; e < mp * rp; e += nth) {
        const int i = e / rp, c = e - i * rp, cx = 3 + 2 * (i / 2);
        hc_out[e] = c < 3 ? hcs[c * mp + i]
                          : c == cx ? hcs[3 * mp + i] : c == cx + 1 ? hcs[4 * mp + i] : 0.f;
    }
    for (int e = tid; e < mp * mp; e += nth) {
        const int i = e / mp, j = e - i * mp;
        float r = 0.f;
        if (i / 2 == j / 2) {
            const int ri = i & 1, rj = j & 1;
            r = zs[2 * nzl + i / 2] > 0.f ? __ldg(rsc + 2 * ri + rj) : (ri == rj ? 1.f : 0.f);
        }
        rmat[e] = r;
    }
    for (int i = tid; i < mp; i += nth) v[i] = hcs[vrow * mp + i];
}

constexpr int MAX_DEVICES = 64;
int g_dots_smem[MAX_DEVICES] = {};

size_t dots_smem_bytes(int mp, int rp) {
    return (size_t)(mp * rp + mp * mp + rp * DW + mp * (DW + 1)) * sizeof(float);
}

// H14's shared memory (floats): xr and p2r, zin (its end rounded to 16
// bytes: the observe stores Hc as float2), Hc as structure of arrays, ms.
int observe_smem_floats(int mp, int rp) {
    return 2 * ((rp + 3) & ~3) + ((3 * (mp / 2) + 3) & ~3) + 8 * mp + 32;
}

}  // namespace

extern "C" int csl_probe_dots(const float* prows, const float* hc, const float* si,
                              const float* siv, float* phtt, float* sipht, float* sivpht, int d,
                              int mp, int rp, void* stream) {
    if (d <= 0 || mp <= 0 || mp > DH * DR || rp <= 0) return (int)cudaErrorInvalidValue;
    const size_t smem = dots_smem_bytes(mp, rp);
    if (smem > CSL_MAX_SMEM) return (int)cudaErrorInvalidValue;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
    if ((size_t)g_dots_smem[dev] < smem) {
        err = csl_allow_smem(probe_dots_kernel, smem);
        if (err != cudaSuccess) return (int)err;
        g_dots_smem[dev] = (int)smem;
    }
    probe_dots_kernel<<<(d + DW - 1) / DW, dim3(DW, DH), smem, (cudaStream_t)stream>>>(
        prows, hc, si, siv, phtt, sipht, sivpht, d, mp, rp);
    return (int)cudaGetLastError();
}

// path 0: the known frame's observe, 1: the gated frame's.  mp even.
extern "C" int csl_probe_observe(const float* xrows, const float* zin, const float* rsc,
                                 float* hc, float* rmat, float* v, int mp, int rp, int path,
                                 void* stream) {
    if (mp <= 0 || mp % 2 || rp < 3 || (path != 0 && path != 1)) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)observe_smem_floats(mp, rp) * sizeof(float);
    if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    probe_observe_kernel<<<1, OBS_THREADS, smem, (cudaStream_t)stream>>>(xrows, zin, rsc, hc,
                                                                        rmat, v, mp, rp, path);
    return (int)cudaGetLastError();
}
