// H4 rank_update: out = P + G^T (M G) for row strips G, MG of shape (r, D).
//
// Replaces the TPU kernel conan_slam_tpu/ops/pallas_update.py:50
// rank_update_t (pallas_call :164 row panels, :191 2-D tiles), at the fp32
// contract only (the bf16 split3/split4/hi6 tiers are not ported).  On the
// frame's path G = [pht; P e2; e0; e1; e2; 0] and M = blockdiag(-S^-1, K4)
// (frame_kernel._frame_gm): the whole covariance update of the frame.
//
// What bounds it on the card: FLOPs.  Per frame at D = 2304, r = 136 it is
// 2 D^2 r = 1.44 GFLOP against 2 D^2 x 4 B = 42 MB of P traffic (plus
// 2.5 MB of strips): 34 FLOP/byte, above the fp32 CUDA-core ridge of
// ~20 FLOP/byte (67 TFLOP/s over 3.35 TB/s), so the FMA pipes are the
// limit (~21 us at peak) before HBM is (~13 us).  The design is the plain
// register-tiled SGEMM shape: a 128 x 128 output tile per block, 8 x 8
// outputs per thread, k-chunks of 8 rows of both strips staged through
// shared memory (both strips are row-major over D, so each chunk load is a
// coalesced row read), and P read once and written once in the epilogue,
// out of place (G holds a row of P, so an in-place pass would read a strip
// it overwrites).  Edges are masked: any D and any r work.  Tensor cores
// (3xTF32 wgmma) and a pipelined TMA ring are later work.
#include "common.cuh"

#define TILE 128
#define BK 8
#define TDIM 16   // 16 x 16 threads, each 8 x 8 outputs strided by 16

__global__ void __launch_bounds__(TDIM * TDIM)
rank_update_kernel(const float* __restrict__ p, const float* __restrict__ g,
                   const float* __restrict__ mg, float* __restrict__ out, int d, int r) {
    __shared__ float as[BK][TILE];
    __shared__ float bs[BK][TILE];
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int tid = ty * TDIM + tx;
    const int i0 = blockIdx.y * TILE, j0 = blockIdx.x * TILE;

    float acc[8][8];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;

    for (int k0 = 0; k0 < r; k0 += BK) {
        // Stage G[k0:k0+BK, i0:i0+TILE] and MG[k0:k0+BK, j0:j0+TILE].
#pragma unroll
        for (int q = 0; q < (BK * TILE) / (TDIM * TDIM); ++q) {
            const int e = tid + q * TDIM * TDIM;
            const int kk = e / TILE, c = e % TILE;
            const int k = k0 + kk;
            const bool kin = k < r;
            as[kk][c] = (kin && i0 + c < d) ? g[(size_t)k * d + i0 + c] : 0.f;
            bs[kk][c] = (kin && j0 + c < d) ? mg[(size_t)k * d + j0 + c] : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            float av[8], bv[8];
#pragma unroll
            for (int a = 0; a < 8; ++a) av[a] = as[kk][ty + TDIM * a];
#pragma unroll
            for (int b = 0; b < 8; ++b) bv[b] = bs[kk][tx + TDIM * b];
#pragma unroll
            for (int a = 0; a < 8; ++a)
#pragma unroll
                for (int b = 0; b < 8; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
        }
        __syncthreads();
    }

#pragma unroll
    for (int a = 0; a < 8; ++a) {
        const int i = i0 + ty + TDIM * a;
        if (i >= d) continue;
#pragma unroll
        for (int b = 0; b < 8; ++b) {
            const int j = j0 + tx + TDIM * b;
            if (j < d) out[(size_t)i * d + j] = p[(size_t)i * d + j] + acc[a][b];
        }
    }
}

extern "C" int csl_rank_update(const float* p, const float* g, const float* mg, float* out,
                               int d, int r, void* stream) {
    if (d <= 0 || r <= 0) return (int)cudaErrorInvalidValue;
    const dim3 block(TDIM, TDIM);
    const dim3 grid((d + TILE - 1) / TILE, (d + TILE - 1) / TILE);
    rank_update_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(p, g, mg, out, d, r);
    return (int)cudaGetLastError();
}
