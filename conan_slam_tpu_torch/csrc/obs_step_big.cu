// H10 obs_step (obs_step.cu): the variants whose P pass runs on tiles of
// 128, the tile edge H4 takes at large D (at least 8 such upper-triangle
// tiles an SM: the 10k-landmark shape).  They compile in their own file so
// that the build compiles them beside obs_step.cu's variants, in parallel.
#include "obs_step.cuh"

namespace csl_h10 {

cudaError_t plan_big(int rx, int mp, int rp, int nbp, int* grid, size_t* smem) {
    switch (rx) {
        case 1: return plan<1, 128>(mp, rp, nbp, grid, smem);
        case 2: return plan<2, 128>(mp, rp, nbp, grid, smem);
        case 3: return plan<3, 128>(mp, rp, nbp, grid, smem);
        case 4: return plan<4, 128>(mp, rp, nbp, grid, smem);
        case 5: return plan<5, 128>(mp, rp, nbp, grid, smem);
        case 6: return plan<6, 128>(mp, rp, nbp, grid, smem);
        default: return plan<7, 128>(mp, rp, nbp, grid, smem);
    }
}

cudaError_t launch_big(int rx, const Frame& f, cudaStream_t stream) {
    switch (rx) {
        case 1: return launch_tile<1, 128>(f, stream);
        case 2: return launch_tile<2, 128>(f, stream);
        case 3: return launch_tile<3, 128>(f, stream);
        case 4: return launch_tile<4, 128>(f, stream);
        case 5: return launch_tile<5, 128>(f, stream);
        case 6: return launch_tile<6, 128>(f, stream);
        default: return launch_tile<7, 128>(f, stream);
    }
}

}  // namespace csl_h10
