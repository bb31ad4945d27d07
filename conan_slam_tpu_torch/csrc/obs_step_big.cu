// H10 obs_step (obs_step.cu): its P pass at large D, the streamed 128-tiles
// (csl_res::stream_tiles, one persistent block an SM that brings P in and
// out by tensor copies (TMA) under its FMAs; csl_res::pass_route picks it where D
// gives at least 8 such tiles an SM and P's rows take 16-byte copies: the
// 10k-landmark shape), with its plan and launch.  The frame kernel's
// variants and the 32-tile pass are in obs_step.cu; this file compiles
// beside it, in parallel.
#include "obs_step.cuh"

namespace csl_h10 {

cudaError_t plan_pass_big(int d, csl_res::PassPlan* plan) {
    DeviceInfo* info = nullptr;
    const cudaError_t err = device_info(&info);
    if (err != cudaSuccess) return err;
    return csl_res::plan_pass<csl_res::PASS_128>(obs_pass_kernel<csl_res::PASS_128, true>, d,
                                                 &info->pass128, plan);
}

cudaError_t launch_pass_big(const Frame& f, unsigned long long* stamps, cudaStream_t stream) {
    csl_res::PassPlan plan;
    const cudaError_t err = plan_pass_big(f.d, &plan);
    if (err != cudaSuccess) return err;
    return csl_res::launch_pass<csl_res::PASS_128>(obs_pass_kernel<csl_res::PASS_128, true>, plan,
                                                   f.p, f.g, f.mg, f.p_out, f.d, f.ldg,
                                                   f.nbp + f.mp, stamps, stream);
}

cudaError_t pass_regs_big(int* regs, int* local) {
    return csl_func_regs(obs_pass_kernel<csl_res::PASS_128, true>, regs, local);
}

}  // namespace csl_h10
