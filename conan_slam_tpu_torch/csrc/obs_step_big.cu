// H10 obs_step (obs_step.cu): its P pass on tiles of 128, the tile edge H4
// takes at large D (at least 8 such upper-triangle tiles an SM: the
// 10k-landmark shape), two tiles at a time in persistent 512-thread blocks
// (csl_res::PassShape<128>), with its plan and launch.  The frame kernel's
// variants and the 32-tile pass are in obs_step.cu; this file compiles
// beside it, in parallel.
#include "obs_step.cuh"

namespace csl_h10 {

cudaError_t plan_pass_big(int d, bool vecp, csl_res::PassPlan* plan) {
    DeviceInfo* info = nullptr;
    const cudaError_t err = device_info(&info);
    if (err != cudaSuccess) return err;
    csl_res::PassInfo* pi = &info->pass[1][vecp ? 1 : 0];
    return vecp ? csl_res::plan_pass<128>(obs_pass_kernel<128, true>, d, pi, plan)
                : csl_res::plan_pass<128>(obs_pass_kernel<128, false>, d, pi, plan);
}

cudaError_t launch_pass_big(const Frame& f, unsigned long long* stamps, cudaStream_t stream) {
    csl_res::PassPlan plan;
    const cudaError_t err = plan_pass_big(f.d, f.vecp != 0, &plan);
    if (err != cudaSuccess) return err;
    return f.vecp ? csl_res::launch_pass<128>(obs_pass_kernel<128, true>, plan, f.p, f.g, f.mg,
                                              f.p_out, f.d, f.ldg, f.nbp + f.mp, stamps, stream)
                  : csl_res::launch_pass<128>(obs_pass_kernel<128, false>, plan, f.p, f.g, f.mg,
                                              f.p_out, f.d, f.ldg, f.nbp + f.mp, stamps, stream);
}

cudaError_t pass_regs_big(int* regs, int* local) {
    return csl_func_regs(obs_pass_kernel<128, true>, regs, local);
}

}  // namespace csl_h10
