"""The gated frame's factors (port of
conan_slam_tpu.ops.factor_kernel.frame_factors_fused).

The frame's S predict + heading sub-steps compound into one symmetric rank
update P0 + vtf^T B vtf (filters.ekf.fastframe).  Kernel H5
(``csrc/factor_strip.cu``) writes the post-frame mean, the pose trace, the
row-major factor strip vtf (NBP, D) and B (NBP, NBP), zero-padded from
NB = 2 + 3S to NBP = round_up(NB, 8); every block reruns the coefficient
recursion that H2 runs too (``csrc/coeff.cuh``, to 256 sub-steps) and
writes its column panel.
The plain version is ``fastframe.frame_factors`` padded the same way.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import torch
import torch.nn.functional as F

from conan_slam_tpu_torch.ops import cuda
from conan_slam_tpu_torch.ops.frame_kernel import MAX_STEPS, _pack_ctrl, _past_the_kernels

if TYPE_CHECKING:   # filters.ekf imports this module
    from conan_slam_tpu_torch.filters.ekf.state import EKFState

FACTOR_STRIP = cuda.CudaKernel(
    "factor_strip", "csl_factor_strip",
    [cuda.P] * 8 + [cuda.I, cuda.I, cuda.I, cuda.F, cuda.F, cuda.F, cuda.I],
    source="conan_slam_tpu_torch/csrc/factor_strip.cu",
    replaces="conan_slam_tpu/ops/factor_kernel.py:266 (frame_factors_fused -> pallas_call :316)",
)


def factor_shapes(s_steps: int, use_heading: bool) -> tuple[int, int]:
    """(NB, NBP): factor columns of an S-step frame and their padding to 8."""
    nb = 2 + 2 * s_steps + (s_steps if use_heading else 0)
    return nb, ((nb + 7) // 8) * 8


def _frame_factors_reference(state: EKFState, vns, swans, phi_meas, active, q_cov,
                             wheel_base, dt, sigma_heading, use_heading: bool):
    """Plain version of H5: fastframe.frame_factors with the strip
    transposed and zero-padded to NBP rows."""
    from conan_slam_tpu_torch.filters.ekf.fastframe import frame_factors

    new_state, pose_trace, vmat, bmat = frame_factors(
        state, vns, swans, phi_meas, active, q_cov, wheel_base, dt,
        sigma_heading, use_heading,
    )
    nb, nbp = factor_shapes(vns.shape[0], use_heading)
    vtf = F.pad(vmat.T, (0, 0, 0, nbp - nb)).contiguous()   # row-major, as H5 writes it
    return new_state, pose_trace, vtf, F.pad(bmat, (0, nbp - nb, 0, nbp - nb))


def frame_factors_fused(state: EKFState, vns, swans, phi_meas, active, q_cov,
                        wheel_base, dt, sigma_heading, use_heading: bool,
                        *, plain: bool = False):
    """The frame factors without materialising P: returns ``(state with the
    post-frame mean and the frame-start P, pose_trace (S, 3), vtf (NBP, D),
    bmat (NBP, NBP))``, the frame covariance being P + vtf^T bmat vtf.

    The plain version for CPU tensors (or with ``plain=True``), kernel H5
    for CUDA tensors up to MAX_STEPS = 256 sub-steps.  Past that bound the
    plain version runs on the card where the reference, too, runs its jnp
    route (D not a multiple of 128), and the frame raises where the
    reference runs its TPU kernel (``_past_the_kernels``).
    """
    tensors = (state.x, state.p, vns, swans, phi_meas, active, q_cov)
    s_steps, d = vns.shape[0], state.x.shape[0]
    route = "kernel" if s_steps <= MAX_STEPS else "unported" if d % 128 == 0 else "plain"
    if plain or cuda.on_cpu(*tensors) or _past_the_kernels(route, "frame_factors_fused", plain,
                                                             *tensors):
        return _frame_factors_reference(state, vns, swans, phi_meas, active, q_cov,
                                        wheel_base, dt, sigma_heading, use_heading)
    _, nbp = factor_shapes(s_steps, use_heading)
    subs, qc = _pack_ctrl(vns, swans, phi_meas, active, q_cov)
    p2 = state.p[2]               # row 2 of the symmetric P: contiguous
    cuda.check(subs, "subs", (4, s_steps))
    cuda.check(qc, "qc", (3,))
    cuda.check(state.x, "x", (d,))
    cuda.check(p2, "p[2]", (d,))
    dev, f32 = state.x.device, torch.float32
    xf = torch.empty((d,), dtype=f32, device=dev)
    pt = torch.empty((s_steps, 3), dtype=f32, device=dev)
    vtf = torch.empty((nbp, d), dtype=f32, device=dev)
    bm = torch.empty((nbp, nbp), dtype=f32, device=dev)
    FACTOR_STRIP(
        dev, *(cuda.ptr(t) for t in (subs, qc, state.x, p2, xf, pt, vtf, bm)),
        s_steps, nbp, d, float(wheel_base), float(dt), float(sigma_heading),
        int(bool(use_heading)),
    )
    return state._replace(x=xf), pt, vtf, bm
