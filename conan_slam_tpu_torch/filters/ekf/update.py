"""Known-association whole-frame update (port of
conan_slam_tpu.filters.ekf.update.fused_frame_step)."""

from __future__ import annotations

import torch

from conan_slam_tpu_torch.filters.common import CompactObs
from conan_slam_tpu_torch.filters.ekf.state import EKFState
from conan_slam_tpu_torch.ops.frame_kernel import frame_step


def fused_frame_step(state: EKFState, vns, swans, phis, actives, q_cov,
                     obs: CompactObs, slots, mask, r_cov, wheel_base, dt,
                     sigma_heading, use_heading: bool, *, plain: bool = False):
    """S predict + heading sub-steps, observe and measurement update of one
    frame (ops.frame_kernel.frame_step); the association table lookup is
    the only work left between frames.

    Returns ``(new_state, pose_trace (S, 3), nis per associated measurement)``.
    """
    safe = torch.clamp(slots, 0, state.capacity - 1)
    two = torch.arange(2, device=safe.device)
    rows2 = (3 + 2 * safe[:, None] + two[None, :]).reshape(-1)
    rows = torch.cat([torch.arange(3, device=safe.device), rows2])
    fs = frame_step(
        state.p, state.x, rows, vns, swans, phis, actives, q_cov,
        obs.z[:, 0], obs.z[:, 1], mask, r_cov, wheel_base, dt,
        sigma_heading, use_heading, plain=plain,
    )
    n_meas = torch.clamp(mask.to(fs.x.dtype).sum(), min=1.0)
    return state._replace(x=fs.x, p=fs.p), fs.pose_trace, fs.nis / n_meas
