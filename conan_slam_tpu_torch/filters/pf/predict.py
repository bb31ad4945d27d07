"""Per-particle motion prediction and heading pseudo-observation (port of
conan_slam_tpu.filters.pf.predict; reference ``PF::predict``,
PF.cpp:419-471, and ``PF::observeHeading``, PF.cpp:382-417), batched over
the particle axis where the reference maps one particle's update over it.
"""

from __future__ import annotations

import torch

from conan_slam_tpu_torch.core.geometry import wrap_angle
from conan_slam_tpu_torch.core.linalg import quad_small, sym
from conan_slam_tpu_torch.filters.pf.state import ParticleEnsemble
from conan_slam_tpu_torch.models import motion


def predict(ens: ParticleEnsemble, v, swa, q_cov, wheel_base, dt) -> ParticleEnsemble:
    """Pose-covariance propagation and mean motion (reference
    PF.cpp:433-458): only the 3x3 pose block, since the maps are
    conditionally independent given the trajectory."""
    gv, gu = motion.jacobians(ens.pose, v, swa, wheel_base, dt)   # (N,3,3) (N,3,2)
    guq = quad_small(gu, q_cov.expand(gu.shape[:-2] + (2, 2)))
    cov = sym(quad_small(gv, ens.pose_cov) + guq)
    return ens._replace(pose=motion.step(ens.pose, v, swa, wheel_base, dt), pose_cov=cov)


def observe_heading(ens: ParticleEnsemble, phi_meas, sigma_heading) -> ParticleEnsemble:
    """Each particle's Joseph-form update on its heading (reference
    PF.cpp:396-404, sigma 0.01 deg, PF.cpp:391)."""
    r = sigma_heading**2
    pose, cov = ens.pose, ens.pose_cov
    v = wrap_angle(phi_meas - pose[:, 2])          # (N,)
    pc = cov[:, :, 2]                              # (N, 3)
    s = cov[:, 2, 2] + r
    w = pc / s[:, None]
    pose_new = pose + w * v[:, None]
    pose_new = torch.cat([pose_new[:, :2], wrap_angle(pose_new[:, 2:])], dim=1)
    outer_wpc = w[:, :, None] * pc[:, None, :]
    cov_new = sym(cov - outer_wpc - outer_wpc.transpose(-1, -2)
                  + s[:, None, None] * (w[:, :, None] * w[:, None, :]))
    return ens._replace(pose=pose_new, pose_cov=cov_new)
