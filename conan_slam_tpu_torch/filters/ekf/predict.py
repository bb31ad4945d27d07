"""EKF time update (port of conan_slam_tpu.filters.ekf.predict; reference
EKF::predict, EKF.cpp:406-455).

Only the pose block and the pose-map strip change:
Pvv <- Gv Pvv Gv^T + Gu Q Gu^T and Pvm <- Gv Pvm (the full map width; the
reference propagates one column short, a defect fixed here too).
"""

from __future__ import annotations

import torch

from conan_slam_tpu_torch.core.linalg import sym
from conan_slam_tpu_torch.filters.ekf.state import EKFState
from conan_slam_tpu_torch.models import motion


def predict(state: EKFState, v, swa, q_cov, wheel_base, dt) -> EKFState:
    """One predict step with odometry ``(v, swa)``."""
    gv, gu = motion.jacobians(state.pose, v, swa, wheel_base, dt)
    p = state.p.clone()
    pvv_new = sym(gv @ p[:3, :3] @ gv.T + gu @ q_cov @ gu.T)
    pvm_new = gv @ p[:3, 3:]
    p[:3, :3] = pvv_new
    p[:3, 3:] = pvm_new
    p[3:, :3] = pvm_new.T
    x = torch.cat([motion.step(state.pose, v, swa, wheel_base, dt), state.x[3:]])
    return state._replace(x=x, p=p)
