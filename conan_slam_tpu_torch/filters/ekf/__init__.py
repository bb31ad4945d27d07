"""EKF-SLAM estimator: one joint Gaussian over pose + landmark map."""

from conan_slam_tpu_torch.filters.ekf.associate import (
    AssociationResult,
    associate_gated,
    associate_known,
    factor_and_associate_gated,
)
from conan_slam_tpu_torch.filters.ekf.augment import augment
from conan_slam_tpu_torch.filters.ekf.state import (
    EKFState,
    init_state,
    init_state_with_map,
    state_from_numpy,
    state_to_numpy,
)
from conan_slam_tpu_torch.filters.ekf.update import (
    fused_frame_pair_step,
    fused_frame_step,
    fused_frame_update,
)

__all__ = [
    "AssociationResult",
    "EKFState",
    "associate_gated",
    "associate_known",
    "augment",
    "factor_and_associate_gated",
    "fused_frame_pair_step",
    "fused_frame_step",
    "fused_frame_update",
    "init_state",
    "init_state_with_map",
    "state_from_numpy",
    "state_to_numpy",
]
