"""EKF-SLAM estimator: one joint Gaussian over pose + landmark map."""

import torch

from conan_slam_tpu_torch.filters.common import CompactObs
from conan_slam_tpu_torch.filters.ekf.associate import (
    AssociationResult,
    associate_gated,
    associate_known,
    factor_and_associate_gated,
)
from conan_slam_tpu_torch.filters.ekf.augment import augment
from conan_slam_tpu_torch.filters.ekf.fastframe import frame_factors, frame_predict_heading
from conan_slam_tpu_torch.filters.ekf.observe import observe_heading
from conan_slam_tpu_torch.filters.ekf.predict import predict
from conan_slam_tpu_torch.filters.ekf.state import (
    EKFState,
    init_state,
    init_state_with_map,
    state_from_numpy,
    state_to_numpy,
)
from conan_slam_tpu_torch.filters.ekf.update import (
    batch_update,
    fused_frame_pair_step,
    fused_frame_step,
    fused_frame_update,
    sequential_update,
    update,
)


def observation_step(state: EKFState, obs: CompactObs, r_cov, *, association_known: bool,
                     batch: bool, gate_reject: float, gate_augment: float,
                     return_nis: bool = False, plain: bool = False):
    """Associate, update, augment: the driver's observation branch
    (reference test/main.cpp:183-197).  With ``return_nis`` also the
    frame's NIS per associated measurement (0 when none associated).

    The reference skips the update when no slot is known and the
    augmentation when none is new (``lax.cond``).  Here nothing waits on
    the device: the update always runs and ``torch.where`` keeps the
    state where no slot was known; the augmentation always runs, and with
    nothing new it rewrites what is there.  On CUDA tensors the gated
    association launches H6's entry (``associate_gated``; ``plain=True``
    runs its plain version); the rest is plain PyTorch, as the
    reference's is plain jnp.
    """
    if association_known:
        assoc = associate_known(state, obs)
    else:
        assoc = associate_gated(state, obs, r_cov, gate_reject, gate_augment, plain=plain)
    upd, nis = update(state, obs, assoc.slots, assoc.known_mask, r_cov, batch, return_nis=True)
    any_known = assoc.known_mask.any()
    # torch.where makes a fresh P, which augment may then write in place.
    state = state._replace(x=torch.where(any_known, upd.x, state.x),
                           p=torch.where(any_known, upd.p, state.p))
    state = augment(state, obs, assoc.new_mask, r_cov)
    if return_nis:
        nis = torch.where(any_known, nis, 0.0)
        return state, nis / torch.clamp(assoc.known_mask.to(nis.dtype).sum(), min=1.0)
    return state


__all__ = [
    "AssociationResult",
    "EKFState",
    "associate_gated",
    "associate_known",
    "augment",
    "batch_update",
    "factor_and_associate_gated",
    "frame_factors",
    "frame_predict_heading",
    "fused_frame_pair_step",
    "fused_frame_step",
    "fused_frame_update",
    "init_state",
    "init_state_with_map",
    "observation_step",
    "observe_heading",
    "predict",
    "sequential_update",
    "state_from_numpy",
    "state_to_numpy",
    "update",
]
