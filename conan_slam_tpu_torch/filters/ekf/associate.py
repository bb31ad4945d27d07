"""Data association: known-table and Mahalanobis-gated nearest neighbour
(port of conan_slam_tpu.filters.ekf.associate; reference
EKF::dataAssociateTable, EKF.cpp:169-182, and EKF::dataAssociate /
computeAssociation, EKF.cpp:235-326, 131-144)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from conan_slam_tpu_torch.core.geometry import wrap_angle
from conan_slam_tpu_torch.core.linalg import det2, inv2
from conan_slam_tpu_torch.filters.common import CompactObs
from conan_slam_tpu_torch.filters.ekf.state import EKFState
from conan_slam_tpu_torch.models import sensor
from conan_slam_tpu_torch.ops import cuda
from conan_slam_tpu_torch.ops.factor_kernel import MAX_STEPS, factor_gate, frame_factors_fused
from conan_slam_tpu_torch.ops.gating_kernel import _innovation_blocks, gate_state


class AssociationResult(NamedTuple):
    known_mask: torch.Tensor  # (NZ,) bool: measurement matched to an active slot
    slots: torch.Tensor       # (NZ,) int64 matched slot (valid where known_mask)
    new_mask: torch.Tensor    # (NZ,) bool: measurement should found a new feature


def associate_known(state: EKFState, obs: CompactObs) -> AssociationResult:
    """Ground-truth association via the id -> slot table."""
    slots = state.table[torch.clamp(obs.ids, min=0)]
    known = obs.mask & (slots >= 0)
    new = obs.mask & (slots < 0)
    return AssociationResult(
        known_mask=known, slots=torch.clamp(slots, min=0), new_mask=new
    )


def _innovation_stats(state: EKFState, r_cov, vmat=None, bmat=None):
    """Per-slot predicted measurement zp (K, 2) and innovation covariance
    S_j (K, 2, 2) = [Hv Hf] [[Pvv, Pvj], [Pjv, Pjj]] [Hv Hf]^T + R, from
    the blocks of ``_innovation_blocks`` (no dense (2, D) rows)."""
    zp, hv, hf = sensor.observe(state.pose, state.features)  # (K,2) (K,2,3) (K,2,2)
    pvv, pvm, pjj = _innovation_blocks(state, vmat, bmat)
    cross = hv @ pvm @ hf.transpose(-1, -2)                  # Hv Pvj Hf^T
    s = hv @ pvv @ hv.transpose(-1, -2) + cross + cross.transpose(-1, -2)
    return zp, s + hf @ pjj @ hf.transpose(-1, -2) + r_cov


def associate_gated(state: EKFState, obs: CompactObs, r_cov, gate_reject: float,
                    gate_augment: float, vmat=None, bmat=None, *,
                    plain: bool = False) -> AssociationResult:
    """Gated nearest-neighbour association (reference EKF.cpp:263-296).

    For each measurement i and active slot j, nis_ij = v^T S_j^-1 v and
    nd_ij = nis_ij + log|S_j|; a measurement takes the nd-argmin among the
    slots with nis < ``gate_reject`` (EKF.cpp:275-279), and one whose best
    nis over active slots exceeds ``gate_augment`` founds a new feature
    (EKF.cpp:292-295).  ``vmat``/``bmat`` gate against the virtual
    covariance P + V B V^T of the pending frame factors.

    On CUDA tensors the scoring and the masked argmin run as H6's entry of
    kernel H15 (ops.gating_kernel; ``plain=True`` runs its plain version
    instead); on the CPU this takes the dense route below, as the reference
    does off the TPU.  The frame loop runs the factors and this association
    as one launch (``factor_and_associate_gated``).
    """
    if not cuda.on_cpu(state.x, obs.z):
        known, slots, new = gate_state(state, obs.z, obs.mask, r_cov, gate_reject, gate_augment,
                                       vmat, bmat, plain=plain)[3:]
        return AssociationResult(known_mask=known, slots=slots, new_mask=new)

    nis_act, nd = gated_scores_dense(state, obs.z, r_cov, vmat, bmat)
    gated = nis_act < gate_reject
    jbest = torch.argmin(torch.where(gated, nd, torch.inf), dim=1)  # first minimum on a tie
    found = gated.any(dim=1)
    new = obs.mask & ~found & (nis_act.min(dim=1).values > gate_augment)
    return AssociationResult(known_mask=obs.mask & found, slots=jbest, new_mask=new)


def factors_then_associate(state: EKFState, vns, swans, phi_meas, active, q_cov, wheel_base,
                           dt, sigma_heading, use_heading: bool, obs: CompactObs, r_cov,
                           gate_reject: float, gate_augment: float, *, plain: bool = False):
    """The gated frame's pre-update as two steps: ``frame_factors_fused``,
    then ``associate_gated`` against its virtual covariance.  Returns what
    ``factor_and_associate_gated`` returns."""
    st1, pose_trace, vtf, bmat = frame_factors_fused(
        state, vns, swans, phi_meas, active, q_cov, wheel_base, dt, sigma_heading,
        use_heading, plain=plain)
    return st1, pose_trace, vtf, bmat, associate_gated(
        st1, obs, r_cov, gate_reject, gate_augment, vtf.T, bmat, plain=plain)


def factor_and_associate_gated(state: EKFState, vns, swans, phi_meas, active, q_cov,
                               wheel_base, dt, sigma_heading, use_heading: bool,
                               obs: CompactObs, r_cov, gate_reject: float, gate_augment: float,
                               *, plain: bool = False):
    """The gated frame's pre-update: its factors (``frame_factors_fused``)
    and its association against the virtual covariance P + vtf^T B vtf
    (``associate_gated``).  Returns ``(state with the post-frame mean and
    the frame-start P, pose_trace (S, 3), vtf (NBP, D), bmat (NBP, NBP),
    AssociationResult)``.

    On CUDA tensors one launch of kernel H15 (ops.factor_kernel.factor_gate)
    from the frame-start state to the association result.  On the CPU,
    with ``plain=True`` and past H15's 256 sub-steps, the two steps run as
    they are (``factors_then_associate``): H5's plain version (or its route
    past the kernels), then associate_gated's route (the dense scores on
    the CPU, H6 or its plain version on the card).
    """
    args = (state, vns, swans, phi_meas, active, q_cov, wheel_base, dt, sigma_heading,
            use_heading)
    if plain or cuda.on_cpu(state.x, obs.z) or vns.shape[0] > MAX_STEPS:
        return factors_then_associate(*args, obs, r_cov, gate_reject, gate_augment, plain=plain)
    fg = factor_gate(*args, obs.z, obs.mask, r_cov, gate_reject, gate_augment)
    return (state._replace(x=fg.x), fg.pose_trace, fg.vtf, fg.bmat,
            AssociationResult(known_mask=fg.known_mask, slots=fg.slots, new_mask=fg.new_mask))


def gated_scores_dense(state: EKFState, z, r_cov, vmat=None, bmat=None):
    """The dense (NZ, K) scores of ``associate_gated``'s CPU route:
    ``(nis, nd)`` with nis = inf on inactive slots."""
    zp, s = _innovation_stats(state, r_cov, vmat, bmat)       # (K, 2), (K, 2, 2)
    sinv = inv2(s)
    logdet = torch.log(torch.clamp(det2(s), min=1e-30))
    v = z[:, None, :] - zp[None, :, :]                        # (NZ, K, 2)
    v = torch.stack([v[..., 0], wrap_angle(v[..., 1])], -1)
    siv = (sinv[None] * v[..., None, :]).sum(-1)              # (NZ, K, 2)
    nis = (v * siv).sum(-1)
    nis_act = torch.where(state.active_mask[None, :], nis, torch.inf)
    return nis_act, nis + logdet[None, :]
