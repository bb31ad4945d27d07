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
from conan_slam_tpu_torch.ops.gating_kernel import (
    _gating_scores_reference,
    gating_scores,
)


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


def _innovation_blocks(state: EKFState, vmat=None, bmat=None):
    """The blocks of P the per-slot innovation covariance reads: the pose
    block pvv (3, 3), the pose-feature strips pvm (K, 3, 2) and the
    diagonal feature blocks pjj (K, 2, 2), with the virtual correction
    P + V B V^T folded in when ``vmat`` (D, r) / ``bmat`` (r, r) are given
    (only those blocks of V B V^T are formed: O(K r) work, not O(D^2)).

    pjj indexes exactly the 4K entries of the diagonal blocks (the
    reference gathers a band of P for the same reason: a reshape of the
    (2K, 2K) map block is quadratic in K)."""
    k = state.capacity
    p = state.p
    pvv = p[:3, :3]
    pvm = p[:3, 3 : 3 + 2 * k].reshape(3, k, 2).permute(1, 0, 2)
    two = torch.arange(2, device=p.device)[:, None]
    rows = 3 + 2 * torch.arange(k, device=p.device)[:, None, None] + two   # (K, 2, 1)
    pjj = p[rows, rows.transpose(1, 2)]          # pjj[j, a, b] = P[3 + 2j + a, 3 + 2j + b]
    if vmat is not None:
        v3 = vmat[:3]                                           # (3, r)
        vm = vmat[3 : 3 + 2 * k].reshape(k, 2, -1)              # (K, 2, r)
        v3b = v3 @ bmat
        pvv = pvv + v3b @ v3.T
        pvm = pvm + torch.einsum("ir,kjr->kij", v3b, vm)
        vmb = torch.einsum("kir,rs->kis", vm, bmat)
        pjj = pjj + torch.einsum("kir,kjr->kij", vmb, vm)
    return pvv, pvm, pjj


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

    On CUDA tensors the scoring and the masked argmin run as kernel H6
    (ops.gating_kernel; ``plain=True`` runs its plain version instead); on
    the CPU this takes the dense route below, as the reference does off the
    TPU.
    """
    if not cuda.on_cpu(state.x, obs.z):
        pvv, pvm, pjj = _innovation_blocks(state, vmat, bmat)
        score = _gating_scores_reference if plain else gating_scores
        best_nd, best_j, min_nis = score(
            obs.z.contiguous(), state.pose, state.features, state.active_mask,
            pvv.contiguous(), pvm.contiguous(), pjj.contiguous(), r_cov, gate_reject,
        )
        found = best_nd < 1.0e38
        new = obs.mask & ~found & (min_nis > gate_augment)
        slots = torch.where(found, best_j.to(torch.int64), 0)
        return AssociationResult(known_mask=obs.mask & found, slots=slots, new_mask=new)

    nis_act, nd = gated_scores_dense(state, obs.z, r_cov, vmat, bmat)
    gated = nis_act < gate_reject
    jbest = torch.argmin(torch.where(gated, nd, torch.inf), dim=1)  # first minimum on a tie
    found = gated.any(dim=1)
    new = obs.mask & ~found & (nis_act.min(dim=1).values > gate_augment)
    return AssociationResult(known_mask=obs.mask & found, slots=jbest, new_mask=new)


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
