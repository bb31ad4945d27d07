"""The Rao-Blackwellized particle ensemble (port of
conan_slam_tpu.filters.pf.state; reference ``Particle_t``, slam.h:120-127).

One structure of stacked tensors ``(N, ...)``: every per-particle operation
is batched 2x2 / 3x3 algebra over the particle axis, and resampling is a
gather.  With known association every particle shares the slot layout (the
id -> slot table depends on the observation sequence, not on a particle),
so the table and the active count live once in the ensemble; the feature
means and covariances are per particle.  Weights are kept in log space.

The reference reads and writes the measurements' map slots through one-hot
selector contractions (``slot_selector`` / ``gather_slots`` /
``scatter_slots``), a workaround for gather latency on its TPU; here they
are ``index_select`` and a masked write with the same set semantics
(``gather_slots`` / ``scatter_slots``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from conan_slam_tpu_torch.core.geometry import wrap_angle
from conan_slam_tpu_torch.device import default_device


class ParticleEnsemble(NamedTuple):
    log_w: torch.Tensor     # (N,) log importance weights (unnormalised)
    pose: torch.Tensor      # (N, 3) per-particle vehicle pose
    pose_cov: torch.Tensor  # (N, 3, 3) per-particle pose covariance (proposal prior)
    xf: torch.Tensor        # (N, K, 2) per-particle feature means
    pf: torch.Tensor        # (N, K, 2, 2) per-particle feature covariances
    n_active: torch.Tensor  # () int64 shared active-slot count
    table: torch.Tensor     # (num_ids,) int64 shared id -> slot, -1 unknown

    @property
    def num_particles(self) -> int:
        return self.pose.shape[0]

    @property
    def capacity(self) -> int:
        return self.xf.shape[1]


def uniform_log_weight(n: int) -> float:
    """-log(n) rounded as the reference forms it (a float32 log)."""
    return -float(torch.log(torch.tensor(float(n), dtype=torch.float32)))


def init_ensemble(num_particles: int, capacity: int, num_landmark_ids: int,
                  dtype=torch.float32, device=None) -> ParticleEnsemble:
    """w = 1/N, zero pose and covariance, empty maps (reference
    PF.cpp:319-341), on ``device`` (default: the card)."""
    device = default_device() if device is None else device
    n, k = num_particles, capacity
    return ParticleEnsemble(
        log_w=torch.full((n,), uniform_log_weight(n), dtype=dtype, device=device),
        pose=torch.zeros((n, 3), dtype=dtype, device=device),
        pose_cov=torch.zeros((n, 3, 3), dtype=dtype, device=device),
        xf=torch.zeros((n, k, 2), dtype=dtype, device=device),
        pf=torch.zeros((n, k, 2, 2), dtype=dtype, device=device),
        n_active=torch.zeros((), dtype=torch.int64, device=device),
        table=torch.full((num_landmark_ids,), -1, dtype=torch.int64, device=device),
    )


def normalized_weights(ens: ParticleEnsemble) -> torch.Tensor:
    """(N,) weights normalised to sum 1 (shifted by the largest log weight)."""
    w = torch.exp(ens.log_w - ens.log_w.max())
    return w / w.sum()


def best_pose(ens: ParticleEnsemble) -> torch.Tensor:
    """Pose of the max-weight particle (the reference C++ picks the
    min-weight one, slam.h:505-508, SURVEY.md defect 3)."""
    return ens.pose[torch.argmax(ens.log_w)]


def weighted_mean_pose(w: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """Mean of ``pose`` (..., N, 3) under weights ``w`` (N,), the heading a
    circular mean: (..., 3)."""
    xy = (w[:, None] * pose[..., :2]).sum(-2)
    phi = torch.atan2((w * torch.sin(pose[..., 2])).sum(-1), (w * torch.cos(pose[..., 2])).sum(-1))
    return torch.cat([xy, wrap_angle(phi)[..., None]], dim=-1)


def mean_pose(ens: ParticleEnsemble) -> torch.Tensor:
    """Weight-averaged pose with a circular mean for the heading."""
    return weighted_mean_pose(normalized_weights(ens), ens.pose)


def gather_slots(xf: torch.Tensor, pf: torch.Tensor, slots: torch.Tensor):
    """``(N, K, 2), (N, K, 2, 2)`` -> the measurements' slots ``(N, NZ, 2),
    (N, NZ, 2, 2)``; ``slots`` (NZ,) lie in [0, K)."""
    return xf.index_select(1, slots), pf.index_select(1, slots)


def scatter_slots(xf, pf, slots, mask, xf_new, pf_new):
    """Write back per-measurement updates with set semantics: slot k keeps
    its old value unless a masked-true measurement updated it, and then
    takes that measurement's value exactly.

    Precondition (the reference's): the masked-true slots are unique, as
    id-based association makes them.  Each slot's source measurement is
    found on a (K + 1,) index (masked-false measurements write to the
    spare last entry), so a masked-false measurement that shares a slot
    with a masked-true one cannot overwrite it."""
    k, nz = xf.shape[1], slots.shape[0]
    src = torch.full((k + 1,), -1, dtype=torch.int64, device=slots.device)
    src = src.scatter(0, torch.where(mask, slots, k),
                      torch.arange(nz, dtype=torch.int64, device=slots.device))[:k]
    touched = src >= 0
    src = torch.clamp(src, min=0)
    xf_out = torch.where(touched[:, None], xf_new.index_select(1, src), xf)
    pf_out = torch.where(touched[:, None, None], pf_new.index_select(1, src), pf)
    return xf_out, pf_out
