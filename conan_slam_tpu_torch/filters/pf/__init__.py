"""FastSLAM 2.0, the Rao-Blackwellized particle filter (port of
conan_slam_tpu.filters.pf; reference ``PF``, PF.h:5-321, PF.cpp:1-596):
the particle ensemble as stacked tensors, the proposal fused per particle
and batched over the ensemble, resampling on the device.

The reference draws its randomness from keys; here each observation step
takes its draws as tensors (``ObservationDraws``), which a caller makes
from a ``torch.Generator`` (``runner.loop.draw_pf``) or takes from the
reference's own key schedule, as the parity tests do.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from conan_slam_tpu_torch.core.linalg import bmv_small, chol3
from conan_slam_tpu_torch.filters.common import CompactObs
from conan_slam_tpu_torch.filters.pf.predict import observe_heading, predict
from conan_slam_tpu_torch.filters.pf.proposal import sample_proposal
from conan_slam_tpu_torch.filters.pf.resample import (
    effective_count,
    resample,
    resample_ancestors,
    stratified_indices,
    systematic_indices,
)
from conan_slam_tpu_torch.filters.pf.state import (
    ParticleEnsemble,
    best_pose,
    gather_slots,
    init_ensemble,
    mean_pose,
    normalized_weights,
    scatter_slots,
    weighted_mean_pose,
)
from conan_slam_tpu_torch.filters.pf.update import add_new_features, feature_update


class ObservationDraws(NamedTuple):
    """The draws of one observation step (the reference's ``k_prop``,
    ``k_res`` and ``k_samp``, filters/pf/__init__.py:58)."""

    prop: torch.Tensor   # (N, 3) standard normal: the proposal's pose samples
    res_u: torch.Tensor  # (N,) uniform: the strata of stratified resampling; () systematic
    rough: torch.Tensor | None  # (N, 3) standard normal: the roughening; None without it
    samp: torch.Tensor   # (N, 3) standard normal: the pose sample of a step with nothing known


def associate_known(ens: ParticleEnsemble, obs: CompactObs):
    """Association through the shared id -> slot table (reference
    PF::dataAssociateTable, PF.cpp:137-220).  Returns ``(known (NZ,) bool,
    slots (NZ,) clamped to >= 0, new (NZ,) bool)``."""
    slots = ens.table[torch.clamp(obs.ids, min=0)]
    return obs.mask & (slots >= 0), torch.clamp(slots, min=0), obs.mask & (slots < 0)


def observation_step(
    ens: ParticleEnsemble,
    obs: CompactObs,
    r_cov,
    draws: ObservationDraws,
    *,
    num_effective: float,
    sample_proposal_on: bool,
    resample_on: bool,
    proposal_relinearize: bool = False,
    resample_kind: str = "stratified",
    roughening: float = 0.0,
    resample_fn=None,
) -> ParticleEnsemble:
    """Associate, then (where a measurement is known) the proposal, the
    feature updates and resampling, then (where one is new) the new
    features: the reference driver's PF observation branch
    (test/main.cpp:290-333).  A step with nothing known samples each pose
    from its prior before the new features go in (main.cpp:319-325).

    ``resample_fn(ens, u, rough, num_effective, enabled, kind=,
    roughening=, gate=)`` replaces ``resample`` (the distributed layer's
    hook).

    The reference branches on whether anything is known or new
    (``lax.cond``); here nothing waits on the device.  Each branch runs:
    the feature updates, the resampling gather (gated to the identity)
    and the new features are exact no-ops with nothing to do, and the
    poses, their covariances and the weights that the proposal or the
    prior sample would move are selected back with ``torch.where``.  With
    ``obs.mask`` all false the whole step returns ``ens`` bit for bit."""
    known, slots, new = associate_known(ens, obs)
    have_known, have_new = known.any(), new.any()

    e = ens
    if sample_proposal_on:
        e = sample_proposal(e, obs, slots, known, r_cov, draws.prop,
                            relinearize=proposal_relinearize)
    e = feature_update(e, obs, slots, known, r_cov)
    e = (resample_fn or resample)(e, draws.res_u, draws.rough, num_effective, resample_on,
                                  kind=resample_kind, roughening=roughening, gate=have_known)
    pose = torch.where(have_known, e.pose, ens.pose)
    pose_cov = torch.where(have_known, e.pose_cov, ens.pose_cov)
    e = e._replace(log_w=torch.where(have_known, e.log_w, ens.log_w))

    # Nothing known: each pose sampled from its prior, exact thereafter.
    prior = pose + bmv_small(chol3(pose_cov, 1e-8), draws.samp)
    first = have_new & ~have_known
    e = add_new_features(e._replace(pose=torch.where(first, prior, pose),
                                    pose_cov=torch.where(first, 0.0, pose_cov)),
                         obs, new, r_cov)
    return e


__all__ = [
    "ObservationDraws",
    "ParticleEnsemble",
    "add_new_features",
    "associate_known",
    "best_pose",
    "effective_count",
    "feature_update",
    "gather_slots",
    "init_ensemble",
    "mean_pose",
    "normalized_weights",
    "observation_step",
    "observe_heading",
    "predict",
    "resample",
    "resample_ancestors",
    "sample_proposal",
    "scatter_slots",
    "stratified_indices",
    "systematic_indices",
    "weighted_mean_pose",
]
