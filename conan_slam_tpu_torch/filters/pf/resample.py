"""Resampling on the device (port of conan_slam_tpu.filters.pf.resample;
reference ``PF::resampleParticles`` / ``stratifiedResample``,
PF.cpp:473-500, 546-596, with its two RNG defects fixed, SURVEY.md defects
8 and 13): normalised cumulative weights, ``searchsorted`` against
stratified (or systematic) uniforms and one gather of every per-particle
tensor, gated by the effective-sample-size test.

The uniforms, and the roughening's standard normals, come in as tensors.
"""

from __future__ import annotations

import torch

from conan_slam_tpu_torch.core.geometry import wrap_angle
from conan_slam_tpu_torch.filters.pf.state import (
    ParticleEnsemble,
    normalized_weights,
    uniform_log_weight,
)


def effective_count(weights: torch.Tensor) -> torch.Tensor:
    """Neff = 1 / sum(w^2) of normalised weights (reference PF.cpp:550-554)."""
    return 1.0 / torch.clamp((weights * weights).sum(), min=1e-30)


def _invert_cdf(u: torch.Tensor, weights: torch.Tensor, n: int) -> torch.Tensor:
    """Ancestor indices: the first i with cumsum(w)[i] >= u (searchsorted's
    left side, as the reference's), clipped to [0, n)."""
    return torch.clamp(torch.searchsorted(torch.cumsum(weights, 0), u), 0, n - 1)


def stratified_indices(u: torch.Tensor, weights: torch.Tensor, n: int) -> torch.Tensor:
    """Stratified resampling: one uniform ``u`` (n,) per stratum, (i + u_i) / n,
    through the inverse CDF."""
    return _invert_cdf((torch.arange(n, dtype=weights.dtype, device=weights.device) + u) / n,
                       weights, n)


def systematic_indices(u: torch.Tensor, weights: torch.Tensor, n: int) -> torch.Tensor:
    """Systematic (low-variance) resampling: one uniform ``u`` () shared by
    every stratum, (i + u) / n (no reference C++ counterpart)."""
    return stratified_indices(u, weights, n)


def resample(ens: ParticleEnsemble, u: torch.Tensor, rough: torch.Tensor | None,
             num_effective: float, enabled: bool, kind: str = "stratified",
             roughening: float = 0.0, gate: torch.Tensor | None = None) -> ParticleEnsemble:
    """Resample where Neff falls below ``num_effective`` (reference
    PF.cpp:489-499) and ``gate`` (a () bool, default true) holds.

    ``u``: the uniforms, (N,) for ``kind="stratified"``, () for
    "systematic"; ``rough``: (N, 3) standard normals, read where
    ``roughening`` > 0, which adds post-resample pose jitter with std
    roughening * ensemble spread * N^(-1/3) per component (Gordon-style,
    heading wrapped).

    Nothing waits on the device: where the test fails the gather runs on
    the identity, which copies every tensor exactly, and the weights and
    poses are selected back."""
    if not enabled:
        return ens
    n = ens.num_particles
    w = normalized_weights(ens)
    fire = effective_count(w) < num_effective
    if gate is not None:
        fire = fire & gate
    pick = systematic_indices if kind == "systematic" else stratified_indices
    return resample_ancestors(ens, pick(u, w, n), fire, rough, roughening)


def resample_ancestors(ens: ParticleEnsemble, ancestors: torch.Tensor, fire: torch.Tensor,
                       rough: torch.Tensor | None, roughening: float = 0.0) -> ParticleEnsemble:
    """``resample``'s gather on given ``ancestors`` (N,) where ``fire`` (a ()
    bool) holds, and the identity where it does not."""
    n = ens.num_particles
    idx = torch.where(fire, ancestors, torch.arange(n, device=ancestors.device))
    pose = ens.pose.index_select(0, idx)
    if roughening > 0.0:
        spread = ens.pose.amax(0) - ens.pose.amin(0)
        jittered = pose + roughening * spread * float(n) ** (-1.0 / 3.0) * rough
        pose = torch.where(fire, torch.cat([jittered[:, :2], wrap_angle(jittered[:, 2:])], 1),
                           pose)
    return ParticleEnsemble(
        log_w=torch.where(fire, uniform_log_weight(n), ens.log_w),
        pose=pose,
        pose_cov=ens.pose_cov.index_select(0, idx),
        xf=ens.xf.index_select(0, idx),
        pf=ens.pf.index_select(0, idx),
        n_active=ens.n_active,
        table=ens.table,
    )
