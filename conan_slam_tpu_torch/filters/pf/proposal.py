"""FastSLAM 2.0's optimal-proposal sampling and importance weighting (port
of conan_slam_tpu.filters.pf.proposal; reference ``PF::sampleProposal``,
PF.cpp:502-544): per particle, a Gaussian fusion of the associated
measurements,

    P <- (Hvᵀ S⁻¹ Hv + P⁻¹)⁻¹,    X <- X + P Hvᵀ S⁻¹ v,

then a pose sample XS ~ N(X, P) and the weight update
w *= likelihood(XS) prior(X0 -> XS) / proposal(X -> XS) (reference
PF.cpp:534-543, ``likelihood`` PF.cpp:343-359), in log space.

The default fuses every measurement at once in information form, all
Jacobians at the predicted pose (``_particle_proposal_batched``);
``relinearize=True`` is the reference's order-dependent iteration, each
measurement relinearised at the pose fused so far (``_particle_proposal``).
Both are batched over the particle axis; the standard-normal draws of the
pose samples come in as an (N, 3) tensor.
"""

from __future__ import annotations

import torch

from conan_slam_tpu_torch.core.geometry import wrap_angle
from conan_slam_tpu_torch.core.linalg import (
    bmm_small,
    bmv_small,
    chol3,
    inv2,
    inv3,
    mvn_logpdf2,
    mvn_logpdf3,
    quad_small,
    sym,
)
from conan_slam_tpu_torch.filters.common import CompactObs
from conan_slam_tpu_torch.filters.pf.state import ParticleEnsemble, gather_slots
from conan_slam_tpu_torch.models import sensor

_COV_JITTER = 1e-8


def _wrap_last(d: torch.Tensor, k: int) -> torch.Tensor:
    """``d`` (..., n) with component ``k`` (the last or the one before it)
    wrapped to [-pi, pi)."""
    return torch.cat([d[..., :k], wrap_angle(d[..., k:k + 1]), d[..., k + 1:]], dim=-1)


def _delta(x1, x2):
    """Pose innovation with a wrapped heading (reference PF.cpp:62-68)."""
    return _wrap_last(x1 - x2, 2)


def _sample_and_weigh(pose, cov, x_fused, p_fused, xf_s, pf_s, z, mask, r_cov, eps,
                      dense: bool = False):
    """The pose sample from N(x_fused, p_fused) and its log-weight change:
    the measurements' likelihood at the sample (Jacobians relinearised
    there) times the motion prior, over the proposal density.  ``dense``:
    the sample's and the likelihood's small products as matrix products,
    as the reference's iterated route forms them, else broadcast sums."""
    chol = chol3(p_fused, _COV_JITTER)
    step = (chol @ eps[..., None])[..., 0] if dense else bmv_small(chol, eps)
    xs = _wrap_last(x_fused + step, 2)
    zp_s, _, hf_s = sensor.observe(xs, xf_s)
    if dense:
        sf_s = sym(hf_s @ pf_s @ hf_s.transpose(-1, -2) + r_cov)
    else:
        sf_s = sym(quad_small(hf_s, pf_s, r_cov))
    v_s = _wrap_last(z - zp_s, 1)
    ll = torch.where(mask, mvn_logpdf2(v_s, sf_s, _COV_JITTER), 0.0).sum(-1)
    log_prior = mvn_logpdf3(_delta(pose, xs), cov, _COV_JITTER)
    log_prop = mvn_logpdf3(_delta(x_fused, xs), p_fused, _COV_JITTER)
    return xs, ll + log_prior - log_prop


def _particle_proposal_batched(pose, cov, xf_s, pf_s, z, mask, r_cov, eps):
    """One-shot information-form fusion, every Jacobian at the predicted
    pose: Lambda = P⁻¹ + sum_i Hv_iᵀ S_i⁻¹ Hv_i, X += Lambda⁻¹ sum Hvᵀ S⁻¹ v.
    A different proposal from the reference C++'s iterated fusion, and
    still exact SMC: the weight divides by the density actually sampled
    from.  ``pose`` (N, 3), ``cov`` (N, 3, 3), ``xf_s``/``pf_s`` the
    measurements' map blocks (N, NZ, 2), (N, NZ, 2, 2), ``eps`` (N, 3)."""
    zp, hv, hf = sensor.observe(pose, xf_s)                     # (N, NZ, ...)
    sfi = inv2(sym(quad_small(hf, pf_s, r_cov)))
    v = _wrap_last(z - zp, 1)
    hvt_sfi = bmm_small(hv.transpose(-1, -2), sfi)              # (N, NZ, 3, 2)
    m = mask.to(pose.dtype)
    lam = inv3(cov) + (m[:, None, None] * bmm_small(hvt_sfi, hv)).sum(-3)
    p_fused = sym(inv3(lam))
    info_vec = (m[:, None] * bmv_small(hvt_sfi, v)).sum(-2)
    x_fused = pose + bmv_small(p_fused, info_vec)
    return _sample_and_weigh(pose, cov, x_fused, p_fused, xf_s, pf_s, z, mask, r_cov, eps)


def _particle_proposal(pose, cov, xf_s, pf_s, z, mask, r_cov, eps):
    """The reference's iterated fusion (PF.cpp:513-531): the measurements
    in buffer order, each relinearised at the pose fused so far (a loop
    over the NZ slots, batched over particles, each measurement an M = 1
    slice of the map blocks; a masked-false slot leaves the fusion as it
    was)."""
    x, p = pose, cov
    for i in range(z.shape[0]):
        zp, hv, hf = (a[:, 0] for a in sensor.observe(x, xf_s[:, i:i + 1]))
        sfi = inv2(sym(hf @ pf_s[:, i] @ hf.transpose(-1, -2) + r_cov))
        v = torch.stack([z[i, 0] - zp[:, 0], wrap_angle(z[i, 1] - zp[:, 1])], dim=-1)
        hvt = hv.transpose(-1, -2)
        p_new = sym(inv3(hvt @ sfi @ hv + inv3(p)))
        x_new = x + (p_new @ (hvt @ (sfi @ v[..., None])))[..., 0]
        x = torch.where(mask[i], x_new, x)
        p = torch.where(mask[i], p_new, p)
    return _sample_and_weigh(pose, cov, x, p, xf_s, pf_s, z, mask, r_cov, eps, dense=True)


def sample_proposal(ens: ParticleEnsemble, obs: CompactObs, slots, mask, r_cov, eps,
                    relinearize: bool = False) -> ParticleEnsemble:
    """Each particle's pose drawn from its proposal with standard-normal
    ``eps`` (N, 3), its log weight updated, and its pose covariance zeroed
    (the sampled pose is taken as exact, reference PF.cpp:536-537).

    With no measurement masked true the poses still move by
    chol3(P)·eps and the weights change: the caller keeps the old ones
    then (``observation_step``)."""
    safe = torch.clamp(slots, 0, ens.capacity - 1)
    xf_s, pf_s = gather_slots(ens.xf, ens.pf, safe)
    fuse = _particle_proposal if relinearize else _particle_proposal_batched
    xs, dlw = fuse(ens.pose, ens.pose_cov, xf_s, pf_s, obs.z, mask, r_cov, eps)
    return ens._replace(pose=xs, pose_cov=torch.zeros_like(ens.pose_cov), log_w=ens.log_w + dlw)
