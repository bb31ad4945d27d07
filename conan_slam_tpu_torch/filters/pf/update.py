"""Per-particle map maintenance (port of conan_slam_tpu.filters.pf.update):
each observed feature's 2x2 EKF update under the particle's pose
(reference ``PF::featureUpdate``, PF.cpp:222-277) and new features
(``PF::addOneNewFeature``, PF.cpp:9-60), batched over particles and
measurements.
"""

from __future__ import annotations

import torch

from conan_slam_tpu_torch.core.geometry import wrap_angle
from conan_slam_tpu_torch.core.linalg import bmm_small, bmv_small, inv2, quad_small, sym
from conan_slam_tpu_torch.filters.common import CompactObs
from conan_slam_tpu_torch.filters.pf.state import ParticleEnsemble, gather_slots, scatter_slots
from conan_slam_tpu_torch.models import sensor


def feature_update(ens: ParticleEnsemble, obs: CompactObs, slots, mask,
                   r_cov) -> ParticleEnsemble:
    """2x2 Kalman update of each masked-true measurement's feature in every
    particle (reference PF.cpp:250-260; closed-form gain K = P Hᵀ S⁻¹).
    With no measurement masked true the maps come back unchanged, bit for
    bit."""
    safe = torch.clamp(slots, 0, ens.capacity - 1)
    xf_s, pf_s = gather_slots(ens.xf, ens.pf, safe)     # (N,NZ,2) (N,NZ,2,2)
    zp, _, hf = sensor.observe(ens.pose, xf_s)
    v = obs.z - zp
    v = torch.stack([v[..., 0], wrap_angle(v[..., 1])], dim=-1)
    s = sym(quad_small(hf, pf_s, r_cov))
    k = bmm_small(bmm_small(pf_s, hf.transpose(-1, -2)), inv2(s))   # P Hᵀ S⁻¹
    xf_new = xf_s + bmv_small(k, v)
    pf_new = sym(pf_s - bmm_small(bmm_small(k, hf), pf_s))
    xf, pf = scatter_slots(ens.xf, ens.pf, safe, mask, xf_new, pf_new)
    return ens._replace(xf=xf, pf=pf)


def add_new_features(ens: ParticleEnsemble, obs: CompactObs, new_mask,
                     r_cov) -> ParticleEnsemble:
    """Initialise the new features in every particle's map and give each a
    shared slot from the active count, as the EKF does (the reference C++
    fills its table from the wrong index vector, PF.cpp:204-213, SURVEY.md
    defect 6).  A feature past the capacity is dropped.  With nothing new
    the ensemble comes back unchanged, bit for bit."""
    k_cap = ens.capacity
    slots = ens.n_active + torch.cumsum(new_mask.to(torch.int64), 0) - 1
    ok = new_mask & (slots < k_cap)
    z = obs.z.expand(ens.num_particles, -1, -1)
    xf_new, _, gz = sensor.init_feature(ens.pose, z)               # (N,NZ,2) (N,NZ,2,2)
    pf_new = quad_small(gz, r_cov.expand(gz.shape[:-2] + (2, 2)))
    xf, pf = scatter_slots(ens.xf, ens.pf, torch.where(ok, slots, 0), ok, xf_new, pf_new)
    num_ids = ens.table.shape[0]
    table = torch.cat([ens.table, ens.table.new_full((1,), -1)]).scatter(
        0, torch.where(ok, obs.ids, num_ids), slots)[:num_ids]
    return ens._replace(xf=xf, pf=pf, n_active=ens.n_active + ok.sum(), table=table)
