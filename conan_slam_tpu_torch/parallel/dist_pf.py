"""Distributed particle filter: the ensemble sharded over the ``particles``
axis (port of conan_slam_tpu.parallel.dist_pf).

The particle axis shards like a batch axis: predict, proposal and feature
updates are embarrassingly parallel, and each rank runs the single-device
functions (filters.pf) on its own block of particles.  The reference runs
its single-device ``observation_step`` under sharding constraints and lets
XLA insert the cross-particle reductions; here every reduction over the
particle axis is an explicit collective: the weights (normalisation, Neff,
CDF) from one all-gather of the log weights, the roughening's spread
(pmax, pmin), and the resampling gather, one all-gather of the
particles' payload.
The sharded step equals the single-device one on the same draws.

Draws are global tensors (the single-device step's), each rank taking its
slice: each particle's proposal and prior samples, the stratified
uniforms and the roughening's normals (the resampling slices its own);
the systematic uniform is one number every rank reads.
"""

from __future__ import annotations

import functools

import torch

from conan_slam_tpu_torch.core.geometry import wrap_angle
from conan_slam_tpu_torch.filters import pf as pf_mod
from conan_slam_tpu_torch.filters.pf.resample import (
    effective_count,
    stratified_indices,
    systematic_indices,
)
from conan_slam_tpu_torch.filters.pf.state import (
    ParticleEnsemble,
    normalized_weights,
    uniform_log_weight,
)
from conan_slam_tpu_torch.parallel.mesh import PARTICLE_AXIS

_SPLIT = ("log_w", "pose", "pose_cov", "xf", "pf")   # the per-particle leaves


def particle_block(mesh, n: int, axis: str = PARTICLE_AXIS) -> slice:
    """This rank's particles of an ensemble of ``n`` (``n`` must divide
    the axis)."""
    ax = mesh.axis(axis)
    chunk = n // ax.size
    if chunk * ax.size != n:
        raise ValueError(f"{n} particles do not divide over {ax.size} ranks")
    return slice(ax.index * chunk, (ax.index + 1) * chunk)


def shard_ensemble(mesh, ens: ParticleEnsemble, axis: str = PARTICLE_AXIS) -> ParticleEnsemble:
    """This rank's block of the ensemble on the mesh's device: the
    per-particle leaves split, the shared map bookkeeping replicated."""
    rows = particle_block(mesh, ens.num_particles, axis)
    return ParticleEnsemble(*(
        (leaf[rows] if name in _SPLIT else leaf).to(mesh.device).clone()
        for name, leaf in zip(ParticleEnsemble._fields, ens)))


def _weights(mesh, ens: ParticleEnsemble, axis: str):
    """The normalised weights of the whole ensemble and its Neff, on every
    rank: one all-gather of the (N,) log weights, then the single-device
    path's own arithmetic (``normalized_weights``, ``effective_count``) on
    them, so every rank and the single-device resample have the same bits."""
    log_w = mesh.axis(axis).all_gather(ens.log_w)
    w = normalized_weights(ens._replace(log_w=log_w))
    return w, effective_count(w)


def sharded_resample(mesh, ens: ParticleEnsemble, u, num_effective: float,
                     kind: str = "stratified", axis: str = PARTICLE_AXIS,
                     gate: torch.Tensor | None = None) -> ParticleEnsemble:
    """Resampling with explicit collectives (this rank's block ``ens``;
    ``u`` the step's global (N,) stratified uniforms, or the () one of
    "systematic").

      * weights: one tiled all-gather of the (N,) log weights, O(N) floats
        independent of the map size, as the reference's (N,) CDF gather;
        every rank then forms the normalised weights, Neff, the CDF and
        the ancestors of its output slots by the single-device path's own
        arithmetic, where the reference sums per shard (a max, two sums,
        the shards' partial sums, the CDF): the ancestors are the
        single-device resample's, bit for bit, with no flip where a
        stratum lies within the sums' rounding of a CDF boundary;
      * payload: each shard's particle block (pose, pose_cov, xf and pf
        packed into one (chunk, 12 + 6K) tensor) in one tiled all-gather,
        every shard taking the rows of its ancestors.  The reference
        rotates the blocks around a ring of ``ppermute`` steps, which
        moves the same n - 1 blocks to every shard; one gather gives the
        same rows in one collective.

    It applies where Neff < ``num_effective`` and ``gate`` (a () bool,
    default true) hold, by selection: the collectives run unconditionally.
    """
    ax = mesh.axis(axis)
    chunk = ens.num_particles
    n = chunk * ax.size
    i = ax.index
    w, neff = _weights(mesh, ens, axis)
    pick = systematic_indices if kind == "systematic" else stratified_indices
    idx_g = pick(u, w, n)[i * chunk:(i + 1) * chunk]             # global ancestor ids

    k = ens.capacity
    payload = torch.cat([ens.pose, ens.pose_cov.reshape(chunk, 9), ens.xf.reshape(chunk, 2 * k),
                         ens.pf.reshape(chunk, 4 * k)], dim=1)
    out = ax.all_gather(payload)[idx_g]

    do = neff < num_effective
    if gate is not None:
        do = do & gate
    out = torch.where(do, out, payload)
    return ens._replace(
        log_w=torch.where(do, uniform_log_weight(n), ens.log_w),
        pose=out[:, :3],
        pose_cov=out[:, 3:12].reshape(chunk, 3, 3),
        xf=out[:, 12:12 + 2 * k].reshape(chunk, k, 2),
        pf=out[:, 12 + 2 * k:].reshape(chunk, k, 2, 2),
    )


def _resample_with_roughening(mesh, ens: ParticleEnsemble, u, rough, num_effective, enabled,
                              kind: str = "stratified", roughening: float = 0.0,
                              gate: torch.Tensor | None = None,
                              axis: str = PARTICLE_AXIS) -> ParticleEnsemble:
    """``filters.pf.resample``-signature adapter over ``sharded_resample``
    (the hook of ``observation_step``): the sharded resample plus, where
    configured, the single-device path's post-resample pose roughening,
    its spread the global max and min (pmax, pmin), its normals this
    rank's slice of the step's global (N, 3) ``rough``."""
    if not enabled:
        return ens
    out = sharded_resample(mesh, ens, u, num_effective, kind, axis, gate=gate)
    if roughening > 0.0:
        ax = mesh.axis(axis)
        n = ens.num_particles * ax.size
        _, neff = _weights(mesh, ens, axis)
        did = neff < num_effective
        if gate is not None:
            did = did & gate
        spread = ax.pmax(ens.pose.amax(0)) - ax.pmin(ens.pose.amin(0))
        rough_l = rough[particle_block(mesh, n, axis)]
        jittered = out.pose + roughening * spread * float(n) ** (-1.0 / 3.0) * rough_l
        pose = torch.cat([jittered[:, :2], wrap_angle(jittered[:, 2:])], 1)
        out = out._replace(pose=torch.where(did, pose, out.pose))
    return out


def shard_draws(mesh, draws: pf_mod.ObservationDraws, n: int,
                axis: str = PARTICLE_AXIS) -> pf_mod.ObservationDraws:
    """One observation step's draws for this rank: its slice of each
    particle's proposal and prior samples; the resampling's uniforms and
    normals stay global (``sharded_resample`` slices its own)."""
    rows = particle_block(mesh, n, axis)
    return draws._replace(prop=draws.prop[rows], samp=draws.samp[rows])


def sharded_observation_step(
    mesh, ens: ParticleEnsemble, obs, r_cov, draws: pf_mod.ObservationDraws, *,
    num_effective: float,
    sample_proposal_on: bool,
    resample_on: bool,
    proposal_relinearize: bool = False,
    resample_kind: str = "stratified",
    roughening: float = 0.0,
    axis: str = PARTICLE_AXIS,
) -> ParticleEnsemble:
    """The FULL PF observation block under particle sharding: the
    single-device ``filters.pf.observation_step`` (the optimal proposal,
    the per-feature 2x2 updates, new-feature founding and the replicated
    table bookkeeping, reference PF.cpp:9-60, 222-277, 502-544) on this
    rank's block ``ens``, with the resampling swapped for the sharded one
    (``_resample_with_roughening``).  ``draws`` are the global (N, ...)
    draws of the step, as the single-device step takes them.  The
    per-particle blocks need no communication (their only cross-particle
    data, obs, table and n_active, is replicated)."""
    n = ens.num_particles * mesh.axis(axis).size
    return pf_mod.observation_step(
        ens, obs, r_cov, shard_draws(mesh, draws, n, axis),
        num_effective=num_effective,
        sample_proposal_on=sample_proposal_on,
        resample_on=resample_on,
        proposal_relinearize=proposal_relinearize,
        resample_kind=resample_kind,
        roughening=roughening,
        resample_fn=functools.partial(_resample_with_roughening, mesh, axis=axis),
    )
