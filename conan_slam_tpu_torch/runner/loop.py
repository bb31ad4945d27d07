"""The precomputed-rollout EKF driver (port of
conan_slam_tpu.runner.loop.run_ekf_slam_precomputed: known or gated
association, with or without map augmentation).

The truth trajectory and the visibility schedule are rolled out once on the
host (sim.precompute, numpy); the device loop holds filter work only.  The reference scans the frames with ``lax.scan``; here it is a
Python loop over frames that never waits for the device (no ``.item()``,
no host copies inside it), so the host runs ahead and enqueues frames
while the card works.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from conan_slam_tpu_torch.config import SlamConfig
from conan_slam_tpu_torch.filters.common import CompactObs
from conan_slam_tpu_torch.filters.ekf import (
    associate_gated,
    associate_known,
    augment,
    fused_frame_step,
    fused_frame_update,
)
from conan_slam_tpu_torch.filters.ekf.state import EKFState
from conan_slam_tpu_torch.filters.ekf.state import init_state as empty_state
from conan_slam_tpu_torch.ops.factor_kernel import frame_factors_fused
from conan_slam_tpu_torch.sim.precompute import rollout_observations, rollout_truth
from conan_slam_tpu_torch.sim.world import World


class NoiseCovs(NamedTuple):
    """True and filter (inflated) noise covariances (reference
    test/main.cpp:93-129: QE = 2Q; RE = 8R for the EKF, 2R for the PF)."""

    q: torch.Tensor    # (2, 2) true control noise
    r: torch.Tensor    # (2, 2) true observation noise
    qe: torch.Tensor   # (2, 2) filter control noise
    re: torch.Tensor   # (2, 2) filter observation noise


def make_noise(cfg: SlamConfig, estimator: str = "ekf", device=None) -> NoiseCovs:
    q = torch.diag(torch.tensor([cfg.sigma_v**2, cfg.sigma_swa**2], dtype=torch.float32, device=device))
    r = torch.diag(torch.tensor([cfg.sigma_r**2, cfg.sigma_b**2], dtype=torch.float32, device=device))
    if cfg.switch_inflate_noise:
        r_mult = cfg.r_inflate_ekf if estimator == "ekf" else cfg.r_inflate_pf
        return NoiseCovs(q=q, r=r, qe=cfg.q_inflate * q, re=r_mult * r)
    return NoiseCovs(q=q, r=r, qe=q, re=r)


class SimOutputs(NamedTuple):
    x_true: torch.Tensor      # (T, 3)
    x_est: torch.Tensor       # (T, 3)
    done: torch.Tensor        # (T,) bool
    n_active: torch.Tensor    # (T,) map size after each step's frame
    # The frame's NIS per associated measurement on its last step, else 0.
    consistency: torch.Tensor  # (T,) float32


def ekf_precomp_frame_step(state: EKFState, frame, *, cfg: SlamConfig,
                           noise: NoiseCovs, plain: bool = False):
    """One observation frame against the host-precomputed rollout.

    ``frame`` is ``(x_true (S, 3), swa (S,), active (S,), done (S,),
    ctrl_noise (S, 2), z_true (NZ, 2), ids (NZ,), zmask (NZ,),
    obs_noise (NZ, 2))``.  Returns ``(state, x_est (S, 3), frame_nis)``:
    the pose trace with the post-update pose on the last sub-step.
    """
    (x_true_f, swa_f, active_f, done_f, ctrl_noise_f,
     z_true_f, ids_f, zmask_f, obs_noise_f) = frame

    if cfg.switch_control_noise:
        vns = cfg.velocity + ctrl_noise_f[:, 0] * cfg.sigma_v
        swans = swa_f + ctrl_noise_f[:, 1] * cfg.sigma_swa
    else:
        vns = torch.full_like(swa_f, cfg.velocity)
        swans = swa_f
    z = z_true_f
    if cfg.switch_sensor_noise:
        scale = torch.tensor([cfg.sigma_r, cfg.sigma_b], dtype=z.dtype, device=z.device)
        z = z + obs_noise_f * scale
    obs = CompactObs(z=torch.where(zmask_f[:, None], z, 0.0), ids=ids_f, mask=zmask_f)

    live = torch.logical_not(done_f[-1])
    if cfg.switch_association_known:
        assoc = associate_known(state, obs)
        state, pose_trace, frame_nis = fused_frame_step(
            state, vns, swans, x_true_f[:, 2], active_f, noise.qe, obs,
            assoc.slots, assoc.known_mask & live, noise.re,
            cfg.wheel_base, cfg.dt_controls, cfg.sigma_heading,
            cfg.switch_heading_known, plain=plain,
        )
    else:
        state, pose_trace, vtf, bmat = frame_factors_fused(
            state, vns, swans, x_true_f[:, 2], active_f, noise.qe,
            cfg.wheel_base, cfg.dt_controls, cfg.sigma_heading,
            cfg.switch_heading_known, plain=plain,
        )
        assoc = associate_gated(state, obs, noise.re, cfg.gate_reject, cfg.gate_augment,
                                vtf.T, bmat, plain=plain)
        state, frame_nis = fused_frame_update(
            state, bmat, vtf, obs, assoc.slots, assoc.known_mask & live, noise.re,
            return_nis=True, plain=plain,
        )
    if cfg.enable_augment:
        # Unconditional (no host sync): a frame with nothing new writes nothing new.
        state = augment(state, obs, assoc.new_mask & live, noise.re)
    x_est = torch.cat([pose_trace[:-1], state.x[None, :3]])
    return state, x_est, frame_nis


def precompute_rollout(world: World, cfg: SlamConfig, n_steps: int, device=None):
    """Host-side truth + observation rollout, as tensors on ``device``
    (default: the world's).  Seed-independent: compute it once and pass it
    as ``precomputed=`` to time several runs of one workload."""
    device = world.landmarks.device if device is None else device
    interval = cfg.observe_interval
    n_steps = ((n_steps + interval - 1) // interval) * interval
    roll = rollout_truth(world.waypoints.cpu().numpy(), cfg, n_steps)
    nz = min(world.num_landmarks, cfg.max_observations())
    obs_roll = rollout_observations(
        roll.x_true, world.landmarks.cpu().numpy(), cfg.max_range, nz, interval
    )

    def dev(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    truth = (dev(roll.x_true), dev(roll.swa), dev(roll.active), dev(roll.done))
    obs = (dev(obs_roll.z_true), dev(obs_roll.ids, torch.int64), dev(obs_roll.mask))
    return truth, obs


def run_ekf_slam_precomputed(
    world: World,
    cfg: SlamConfig,
    generator: torch.Generator | None = None,
    n_steps: int = 25_000,
    init_state: EKFState | None = None,
    precomputed=None,
    *,
    ctrl_noise: torch.Tensor | None = None,
    obs_noise: torch.Tensor | None = None,
    plain: bool = False,
):
    """The EKF over the precomputed rollout: known-table
    (``cfg.switch_association_known``) or gated nearest-neighbour
    association, with map augmentation where ``cfg.enable_augment``.  The
    initial state defaults to an empty map of ``cfg.max_landmarks`` slots.

    The noise is ``ctrl_noise`` (n_frames, S, 2) and ``obs_noise``
    (n_frames, NZ, 2) standard normal draws where given (a parity test
    passes the reference's own), else drawn from ``generator`` on the
    world's device.  ``plain=True`` runs every kernel's plain PyTorch
    version.  Returns ``(final EKFState, SimOutputs)``.

    The frame-pair schedule is not ported: it raises ``NotImplementedError``.
    """
    if cfg.frame_pair:
        raise NotImplementedError("the frame-pair schedule is not ported: set frame_pair=False")
    device = world.landmarks.device
    interval = cfg.observe_interval
    n_steps = ((n_steps + interval - 1) // interval) * interval
    if precomputed is None:
        precomputed = precompute_rollout(world, cfg, n_steps, device)
    (x_true, swa, active, done), (z_true, ids, zmask) = precomputed
    state = (init_state if init_state is not None
             else empty_state(cfg.max_landmarks, world.num_landmarks, device=device))
    n_frames = n_steps // interval
    nz = z_true.shape[1]
    if ctrl_noise is None:
        ctrl_noise = torch.randn((n_frames, interval, 2), generator=generator, device=device)
    if obs_noise is None:
        obs_noise = torch.randn((n_frames, nz, 2), generator=generator, device=device)
    noise = make_noise(cfg, "ekf", device)

    frames = (
        x_true.reshape(n_frames, interval, 3), swa.reshape(n_frames, interval),
        active.reshape(n_frames, interval), done.reshape(n_frames, interval),
        ctrl_noise, z_true, ids, zmask, obs_noise,
    )
    x_est = torch.empty((n_frames, interval, 3), dtype=torch.float32, device=device)
    consistency = torch.zeros((n_frames, interval), dtype=torch.float32, device=device)
    n_active = torch.empty((n_frames, interval), dtype=torch.int64, device=device)
    for f in range(n_frames):
        state, x_est[f], consistency[f, -1] = ekf_precomp_frame_step(
            state, tuple(a[f] for a in frames), cfg=cfg, noise=noise, plain=plain,
        )
        n_active[f] = state.n_active
    outs = SimOutputs(
        x_true=x_true, x_est=x_est.reshape(n_steps, 3), done=done,
        n_active=n_active.reshape(n_steps), consistency=consistency.reshape(n_steps),
    )
    return state, outs

