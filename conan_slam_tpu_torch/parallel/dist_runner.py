"""Fully-sharded EKF-SLAM simulation loop (port of
conan_slam_tpu.parallel.dist_runner).

The distributed kernels (parallel.dist_ekf, parallel.dist_fastframe) in the
frame-structured driver of runner.loop.run_ekf_slam, with the joint state
and covariance row-block-sharded over the ``state`` mesh axis for the
whole run: the execution model for maps too large for one card (BASELINE
config 5).  Truth, steering and association bookkeeping are replicated
(O(1) / O(num_landmarks) data): every rank runs them alike on the same
draws, so they are the same bits on every rank.

The draws come in as ``run_ekf_slam``'s do: ``ctrl_noise`` (n_frames, S,
2) and ``obs_noise`` (n_frames, num_landmarks, 2) standard normals, or
from a ``torch.Generator`` that every rank seeds alike.  The reference's
key schedule is ``run_ekf_slam``'s (dist_runner.py:58, :67 against
runner/loop.py:741, :758), so its draws (``sim/data/valet_seed42.npz``)
drive this loop too.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from conan_slam_tpu_torch.config import SlamConfig
from conan_slam_tpu_torch.filters.ekf.state import EKFState
from conan_slam_tpu_torch.filters.ekf.state import init_state as empty_state
from conan_slam_tpu_torch.parallel import dist_ekf
from conan_slam_tpu_torch.parallel.dist_fastframe import sharded_frame_update
from conan_slam_tpu_torch.parallel.mesh import STATE_AXIS
from conan_slam_tpu_torch.runner.loop import (
    NoiseCovs,
    SimOutputs,
    _advance_truth,
    _outs_like,
    _sense,
    make_noise,
)
from conan_slam_tpu_torch.sim.steering import SteerState, init_steer_state
from conan_slam_tpu_torch.sim.world import World


class DistEKFCarry(NamedTuple):
    """The carry of the reference's loop less its key (the draws come in
    as tensors); ``x`` and ``p`` are this rank's row blocks."""

    steer: SteerState
    x_true: torch.Tensor
    x: torch.Tensor          # (chunk,) this rank's rows of the padded mean
    p: torch.Tensor          # (chunk, Dp) this rank's row block of the padded covariance
    n_active: torch.Tensor   # () int64 (replicated)
    table: torch.Tensor      # (num_ids,) int64 (replicated)


def dist_ekf_frame_step(carry: DistEKFCarry, draws, *, cfg: SlamConfig, world: World,
                        noise: NoiseCovs, mesh):
    """One observation frame on the sharded state; ``draws`` is ``(ctrl
    (S, 2), obs (num_landmarks, 2))`` standard normal.

    With ``cfg.fast_frame`` (the default) the whole frame, ``interval``
    predict + heading sub-steps compounded as a rank update, observe, and
    the Schur-style batched measurement update, is one per-rank function
    with three collective rounds (parallel.dist_fastframe); only the
    augment is a separate step, whose broadcast of the pose gives the
    frame's last ``x_est``.  Under ``fast_frame=False`` each sub-step is
    ``sharded_predict`` and ``sharded_observe_heading``, then
    ``sharded_observation_update``; each sub-step's ``x_est`` comes from
    rank 0's block by one 12-byte broadcast.  Returns ``(carry,
    SimOutputs of the frame's S steps)``, replicated.
    """
    ax = mesh.axis(STATE_AXIS)
    ctrl_draws, obs_draws = draws
    interval = cfg.observe_interval
    st, x_true, x, p = carry.steer, carry.x_true, carry.x, carry.p

    x_trues, dones, poses, subs = [], [], [], []
    for k in range(interval):
        was_done = st.done
        st, x_true, vn, swan = _advance_truth(st, x_true, world, cfg, ctrl_draws[k])
        x_trues.append(x_true)
        dones.append(st.done)
        if cfg.fast_frame:
            subs.append((vn, swan, x_true[2], ~was_done))
        else:
            x_new, p_new = dist_ekf.sharded_predict(mesh, x, p, vn, swan, noise.qe,
                                                    cfg.wheel_base, cfg.dt_controls)
            if cfg.switch_heading_known:
                x_new, p_new = dist_ekf.sharded_observe_heading(mesh, x_new, p_new, x_true[2],
                                                                cfg.sigma_heading)
            x = torch.where(was_done, x, x_new)
            p = torch.where(was_done, p, p_new)
            poses.append(dist_ekf._pose_from_shards(x, ax))

    obs = _sense(x_true, world, cfg, obs_draws)
    live = ~st.done

    # Known-association bookkeeping on the replicated table.
    slots = carry.table[torch.clamp(obs.ids, min=0)]
    known = obs.mask & (slots >= 0) & live
    new_mask = obs.mask & (slots < 0) & live

    cap = (x.shape[0] * ax.size - 3) // 2
    if cfg.fast_frame:
        vns, swans, phis, actives = (torch.stack(a) for a in zip(*subs))
        x, p, frame_nis, pose_trace = sharded_frame_update(
            mesh, x, p, vns, swans, phis, actives, noise.qe, obs.z,
            torch.clamp(slots, 0, cap - 1), known, noise.re,
            cfg.wheel_base, cfg.dt_controls, cfg.sigma_heading,
            cfg.switch_heading_known, gain_wire=cfg.dist_gain_wire,
        )
    else:
        x, p = dist_ekf.sharded_observation_update(mesh, x, p, obs.z, torch.clamp(slots, min=0),
                                                   known, noise.re, capacity=cap)
        frame_nis = torch.zeros((), dtype=x.dtype, device=x.device)
        pose_trace = torch.stack(poses)
    x, p, n_active, table, pose = dist_ekf._augment(mesh, x, p, obs.z, obs.ids, new_mask,
                                                    noise.re, carry.n_active, carry.table,
                                                    STATE_AXIS)

    zeros = torch.zeros((interval - 1,), dtype=x.dtype, device=x.device)
    outs = SimOutputs(
        x_true=torch.stack(x_trues),
        x_est=torch.cat([pose_trace[:-1], pose[None]]),
        done=torch.stack(dones),
        n_active=torch.cat([carry.n_active.expand(interval - 1), n_active[None]]),
        consistency=torch.cat([zeros, frame_nis[None]]),
    )
    return DistEKFCarry(steer=st, x_true=x_true, x=x, p=p, n_active=n_active, table=table), outs


def run_ekf_slam_sharded(
    world: World,
    cfg: SlamConfig,
    generator: torch.Generator | None,
    mesh,
    n_steps: int = 25_000,
    init_state: EKFState | None = None,
    *,
    ctrl_noise: torch.Tensor | None = None,
    obs_noise: torch.Tensor | None = None,
):
    """Sharded analogue of runner.loop.run_ekf_slam on the mesh's device:
    ``dist_ekf_frame_step`` over the frames, ``n_steps`` rounded up to
    whole frames.  ``init_state`` is an (unsharded) EKFState to start
    from (default: an empty map of ``cfg.max_landmarks`` slots).  Every
    rank calls it alike.  Returns ``(final DistEKFCarry with this rank's
    blocks, SimOutputs)``, the outputs replicated."""
    device = mesh.device
    interval = cfg.observe_interval
    n_frames = (n_steps + interval - 1) // interval
    if ctrl_noise is None:
        ctrl_noise = torch.randn((n_frames, interval, 2), generator=generator, device=device)
    if obs_noise is None:
        obs_noise = torch.randn((n_frames, world.num_landmarks, 2), generator=generator,
                                device=device)
    state0 = (init_state if init_state is not None
              else empty_state(cfg.max_landmarks, world.num_landmarks, device=device))
    xs, ps = dist_ekf.shard_state(mesh, state0.x, state0.p)
    carry = DistEKFCarry(
        steer=init_steer_state(cfg.number_loops, device),
        x_true=torch.zeros((3,), dtype=torch.float32, device=device),
        x=xs, p=ps, n_active=state0.n_active.to(device), table=state0.table.to(device),
    )
    noise = make_noise(cfg, "ekf", device)
    outs = _outs_like(n_frames * interval, device)
    frames = SimOutputs(*(o.view(n_frames, interval, *o.shape[1:]) for o in outs))
    for f in range(n_frames):
        carry, out = dist_ekf_frame_step(carry, (ctrl_noise[f].to(device), obs_noise[f].to(device)),
                                         cfg=cfg, world=world, noise=noise, mesh=mesh)
        for dst, src in zip(frames, out):
            dst[f] = src
    return carry, outs
