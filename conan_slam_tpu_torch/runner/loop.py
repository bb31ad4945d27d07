"""The drivers (port of conan_slam_tpu.runner.loop):

* ``run_ekf_slam``, the on-device simulation loop (reference
  test/main.cpp:89-201): steering, truth motion, odometry noise, the
  sensor and its compaction run on the device beside the filter, one
  observation frame of ``observe_interval`` control steps at a time
  (``ekf_frame_step``; ``ekf_sim_step`` is one control step);
* ``run_ekf_slam_precomputed``, the precomputed-rollout driver: known or
  gated association, with or without map augmentation, one frame or a
  frame pair per P pass; and ``run_ekf_slam_precomputed_chunked``, the
  same run in chunks with checkpoints to resume from.  The truth
  trajectory and the visibility schedule are rolled out once on the host
  (sim.precompute, numpy); the device loop holds filter work only;
* ``run_pf_slam``, FastSLAM 2.0 on the same on-device simulation (reference
  test/main.cpp:204-335): ``pf_frame_step`` over the frames, or
  ``pf_sim_step`` over the control steps.

The reference scans the frames with ``lax.scan``; here each driver is a
Python loop over frames that never waits for the device (no ``.item()``,
no host copies, no branch on a device value inside it; the reference's
``lax.cond``s are ``torch.where``s or run where the skipped branch is an
exact no-op), so the host runs ahead and enqueues frames while the card
works.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import NamedTuple

import numpy as np
import torch

from conan_slam_tpu_torch.config import SlamConfig
from conan_slam_tpu_torch.device import default_device
from conan_slam_tpu_torch.filters import pf as pf_mod
from conan_slam_tpu_torch.filters.common import CompactObs, compact
from conan_slam_tpu_torch.filters.ekf import (
    associate_known,
    augment,
    factor_and_associate_gated,
    frame_predict_heading,
    fused_frame_pair_step,
    fused_frame_step,
    fused_frame_update,
    observation_step,
    observe_heading,
    predict,
)
from conan_slam_tpu_torch.filters.ekf.state import EKFState
from conan_slam_tpu_torch.filters.ekf.state import init_state as empty_state
from conan_slam_tpu_torch.filters.ekf.state import state_from_numpy, state_to_numpy
from conan_slam_tpu_torch.models import motion
from conan_slam_tpu_torch.sim import sensor_sim
from conan_slam_tpu_torch.sim.precompute import rollout_observations, rollout_truth
from conan_slam_tpu_torch.sim.steering import SteerState, init_steer_state, steer
from conan_slam_tpu_torch.sim.world import World
from conan_slam_tpu_torch.utils import checkpoint
from conan_slam_tpu_torch.utils.profiling import alloc, count, span

# The attributes of a pair's ``frame`` span.
PAIR = {"frames": 2}


class NoiseCovs(NamedTuple):
    """True and filter (inflated) noise covariances (reference
    test/main.cpp:93-129: QE = 2Q; RE = 8R for the EKF, 2R for the PF)."""

    q: torch.Tensor    # (2, 2) true control noise
    r: torch.Tensor    # (2, 2) true observation noise
    qe: torch.Tensor   # (2, 2) filter control noise
    re: torch.Tensor   # (2, 2) filter observation noise


def make_noise(cfg: SlamConfig, estimator: str = "ekf", device=None) -> NoiseCovs:
    """The covariances on ``device`` (default: the card)."""
    device = default_device() if device is None else device

    def diag2(a: float, b: float) -> torch.Tensor:
        # Filled on the device: a tensor made from a list, or an element
        # set from a Python float, copies from the host and waits for it.
        return torch.diag(torch.stack([torch.full((), v, dtype=torch.float32, device=device)
                                       for v in (a, b)]))

    q = diag2(cfg.sigma_v**2, cfg.sigma_swa**2)
    r = diag2(cfg.sigma_r**2, cfg.sigma_b**2)
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


def _noisy_obs(cfg: SlamConfig, z_true, ids, zmask, obs_noise) -> CompactObs:
    """The measurement buffer (any leading shape): truth plus the scaled
    draws where ``cfg.switch_sensor_noise``, zero in empty slots."""
    z = sensor_sim.add_observation_noise(obs_noise, sensor_sim.Observation(z_true, zmask),
                                         cfg.sigma_r, cfg.sigma_b, cfg.switch_sensor_noise).z
    return CompactObs(z=torch.where(zmask[..., None], z, 0.0), ids=ids, mask=zmask)


def fused_frame(state: EKFState, vns, swans, phis, actives, obs: CompactObs, live, *,
                cfg: SlamConfig, noise: NoiseCovs, plain: bool = False):
    """The fused update of one frame, as both drivers run it: the S
    predict + heading sub-steps of controls ``vns``/``swans`` (S,), heading
    measurements ``phis`` (S,) and ``actives`` (S,), then the measurement
    update on ``obs`` and, where ``cfg.enable_augment``, the augmentation;
    ``live`` () is False once the course is done (nothing associates or
    augments then).

    Known association: one launch of H9 (``fused_frame_step``); gated: H15
    (the factors and the association) then H10 (``fused_frame_update``).
    Returns ``(state, pose_trace (S, 3), frame NIS per associated
    measurement)``.
    """
    if cfg.switch_association_known:
        with span("frame.associate"):
            assoc = associate_known(state, obs)
        with span("frame.update"):
            state, pose_trace, frame_nis = fused_frame_step(
                state, vns, swans, phis, actives, noise.qe, obs,
                assoc.slots, assoc.known_mask & live, noise.re,
                cfg.wheel_base, cfg.dt_controls, cfg.sigma_heading,
                cfg.switch_heading_known, plain=plain,
            )
    else:
        # H15 runs the gated frame's predict with its association.
        with span("frame.associate"):
            state, pose_trace, vtf, bmat, assoc = factor_and_associate_gated(
                state, vns, swans, phis, actives, noise.qe,
                cfg.wheel_base, cfg.dt_controls, cfg.sigma_heading,
                cfg.switch_heading_known, obs, noise.re, cfg.gate_reject, cfg.gate_augment,
                plain=plain,
            )
        with span("frame.update"):
            state, frame_nis = fused_frame_update(
                state, bmat, vtf, obs, assoc.slots, assoc.known_mask & live, noise.re,
                return_nis=True, plain=plain,
            )
    if cfg.enable_augment:
        # Unconditional (no host sync): a frame with nothing new writes nothing new.
        with span("frame.augment"):
            state = augment(state, obs, assoc.new_mask & live, noise.re)
    return state, pose_trace, frame_nis


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
    with span("frame.inputs"):
        vns, swans = sensor_sim.add_control_noise(ctrl_noise_f, cfg.velocity, swa_f, cfg.sigma_v,
                                                 cfg.sigma_swa, cfg.switch_control_noise)
        obs = _noisy_obs(cfg, z_true_f, ids_f, zmask_f, obs_noise_f)

    live = torch.logical_not(done_f[-1])
    state, pose_trace, frame_nis = fused_frame(state, vns, swans, x_true_f[:, 2], active_f, obs,
                                               live, cfg=cfg, noise=noise, plain=plain)
    x_est = torch.cat([pose_trace[:-1], state.x[None, :3]])
    return state, x_est, frame_nis


def ekf_precomp_pair_step(state: EKFState, pair, *, cfg: SlamConfig,
                          noise: NoiseCovs, plain: bool = False):
    """Two consecutive frames with one P pass (filters.ekf.
    fused_frame_pair_step): the math of two ``ekf_precomp_frame_step``
    calls, for known association without augmentation, so both frames
    associate against the same table.

    ``pair`` holds the fields of ``ekf_precomp_frame_step``'s ``frame``
    with a leading 2.  Returns ``(state, x_est (2, S, 3), frame_nis (2,))``:
    frame A's pose trace ends in its post-update pose, frame B's in the
    final one.
    """
    (x_true_f, swa_f, active_f, done_f, ctrl_noise_f,
     z_true_f, ids_f, zmask_f, obs_noise_f) = pair
    with span("frame.inputs"):
        vns2, swans2 = sensor_sim.add_control_noise(ctrl_noise_f, cfg.velocity, swa_f,
                                                   cfg.sigma_v, cfg.sigma_swa,
                                                   cfg.switch_control_noise)
        obs2 = _noisy_obs(cfg, z_true_f, ids_f, zmask_f, obs_noise_f)
        obs_a, obs_b = (CompactObs(*(t[k] for t in obs2)) for k in (0, 1))
    with span("frame.associate"):
        assoc_a, assoc_b = associate_known(state, obs_a), associate_known(state, obs_b)
    live = torch.logical_not(done_f[:, -1])
    with span("frame.update"):
        state, pose_trace, frame_nis, pose_mid = fused_frame_pair_step(
            state, vns2, swans2, x_true_f[:, :, 2], active_f, noise.qe,
            obs_a, assoc_a.slots, assoc_a.known_mask & live[0],
            obs_b, assoc_b.slots, assoc_b.known_mask & live[1], noise.re,
            cfg.wheel_base, cfg.dt_controls, cfg.sigma_heading, cfg.switch_heading_known,
            plain=plain,
        )
    ends = torch.stack([pose_mid, state.x[:3]])[:, None]
    return state, torch.cat([pose_trace[:, :-1], ends], dim=1), frame_nis


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

    With ``cfg.frame_pair`` the frames run in pairs, one P pass each
    (``ekf_precomp_pair_step``), where the reference pairs them: known
    association, no augmentation, the fast fused batch frame and an even
    number of frames; elsewhere one frame at a time, as the reference does.

    Where the port's tracer is on (``utils.profiling.tracing``), the call
    is a ``request`` span holding ``request.setup`` and one ``frame`` span
    a frame or pair, and counts ``requests``, ``frames`` and, on the card,
    ``alloc_bytes``.
    """
    device = world.landmarks.device
    interval = cfg.observe_interval
    n_steps = ((n_steps + interval - 1) // interval) * interval
    n_frames = n_steps // interval
    with span("request"):
        count("requests")
        with span("request.setup"):
            if precomputed is None:
                precomputed = precompute_rollout(world, cfg, n_steps, device)
            (x_true, swa, active, done), (z_true, ids, zmask) = precomputed
            state = (init_state if init_state is not None
                     else empty_state(cfg.max_landmarks, world.num_landmarks, device=device))
            nz = z_true.shape[1]
            if ctrl_noise is None:
                ctrl_noise = torch.randn((n_frames, interval, 2), generator=generator,
                                         device=device)
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
            use_pair = (cfg.frame_pair and cfg.switch_association_known
                        and not cfg.enable_augment and cfg.fast_frame and cfg.fused_obs
                        and cfg.switch_batch_update and n_frames % 2 == 0)
        if use_pair:
            for f in range(0, n_frames, 2):
                with alloc(device), span("frame", PAIR):
                    state, x_f, nis_f = ekf_precomp_pair_step(
                        state, tuple(a[f:f + 2] for a in frames), cfg=cfg, noise=noise,
                        plain=plain,
                    )
                    with span("frame.outputs"):
                        x_est[f:f + 2], consistency[f:f + 2, -1] = x_f, nis_f
                        n_active[f:f + 2] = state.n_active
                count("frames", 2)
        else:
            for f in range(n_frames):
                with alloc(device), span("frame"):
                    state, x_f, nis_f = ekf_precomp_frame_step(
                        state, tuple(a[f] for a in frames), cfg=cfg, noise=noise, plain=plain,
                    )
                    with span("frame.outputs"):
                        x_est[f], consistency[f, -1] = x_f, nis_f
                        n_active[f] = state.n_active
                count("frames")
        outs = SimOutputs(
            x_true=x_true, x_est=x_est.reshape(n_steps, 3), done=done,
            n_active=n_active.reshape(n_steps), consistency=consistency.reshape(n_steps),
        )
    return state, outs



def _chunk_seed(seed: int, chunk: int) -> int:
    """The generator seed of chunk ``chunk`` of a chunked run from ``seed``:
    fixed by the two numbers alone (numpy's SeedSequence), as the
    reference's ``fold_in(key, c)``."""
    return int(np.random.SeedSequence([seed, chunk]).generate_state(1, np.uint64)[0])


def _run_id(seed: int, cfg: SlamConfig, n_steps: int, world: World, tensors) -> str:
    """What a checkpointed chunk must match to be resumed from: the seed, the
    config, the horizon, the world, and the initial state and noise tensors
    where the caller gives them."""
    ident = hashlib.sha256()
    ident.update(str(seed).encode())
    ident.update(repr(cfg).encode())
    ident.update(str(n_steps).encode())
    for t in (world.landmarks, world.waypoints, *tensors):
        ident.update(t.detach().cpu().numpy().tobytes())
    return ident.hexdigest()[:16]


def _outs_like(n_steps: int, device) -> SimOutputs:
    """A ``SimOutputs`` of ``n_steps`` steps, as a checkpoint template."""
    f32 = torch.float32
    return SimOutputs(
        x_true=torch.zeros((n_steps, 3), dtype=f32, device=device),
        x_est=torch.zeros((n_steps, 3), dtype=f32, device=device),
        done=torch.zeros((n_steps,), dtype=torch.bool, device=device),
        n_active=torch.zeros((n_steps,), dtype=torch.int64, device=device),
        consistency=torch.zeros((n_steps,), dtype=f32, device=device),
    )


def run_ekf_slam_precomputed_chunked(
    world: World,
    cfg: SlamConfig,
    seed: int,
    n_steps: int,
    chunk_steps: int,
    init_state: EKFState | None = None,
    precomputed=None,
    checkpoint_dir: str | None = None,
    *,
    ctrl_noise: torch.Tensor | None = None,
    obs_noise: torch.Tensor | None = None,
    plain: bool = False,
):
    """``run_ekf_slam_precomputed`` over the horizon in chunks of
    ``chunk_steps`` (rounded up to whole frames, a ragged tail allowed),
    the state carried from one chunk to the next; each chunk pairs its
    frames under ``cfg.frame_pair`` where its frame count is even.

    Chunk c draws its noise from a generator on the world's device seeded
    with ``_chunk_seed(seed, c)``, so the realisation differs from the
    one-shot run's as another seed's does.  Whole-horizon ``ctrl_noise``
    (n_frames, S, 2) and ``obs_noise`` (n_frames, NZ, 2), where given, are
    sliced per chunk instead (a parity test feeds the reference's draws).

    With ``checkpoint_dir``, each finished chunk saves its outputs and the
    carried state (utils.checkpoint) as ``chunk_{c:05d}.pt``, then a
    ``chunk_{c:05d}.meta.json`` with its bounds and the run id; a rerun
    resumes after the longest prefix of chunks whose metas match its own
    bounds and run id (``_run_id``), so a killed and resumed run is
    bit-identical to an uninterrupted one.  A meta without a run id is a
    mismatch.  Returns ``(final EKFState, SimOutputs)`` over the horizon.
    """
    device = world.landmarks.device
    interval = cfg.observe_interval
    chunk_steps = ((chunk_steps + interval - 1) // interval) * interval
    n_steps = ((n_steps + interval - 1) // interval) * interval
    if precomputed is None:
        precomputed = precompute_rollout(world, cfg, n_steps, device)
    truth, obs = precomputed
    if truth[0].shape[0] < n_steps:
        raise ValueError(
            f"precomputed truth rollout covers {truth[0].shape[0]} steps but "
            f"n_steps={n_steps} (rounded to whole frames) was requested")
    if obs[0].shape[0] < n_steps // interval:
        raise ValueError(
            f"precomputed observation rollout covers {obs[0].shape[0]} frames but "
            f"{n_steps // interval} are needed for n_steps={n_steps}")
    state = (init_state if init_state is not None
             else empty_state(cfg.max_landmarks, world.num_landmarks, device=device))
    bounds = [(s0, min(s0 + chunk_steps, n_steps)) for s0 in range(0, n_steps, chunk_steps)]

    outs_list: list[SimOutputs] = []
    start = 0
    if checkpoint_dir is not None:
        given = [t for t in (*(init_state or ()), ctrl_noise, obs_noise) if t is not None]
        run_id = _run_id(seed, cfg, n_steps, world, given)

        def path(c: int, ext: str) -> str:
            return os.path.join(checkpoint_dir, f"chunk_{c:05d}.{ext}")

        while start < len(bounds) and os.path.exists(path(start, "meta.json")):
            with open(path(start, "meta.json")) as f:
                meta = json.load(f)
            s0, s1 = bounds[start]
            if meta.get("s0") != s0 or meta.get("s1") != s1 or meta.get("run_id") != run_id:
                break
            start += 1
        for c in range(start):
            s0, s1 = bounds[c]
            restored = checkpoint.restore(path(c, "pt"),
                                          {"state": state, "outs": _outs_like(s1 - s0, device)})
            outs_list.append(restored["outs"])
        if start:
            state = restored["state"]
    for c in range(start, len(bounds)):
        s0, s1 = bounds[c]
        f0, f1 = s0 // interval, s1 // interval
        part = (tuple(a[s0:s1] for a in truth), tuple(a[f0:f1] for a in obs))
        gen = torch.Generator(device=device).manual_seed(_chunk_seed(seed, c))
        state, outs = run_ekf_slam_precomputed(
            world, cfg, gen, s1 - s0, state, part,
            ctrl_noise=None if ctrl_noise is None else ctrl_noise[f0:f1],
            obs_noise=None if obs_noise is None else obs_noise[f0:f1], plain=plain,
        )
        outs_list.append(outs)
        if checkpoint_dir is not None:
            os.makedirs(checkpoint_dir, exist_ok=True)
            checkpoint.save(path(c, "pt"), {"state": state, "outs": outs})
            meta = {"s0": s0, "s1": s1, "chunk_steps": chunk_steps, "run_id": run_id}
            with open(path(c, "meta.json.tmp"), "w") as f:
                json.dump(meta, f)
            os.replace(path(c, "meta.json.tmp"), path(c, "meta.json"))
    return state, SimOutputs(*(torch.cat(fields) for fields in zip(*outs_list)))


# ------------------------------------------------- the on-device simulation loop


class EKFSimCarry(NamedTuple):
    """What the on-device loop carries from step to step (the reference's
    carry less its key: the port's draws come in as tensors)."""

    steer: SteerState
    x_true: torch.Tensor         # (3,) ground-truth pose
    state: EKFState
    step_in_frame: torch.Tensor  # () int64 control steps since the last observation


def carry_from_numpy(steer_state, x_true, state, step_in_frame, device=None) -> EKFSimCarry:
    """A carry from numpy arrays: ``steer_state`` (swa, iwp, loops_left,
    done), ``state`` (x, p, n_active, table), as the fields of a JAX
    ``EKFSimCarry`` give them (``carry_from_numpy(*jax_carry[:4])``), on
    ``device`` (default: the card)."""
    device = default_device() if device is None else device
    swa, iwp, loops_left, done = (np.asarray(a) for a in steer_state)
    return EKFSimCarry(
        steer=SteerState(
            swa=torch.tensor(swa.astype(np.float32), device=device),
            iwp=torch.tensor(iwp.astype(np.int64), device=device),
            loops_left=torch.tensor(loops_left.astype(np.int64), device=device),
            done=torch.tensor(done.astype(bool), device=device),
        ),
        x_true=torch.tensor(np.asarray(x_true, np.float32), device=device),
        state=state_from_numpy(*state, device=device),
        step_in_frame=torch.tensor(np.asarray(step_in_frame).astype(np.int64), device=device),
    )


def carry_to_numpy(carry: EKFSimCarry):
    """``(steer (swa, iwp, loops_left, done), x_true, state (x, p,
    n_active, table), step_in_frame)`` as numpy arrays in the JAX
    package's dtypes."""
    st = carry.steer
    return (
        (st.swa.cpu().numpy(), np.int32(st.iwp.item()), np.int32(st.loops_left.item()),
         np.bool_(st.done.item())),
        carry.x_true.cpu().numpy(),
        state_to_numpy(carry.state),
        np.int32(carry.step_in_frame.item()),
    )


def _freeze(hold, old: EKFState, new: EKFState) -> EKFState:
    """``old`` where ``hold`` (a () bool tensor), else ``new``."""
    return EKFState(*(torch.where(hold, o, n) for o, n in zip(old, new)))


def _advance_truth(steer_state: SteerState, x_true, world: World, cfg: SlamConfig, ctrl_draw):
    """Steering, ground-truth motion and noisy odometry of one control step
    (reference test/main.cpp:140-162); ``ctrl_draw`` (2,) standard normal.
    Returns ``(steer, x_true, v measured, swa measured)``."""
    st = steer(steer_state, x_true, world.waypoints, at_waypoint=cfg.at_waypoint,
               rate_swa=cfg.rate_swa, max_swa=cfg.max_swa, dt=cfg.dt_controls)
    x_new = motion.step(x_true, cfg.velocity, st.swa, cfg.wheel_base, cfg.dt_controls)
    x_new = torch.where(st.done, x_true, x_new)
    vn, swan = sensor_sim.add_control_noise(ctrl_draw, cfg.velocity, st.swa, cfg.sigma_v,
                                            cfg.sigma_swa, cfg.switch_control_noise)
    return st, x_new, vn, swan


def _sense(x_true, world: World, cfg: SlamConfig, obs_draws) -> CompactObs:
    """The frame's measurement buffer: every landmark's return from
    ``x_true``, noise from ``obs_draws`` (num_landmarks, 2) where
    ``cfg.switch_sensor_noise`` (before compaction, as the reference adds
    it), compacted to min(num_landmarks, cfg.max_observations()) slots."""
    obs = sensor_sim.get_observations(x_true, world.landmarks, cfg.max_range)
    obs = sensor_sim.add_observation_noise(obs_draws, obs, cfg.sigma_r, cfg.sigma_b,
                                           cfg.switch_sensor_noise)
    return compact(obs, min(world.num_landmarks, cfg.max_observations()))


def ekf_sim_step(carry: EKFSimCarry, draws, *, cfg: SlamConfig, world: World,
                 noise: NoiseCovs, plain: bool = False):
    """One control step (reference test/main.cpp:140-199): truth and
    odometry, predict, the heading observation where
    ``cfg.switch_heading_known``, and on every ``observe_interval``-th step
    the observation update (``observation_step``); the filter freezes once
    the course is done.  ``draws`` is ``(ctrl (2,), obs (num_landmarks,
    2))`` standard normal.  Returns ``(carry, SimOutputs of this step)``.
    """
    ctrl_draw, obs_draws = draws
    was_done = carry.steer.done
    st, x_true, vn, swan = _advance_truth(carry.steer, carry.x_true, world, cfg, ctrl_draw)
    state = predict(carry.state, vn, swan, noise.qe, cfg.wheel_base, cfg.dt_controls)
    if cfg.switch_heading_known:
        state = observe_heading(state, x_true[2], cfg.sigma_heading)
    step_in_frame = carry.step_in_frame + 1
    do_obs = (step_in_frame >= cfg.observe_interval) & ~st.done
    step_in_frame = torch.where(do_obs, 0, step_in_frame)
    observed, nis = observation_step(
        state, _sense(x_true, world, cfg, obs_draws), noise.re,
        association_known=cfg.switch_association_known, batch=cfg.switch_batch_update,
        gate_reject=cfg.gate_reject, gate_augment=cfg.gate_augment, return_nis=True, plain=plain)
    state = _freeze(~do_obs, state, observed)
    state = _freeze(was_done, carry.state, state)
    out = SimOutputs(x_true=x_true, x_est=state.x[:3], done=st.done, n_active=state.n_active,
                     consistency=torch.where(do_obs, nis, 0.0))
    return EKFSimCarry(steer=st, x_true=x_true, state=state, step_in_frame=step_in_frame), out


def ekf_frame_step(carry: EKFSimCarry, draws, *, cfg: SlamConfig, world: World,
                   noise: NoiseCovs, plain: bool = False):
    """One observation frame: ``observe_interval`` control sub-steps, then
    one observation update (reference test/main.cpp:171-174: every 6th
    step).  ``draws`` is ``(ctrl (S, 2), obs (num_landmarks, 2))`` standard
    normal.  Returns ``(carry, SimOutputs of the frame's S steps)``.

    Routes, as the reference's (runner/loop.py:733-888):
      * ``cfg.fast_frame``, ``fused_obs`` and ``switch_batch_update``: the
        fused frame (``fused_frame``: H9, or H15 then H10);
      * ``fast_frame`` otherwise: the sub-steps as one materialised rank
        update (``frame_predict_heading``), then ``observation_step``;
      * no ``fast_frame``: ``predict`` and ``observe_heading`` each
        sub-step, then ``observation_step``.
    On the inner sub-steps ``x_est`` is the pose trace and ``n_active``
    the map before the update; the last sub-step carries the
    post-update pose, map size and the frame's NIS.
    """
    ctrl_draws, obs_draws = draws
    s_steps = cfg.observe_interval
    st, x_true, state = carry.steer, carry.x_true, carry.state
    x_trues, dones, poses, subs = [], [], [], []
    for k in range(s_steps):
        was_done = st.done
        st, x_true, vn, swan = _advance_truth(st, x_true, world, cfg, ctrl_draws[k])
        x_trues.append(x_true)
        dones.append(st.done)
        if cfg.fast_frame:
            subs.append((vn, swan, x_true[2], ~was_done))
        else:
            new = predict(state, vn, swan, noise.qe, cfg.wheel_base, cfg.dt_controls)
            if cfg.switch_heading_known:
                new = observe_heading(new, x_true[2], cfg.sigma_heading)
            state = _freeze(was_done, state, new)
            poses.append(state.x[:3])
    n_active = state.n_active
    obs = _sense(x_true, world, cfg, obs_draws)
    live = ~st.done
    if cfg.fast_frame:
        vns, swans, phis, actives = (torch.stack(a) for a in zip(*subs))
    if cfg.fast_frame and cfg.fused_obs and cfg.switch_batch_update:
        state, pose_trace, frame_nis = fused_frame(state, vns, swans, phis, actives, obs, live,
                                                   cfg=cfg, noise=noise, plain=plain)
    else:
        if cfg.fast_frame:
            state, pose_trace = frame_predict_heading(
                state, vns, swans, phis, actives, noise.qe, cfg.wheel_base, cfg.dt_controls,
                cfg.sigma_heading, cfg.switch_heading_known, return_pose_trace=True)
        else:
            pose_trace = torch.stack(poses)
        observed, nis = observation_step(
            state, obs, noise.re, association_known=cfg.switch_association_known,
            batch=cfg.switch_batch_update, gate_reject=cfg.gate_reject,
            gate_augment=cfg.gate_augment, return_nis=True, plain=plain)
        state = _freeze(~live, state, observed)
        frame_nis = torch.where(live, nis, 0.0)
    zeros = torch.zeros((s_steps - 1,), dtype=torch.float32, device=x_true.device)
    outs = SimOutputs(
        x_true=torch.stack(x_trues),
        x_est=torch.cat([pose_trace[:-1], state.x[None, :3]]),
        done=torch.stack(dones),
        n_active=torch.cat([n_active.expand(s_steps - 1), state.n_active[None]]),
        consistency=torch.cat([zeros, frame_nis[None]]),
    )
    return EKFSimCarry(steer=st, x_true=x_true, state=state,
                       step_in_frame=torch.zeros_like(carry.step_in_frame)), outs


def run_ekf_slam(
    world: World,
    cfg: SlamConfig,
    generator: torch.Generator | None = None,
    n_steps: int = 25_000,
    init_state: EKFState | None = None,
    *,
    ctrl_noise: torch.Tensor | None = None,
    obs_noise: torch.Tensor | None = None,
    plain: bool = False,
):
    """The full EKF-SLAM valet-loop simulation on the world's device
    (reference test/main.cpp:89-201): ``ekf_frame_step`` over the frames,
    ``n_steps`` rounded up to whole frames.  ``init_state`` replaces the
    empty map of ``cfg.max_landmarks`` slots.

    The noise is ``ctrl_noise`` (n_frames, S, 2) and ``obs_noise``
    (n_frames, num_landmarks, 2) standard-normal draws where given (a
    parity test passes the reference's own), else drawn from ``generator``
    on the world's device.  ``plain=True`` runs every kernel's plain
    PyTorch version.  Returns ``(final EKFSimCarry, SimOutputs)``.
    """
    device = world.landmarks.device
    interval = cfg.observe_interval
    n_frames = (n_steps + interval - 1) // interval
    if ctrl_noise is None:
        ctrl_noise = torch.randn((n_frames, interval, 2), generator=generator, device=device)
    if obs_noise is None:
        obs_noise = torch.randn((n_frames, world.num_landmarks, 2), generator=generator,
                                device=device)
    noise = make_noise(cfg, "ekf", device)
    carry = EKFSimCarry(
        steer=init_steer_state(cfg.number_loops, device),
        x_true=torch.zeros((3,), dtype=torch.float32, device=device),
        state=(init_state if init_state is not None
               else empty_state(cfg.max_landmarks, world.num_landmarks, device=device)),
        step_in_frame=torch.zeros((), dtype=torch.int64, device=device),
    )
    outs = _outs_like(n_frames * interval, device)
    frames = SimOutputs(*(o.view(n_frames, interval, *o.shape[1:]) for o in outs))
    for f in range(n_frames):
        carry, out = ekf_frame_step(carry, (ctrl_noise[f], obs_noise[f]), cfg=cfg, world=world,
                                    noise=noise, plain=plain)
        for dst, src in zip(frames, out):
            dst[f] = src
    return carry, outs


class PFSimCarry(NamedTuple):
    steer: SteerState
    x_true: torch.Tensor               # (3,) ground-truth pose
    ens: pf_mod.ParticleEnsemble
    step_in_frame: torch.Tensor        # () int64 control steps since the last observation


class PFDraws(NamedTuple):
    """The draws of one PF frame (``pf_frame_step``) or one control step
    (``pf_sim_step``), standard normal but the resampling's uniforms; the
    reference draws them from one key (runner/loop.py:562, :638)."""

    ctrl: torch.Tensor      # (S, 2) the frame's odometry noise; (2,) one step's
    obs: torch.Tensor       # (num_landmarks, 2) the returns' noise
    step: pf_mod.ObservationDraws


def draw_pf(generator, cfg: SlamConfig, n_landmarks: int, device, per_step: bool = False) -> PFDraws:
    """One frame's draws (one control step's with ``per_step``) from
    ``generator`` on ``device``."""
    n = cfg.num_particles

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=device)

    stratified = cfg.pf_resample_kind != "systematic"
    return PFDraws(
        ctrl=normal(2) if per_step else normal(cfg.observe_interval, 2),
        obs=normal(n_landmarks, 2),
        step=pf_mod.ObservationDraws(
            prop=normal(n, 3), samp=normal(n, 3),
            res_u=torch.rand((n,) if stratified else (), generator=generator, device=device),
            rough=normal(n, 3) if cfg.pf_roughening > 0.0 else None),
    )


def _pf_observe(ens, obs: CompactObs, cfg: SlamConfig, noise: NoiseCovs, draws, resample_fn):
    return pf_mod.observation_step(
        ens, obs, noise.re, draws, num_effective=cfg.num_effective,
        sample_proposal_on=cfg.switch_sample_proposal, resample_on=cfg.switch_resample,
        proposal_relinearize=cfg.proposal_relinearize, resample_kind=cfg.pf_resample_kind,
        roughening=cfg.pf_roughening, resample_fn=resample_fn)


def pf_sim_step(carry: PFSimCarry, draws: PFDraws, *, cfg: SlamConfig, world: World,
                noise: NoiseCovs, resample_fn=None):
    """One control step of FastSLAM 2.0 (reference test/main.cpp:255-333):
    truth and odometry, each particle's predict and heading update, and
    on every ``observe_interval``-th step the observation step; the
    ensemble freezes once the course is done.  Outputs the weighted mean
    pose and Neff every step.  Returns ``(carry, SimOutputs of this
    step)``."""
    was_done = carry.steer.done
    st, x_true, vn, swan = _advance_truth(carry.steer, carry.x_true, world, cfg, draws.ctrl)
    ens = pf_mod.predict(carry.ens, vn, swan, noise.qe, cfg.wheel_base, cfg.dt_controls)
    if cfg.switch_heading_known:
        ens = pf_mod.observe_heading(ens, x_true[2], cfg.sigma_heading)
    step_in_frame = carry.step_in_frame + 1
    do_obs = (step_in_frame >= cfg.observe_interval) & ~st.done
    step_in_frame = torch.where(do_obs, 0, step_in_frame)
    # A step without an observation masks every return: the observation
    # step then leaves the ensemble as it is, bit for bit.
    obs = _sense(x_true, world, cfg, draws.obs)
    ens = _pf_observe(ens, obs._replace(mask=obs.mask & do_obs), cfg, noise, draws.step,
                      resample_fn)
    ens = pf_mod.ParticleEnsemble(*(torch.where(was_done, o, n) for o, n in zip(carry.ens, ens)))
    w = pf_mod.normalized_weights(ens)
    out = SimOutputs(x_true=x_true, x_est=pf_mod.weighted_mean_pose(w, ens.pose), done=st.done,
                     n_active=ens.n_active, consistency=pf_mod.effective_count(w))
    return PFSimCarry(steer=st, x_true=x_true, ens=ens, step_in_frame=step_in_frame), out


def pf_frame_step(carry: PFSimCarry, draws: PFDraws, *, cfg: SlamConfig, world: World,
                  noise: NoiseCovs, resample_fn=None):
    """One observation frame of FastSLAM 2.0: ``observe_interval`` predict
    and heading sub-steps (only the poses and their covariances change;
    they freeze once the course is done), then one observation step
    unless the course is done.  On the inner sub-steps ``x_est`` is the
    weighted mean pose and ``n_active`` the map before the observation;
    the last sub-step carries the mean pose, map size and Neff after it
    (``consistency``, 0 on the inner sub-steps).  Returns ``(carry,
    SimOutputs of the frame's S steps)``."""
    s_steps = cfg.observe_interval
    st, x_true, ens = carry.steer, carry.x_true, carry.ens
    x_trues, dones, poses = [], [], []
    for k in range(s_steps):
        was_done = st.done
        st, x_true, vn, swan = _advance_truth(st, x_true, world, cfg, draws.ctrl[k])
        new = pf_mod.predict(ens, vn, swan, noise.qe, cfg.wheel_base, cfg.dt_controls)
        if cfg.switch_heading_known:
            new = pf_mod.observe_heading(new, x_true[2], cfg.sigma_heading)
        ens = ens._replace(pose=torch.where(was_done, ens.pose, new.pose),
                           pose_cov=torch.where(was_done, ens.pose_cov, new.pose_cov))
        x_trues.append(x_true)
        dones.append(st.done)
        poses.append(ens.pose)
    n_active = ens.n_active
    w = pf_mod.normalized_weights(ens)
    # The course's end masks every return: the observation step then
    # leaves the ensemble as it is, bit for bit.
    obs = _sense(x_true, world, cfg, draws.obs)
    ens = _pf_observe(ens, obs._replace(mask=obs.mask & ~st.done), cfg, noise, draws.step,
                      resample_fn)
    w_obs = pf_mod.normalized_weights(ens)
    zeros = torch.zeros((s_steps - 1,), dtype=torch.float32, device=x_true.device)
    outs = SimOutputs(
        x_true=torch.stack(x_trues),
        x_est=torch.cat([pf_mod.weighted_mean_pose(w, torch.stack(poses[:-1])),
                         pf_mod.weighted_mean_pose(w_obs, ens.pose)[None]]),
        done=torch.stack(dones),
        n_active=torch.cat([n_active.expand(s_steps - 1), ens.n_active[None]]),
        consistency=torch.cat([zeros, pf_mod.effective_count(w_obs)[None]]),
    )
    return PFSimCarry(steer=st, x_true=x_true, ens=ens,
                      step_in_frame=torch.zeros_like(carry.step_in_frame)), outs


def run_pf_slam(world: World, cfg: SlamConfig, generator: torch.Generator | None = None,
                n_steps: int = 25_000, *, draws=None, resample_fn=None):
    """The full FastSLAM 2.0 valet-loop simulation on the world's device
    (reference test/main.cpp:204-335), ``cfg.num_particles`` particles of
    ``cfg.max_landmarks`` map slots.

    With ``cfg.fast_frame`` (the default) ``pf_frame_step`` runs over the
    frames, ``n_steps`` rounded up to whole frames: the carry has advanced
    to the frame boundary, the outputs are trimmed to ``n_steps`` rows;
    else ``pf_sim_step`` over the control steps.  ``draws(i)`` gives
    frame (or step) ``i``'s ``PFDraws`` where given (a parity test passes
    the reference's own); otherwise each frame's are drawn from
    ``generator`` on the world's device as it runs (``draw_pf``).
    ``resample_fn`` is ``observation_step``'s hook.  Returns
    ``(final PFSimCarry, SimOutputs)``."""
    device = world.landmarks.device
    noise = make_noise(cfg, "pf", device)
    carry = PFSimCarry(
        steer=init_steer_state(cfg.number_loops, device),
        x_true=torch.zeros((3,), dtype=torch.float32, device=device),
        ens=pf_mod.init_ensemble(cfg.num_particles, cfg.max_landmarks, world.num_landmarks,
                                 device=device),
        step_in_frame=torch.zeros((), dtype=torch.int64, device=device),
    )
    if draws is None:
        def draws(_):
            return draw_pf(generator, cfg, world.num_landmarks, device,
                           per_step=not cfg.fast_frame)
    kw = dict(cfg=cfg, world=world, noise=noise, resample_fn=resample_fn)
    if not cfg.fast_frame:
        outs = _outs_like(n_steps, device)
        for t in range(n_steps):
            carry, out = pf_sim_step(carry, draws(t), **kw)
            for dst, src in zip(outs, out):
                dst[t] = src
        return carry, outs
    interval = cfg.observe_interval
    n_frames = (n_steps + interval - 1) // interval
    outs = _outs_like(n_frames * interval, device)
    frames = SimOutputs(*(o.view(n_frames, interval, *o.shape[1:]) for o in outs))
    for f in range(n_frames):
        carry, out = pf_frame_step(carry, draws(f), **kw)
        for dst, src in zip(frames, out):
            dst[f] = src
    return carry, SimOutputs(*(o[:n_steps] for o in outs))
