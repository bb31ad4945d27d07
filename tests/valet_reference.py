"""The JAX package's seed-42 valet run, as the port's parity data.

``run_ekf_slam(default_world(), SlamConfig(), PRNGKey(42), 25_000)`` draws
its noise inside the frame scan from one key schedule
(conan_slam_tpu/runner/loop.py:741, :758, :793; sim/sensor_sim.py:56-70):

    key, k_obs = split(carry_key)            # per frame
    ctrl[f, k] = normal(fold_in(key, k), (2,))   # sub-step k
    obs[f]     = normal(k_obs, (NL, 2))      # every landmark's return
    carry_key  = key

``frame_draws`` rebuilds those draws, which the port's ``run_ekf_slam``
takes as ``ctrl_noise`` / ``obs_noise``.  ``reference_arrays`` runs the JAX
package with known and with gated association and returns the draws and
both runs' trajectories; ``config2_arrays`` does the same for BASELINE
config 2's gated run from PRNGKey(0), keeping of each frame's 500 returns'
draws only those of the landmarks within 5 m of the sensor's field of view
(at most 50; no other return reaches the filter).
``python tests/valet_reference.py`` writes them to
``conan_slam_tpu_torch/sim/data/valet_seed42.npz`` and
``config2_key0.npz`` (tier-1 tests rebuild and compare them;
``chip_smoke.py`` holds the card's runs to them).
"""

from __future__ import annotations

import os
import sys

import numpy as np

SEED = 42
N_STEPS = 25_000
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "conan_slam_tpu_torch", "sim", "data", "valet_seed42.npz")
CONFIG2_DATA = os.path.join(REPO, "conan_slam_tpu_torch", "sim", "data", "config2_key0.npz")
FOV_MARGIN = 5.0   # m around the field of view whose landmarks' draws config2_key0.npz keeps


def frame_draws(key, n_frames: int, interval: int, n_landmarks: int):
    """The standard-normal draws of ``n_frames`` frames of the JAX
    ``run_ekf_slam`` from ``key``: ``(ctrl (n_frames, interval, 2),
    obs (n_frames, n_landmarks, 2))`` float32 numpy arrays."""
    import jax
    import jax.numpy as jnp

    def frame(carry_key, _):
        key, k_obs = jax.random.split(carry_key)
        ctrl = jnp.stack([jax.random.normal(jax.random.fold_in(key, k), (2,), jnp.float32)
                          for k in range(interval)])
        obs = jax.random.normal(k_obs, (n_landmarks, 2), jnp.float32)
        return key, (ctrl, obs)

    _, (ctrl, obs) = jax.lax.scan(frame, key, None, length=n_frames)
    return np.asarray(ctrl), np.asarray(obs)


def reference_arrays(n_steps: int = N_STEPS, seed: int = SEED) -> dict:
    """The draws and the JAX runs (known and gated association) on the
    default world: the arrays ``valet_seed42.npz`` holds."""
    import jax

    from conan_slam_tpu.config import SlamConfig
    from conan_slam_tpu.runner.loop import run_ekf_slam
    from conan_slam_tpu.sim.world import default_world

    world, cfg = default_world(), SlamConfig()
    key = jax.random.PRNGKey(seed)
    interval = cfg.observe_interval
    n_frames = (n_steps + interval - 1) // interval
    ctrl, obs = frame_draws(key, n_frames, interval, world.num_landmarks)
    out = {"ctrl": ctrl, "obs": obs}
    for name, known in (("known", True), ("gated", False)):
        _, outs = run_ekf_slam(world, cfg.replace(switch_association_known=known), key,
                               n_steps=n_steps)
        out[f"x_est_{name}"] = np.asarray(outs.x_est, np.float32)
        out[f"n_active_{name}"] = np.asarray(outs.n_active, np.int16)
        out[f"done_{name}"] = np.asarray(outs.done)
        if known:
            out["x_true"] = np.asarray(outs.x_true, np.float32)
    return out


def near_view(x_true, landmarks, max_range: float, margin: float = FOV_MARGIN):
    """(n, num_landmarks) bool: each landmark within ``margin`` of the
    semicircular field of view (sim/sensor_sim.py visible_mask) from each
    pose of ``x_true`` (n, 3)."""
    d = landmarks[None] - x_true[:, None, :2]
    ahead = d[..., 0] * np.cos(x_true[:, None, 2]) + d[..., 1] * np.sin(x_true[:, None, 2])
    r = max_range + margin
    return ((np.abs(d[..., 0]) < r) & (np.abs(d[..., 1]) < r) & (ahead > -margin)
            & ((d * d).sum(-1) < r * r))


def config2_arrays(n_steps: int = N_STEPS) -> dict:
    """BASELINE config 2 (random_world(PRNGKey(7), 500) on the default
    tour, gated, empty map, max_obs 64) through the JAX run_ekf_slam from
    PRNGKey(0): the control draws, each frame's draws of the landmarks near
    the field of view (ids, -1 padded, and values), the run's ATE and map
    size."""
    import jax

    from conan_slam_tpu.config import SlamConfig
    from conan_slam_tpu.runner import metrics
    from conan_slam_tpu.runner.loop import run_ekf_slam
    from conan_slam_tpu.sim.world import default_world, random_world

    world = random_world(jax.random.PRNGKey(7), 500)._replace(
        waypoints=default_world().waypoints)
    cfg = SlamConfig(max_landmarks=500, max_obs=64, switch_association_known=False)
    key = jax.random.PRNGKey(0)
    interval = cfg.observe_interval
    n_frames = (n_steps + interval - 1) // interval
    ctrl, obs = frame_draws(key, n_frames, interval, world.num_landmarks)
    carry, outs = run_ekf_slam(world, cfg, key, n_steps=n_steps)
    x_frame = np.asarray(outs.x_true)[interval - 1::interval]
    near = near_view(x_frame, np.asarray(world.landmarks), cfg.max_range)
    width = int(near.sum(1).max())
    ids = np.full((n_frames, width), -1, np.int16)
    vals = np.zeros((n_frames, width, 2), np.float32)
    for f in range(n_frames):
        (idx,) = np.nonzero(near[f])
        ids[f, :len(idx)] = idx
        vals[f, :len(idx)] = obs[f, idx]
    return {"ctrl": ctrl, "obs_ids": ids, "obs_vals": vals,
            "ate": np.float32(metrics.ate_rmse(outs.x_true, outs.x_est, ~outs.done)),
            "mapped": np.int32(carry.state.n_active)}


def main() -> None:
    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=1")
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    for path, make in ((DATA, reference_arrays), (CONFIG2_DATA, config2_arrays)):
        np.savez_compressed(path, **make())
        print(path, os.path.getsize(path), "bytes")


if __name__ == "__main__":
    main()
