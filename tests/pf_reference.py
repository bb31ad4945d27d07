"""The JAX package's FastSLAM 2.0 runs, as the port's parity data.

``run_pf_slam(world, cfg, key, n_steps)`` draws its noise from one key
schedule.  Per frame (``pf_frame_step``, conan_slam_tpu/runner/loop.py:638,
:644; the observation step filters/pf/__init__.py:58, :82; proposal.py:144;
resample.py:27, :37, :62, :100):

    key, k_obs, k_step = split(carry_key, 3)
    ctrl[k] = normal(fold_in(key, k), (2,))            # sub-step k
    obs     = normal(k_obs, (NL, 2))                   # every landmark's return
    k_prop, k_res, k_samp = split(k_step, 3)
    prop[i] = normal(split(k_prop, N)[i], (3,))        # the proposal's samples
    k_idx, k_rough = split(k_res)
    u       = uniform(k_idx, (N,))  (systematic: ())   # the resampling strata
    rough   = normal(k_rough, (N, 3))                  # the roughening
    samp[i] = normal(split(k_samp, N)[i], (3,))        # the prior samples
    carry_key = key

and per control step (``pf_sim_step``, :562) ``key, k_ctrl, k_obs, k_step =
split(carry_key, 4)``, ``ctrl = normal(k_ctrl, (2,))``, the rest as above.
``pf_draws`` rebuilds them as the port's ``run_pf_slam`` takes them.

``python tests/pf_reference.py`` writes ``conan_slam_tpu_torch/sim/data/
pf_key1.npz``: the draws of ``run_pf_slam(default_world(),
SlamConfig(num_particles=N), PRNGKey(1), 1_200)`` at N = 16 and 100 and
the runs' ``x_true``, ``x_est``, ``n_active`` and Neff per step (a tier-1
test rebuilds and compares it; ``chip_smoke.py`` holds the card's runs to
it).
"""

from __future__ import annotations

import os
import sys

import numpy as np

KEY = 1
N_STEPS = 1_200
PARTICLES = (16, 100)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "conan_slam_tpu_torch", "sim", "data", "pf_key1.npz")
FIELDS = ("ctrl", "obs", "prop", "res_u", "rough", "samp")


def pf_draws(key, cfg, n_units: int, n_landmarks: int) -> dict:
    """The draws of ``n_units`` frames (``cfg.fast_frame``) or control steps
    of the JAX ``run_pf_slam`` from ``key``: float32 numpy arrays under
    ``FIELDS``, each with a leading axis of ``n_units`` (``rough`` only
    where ``cfg.pf_roughening`` > 0)."""
    import jax
    import jax.numpy as jnp

    n = cfg.num_particles

    def per_particle(k):
        return jax.vmap(lambda kk: jax.random.normal(kk, (3,), jnp.float32))(
            jax.random.split(k, n))

    def step(k_step):
        k_prop, k_res, k_samp = jax.random.split(k_step, 3)
        k_idx, k_rough = jax.random.split(k_res)
        shape = () if cfg.pf_resample_kind == "systematic" else (n,)
        return (per_particle(k_prop), jax.random.uniform(k_idx, shape, jnp.float32),
                jax.random.normal(k_rough, (n, 3), jnp.float32), per_particle(k_samp))

    def frame(carry_key, _):
        key, k_obs, k_step = jax.random.split(carry_key, 3)
        ctrl = jnp.stack([jax.random.normal(jax.random.fold_in(key, k), (2,), jnp.float32)
                          for k in range(cfg.observe_interval)])
        return key, (ctrl, jax.random.normal(k_obs, (n_landmarks, 2), jnp.float32),
                     *step(k_step))

    def control_step(carry_key, _):
        key, k_ctrl, k_obs, k_step = jax.random.split(carry_key, 4)
        return key, (jax.random.normal(k_ctrl, (2,), jnp.float32),
                     jax.random.normal(k_obs, (n_landmarks, 2), jnp.float32), *step(k_step))

    _, arrays = jax.lax.scan(frame if cfg.fast_frame else control_step, key, None,
                             length=n_units)
    out = {k: np.asarray(a) for k, a in zip(FIELDS, arrays)}
    if not cfg.pf_roughening > 0.0:
        del out["rough"]
    return out


def torch_draws(arrays: dict, device="cpu"):
    """``draws(i)`` for the port's ``run_pf_slam`` from ``pf_draws``'s
    arrays (or ``file_draws``')."""
    import torch

    from conan_slam_tpu_torch.filters.pf import ObservationDraws
    from conan_slam_tpu_torch.runner.loop import PFDraws

    t = {k: torch.as_tensor(np.ascontiguousarray(a)).to(device) for k, a in arrays.items()}

    def draws(i: int) -> PFDraws:
        return PFDraws(ctrl=t["ctrl"][i], obs=t["obs"][i], step=ObservationDraws(
            prop=t["prop"][i], res_u=t["res_u"][i], samp=t["samp"][i],
            rough=t["rough"][i] if "rough" in t else None))

    return draws


def file_draws(data, n: int) -> dict:
    """The committed file's draws of the N = ``n`` run, as ``pf_draws``'s."""
    return {k: data[k] if k in ("ctrl", "obs") else data[f"{k}_{n}"]
            for k in FIELDS if k in ("ctrl", "obs") or f"{k}_{n}" in data}


def reference_units(key, cfg, n_units: int) -> list:
    """The JAX ``pf_frame_step`` (``cfg.fast_frame``) or ``pf_sim_step``,
    jitted, over ``n_units`` frames or steps from ``key`` on the default
    world: each unit's ``(carry before it, its SimOutputs, its resampling)``
    as numpy arrays, for a port step from the reference's own state.  The
    resampling is ``None`` where the unit ran none (nothing known), else
    ``{"w", "neff", "idx"}``: the normalised weights, Neff and ancestor
    indices the reference's ``resample`` computed, read from inside the
    jitted step with a debug callback (the step's results are bit for bit
    those of the scan in ``run_pf_slam``)."""
    import functools
    import importlib

    import jax
    import jax.numpy as jnp

    from conan_slam_tpu.filters import pf as jpf
    from conan_slam_tpu.runner import loop
    from conan_slam_tpu.sim.steering import init_steer_state
    from conan_slam_tpu.sim.world import default_world

    jres = importlib.import_module("conan_slam_tpu.filters.pf.resample")
    seen: dict = {}

    def record(name, fn):
        def wrapped(*a):
            out = fn(*a)
            vals = {name: out, "w": a[1]} if name == "idx" else {name: out}
            jax.debug.callback(lambda v: seen.update({k: np.asarray(x) for k, x in v.items()}),
                               vals)
            return out
        return wrapped

    world = default_world()
    carry = loop.PFSimCarry(
        steer=init_steer_state(cfg.number_loops), x_true=jnp.zeros((3,), jnp.float32),
        ens=jpf.init_ensemble(cfg.num_particles, cfg.max_landmarks, world.num_landmarks),
        step_in_frame=jnp.int32(0), key=key)
    saved = {k: getattr(jres, k) for k in ("stratified_indices", "systematic_indices",
                                            "effective_count")}
    jres.effective_count = record("neff", saved["effective_count"])
    jres.stratified_indices = record("idx", saved["stratified_indices"])
    jres.systematic_indices = record("idx", saved["systematic_indices"])
    try:
        step = jax.jit(functools.partial(
            loop.pf_frame_step if cfg.fast_frame else loop.pf_sim_step, cfg=cfg, world=world,
            noise=loop.make_noise(cfg, "pf")))
        units = []
        with jax.default_matmul_precision("highest"):
            for _ in range(n_units):
                before = jax.tree_util.tree_map(np.asarray, carry)
                seen.clear()
                carry, outs = step(carry, None)
                outs = jax.tree_util.tree_map(np.asarray, outs)
                jax.effects_barrier()
                units.append((before, outs, dict(seen) if "idx" in seen else None))
    finally:
        for k, fn in saved.items():
            setattr(jres, k, fn)
    return units


def torch_carry(carry, device="cpu"):
    """A JAX ``PFSimCarry`` (numpy leaves, ``reference_units``') as the
    port's."""
    import torch

    from conan_slam_tpu_torch.filters.pf import ParticleEnsemble
    from conan_slam_tpu_torch.runner.loop import PFSimCarry
    from conan_slam_tpu_torch.sim.steering import SteerState

    def t(a):
        a = np.asarray(a)
        return torch.as_tensor(a.astype(np.int64) if a.dtype == np.int32 else a.copy()).to(device)

    return PFSimCarry(steer=SteerState(*(t(a) for a in carry.steer)), x_true=t(carry.x_true),
                      ens=ParticleEnsemble(*(t(a) for a in carry.ens)),
                      step_in_frame=t(carry.step_in_frame))


def reference_arrays(n_steps: int = N_STEPS, seed: int = KEY) -> dict:
    """The draws and the JAX runs at ``PARTICLES``: the arrays
    ``pf_key1.npz`` holds (the control and return draws, and x_true, are
    the same at every N)."""
    import jax

    from conan_slam_tpu.config import SlamConfig
    from conan_slam_tpu.runner.loop import run_pf_slam
    from conan_slam_tpu.sim.world import default_world

    world, key = default_world(), jax.random.PRNGKey(seed)
    out: dict = {}
    for n in PARTICLES:
        cfg = SlamConfig(num_particles=n)
        n_frames = (n_steps + cfg.observe_interval - 1) // cfg.observe_interval
        d = pf_draws(key, cfg, n_frames, world.num_landmarks)
        _, outs = run_pf_slam(world, cfg, key, n_steps=n_steps)
        for k in ("ctrl", "obs"):
            assert k not in out or np.array_equal(out[k], d[k])
            out[k] = d.pop(k)
        x_true = np.asarray(outs.x_true, np.float32)
        assert "x_true" not in out or np.array_equal(out["x_true"], x_true)
        out["x_true"] = x_true
        out.update({f"{k}_{n}": a for k, a in d.items()})
        out[f"x_est_{n}"] = np.asarray(outs.x_est, np.float32)
        out[f"n_active_{n}"] = np.asarray(outs.n_active, np.int8)
        out[f"neff_{n}"] = np.asarray(outs.consistency, np.float32)
    return out


def main() -> None:
    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=1")
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    np.savez_compressed(DATA, **reference_arrays())
    print(DATA, os.path.getsize(DATA), "bytes")


if __name__ == "__main__":
    main()
