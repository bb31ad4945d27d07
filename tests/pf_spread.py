"""How far the JAX package's FastSLAM 2.0 run is from itself: its jitted
``run_pf_slam`` against the same function run eagerly (``jax.disable_jit``)
on the same key, beside the port's run on the same draws, at N = 16 over
600 steps of the default world from PRNGKey(1) (tests/test_torch_run_pf.py's
case).

    python tests/pf_spread.py [n_steps] [n_frames]

Prints, for the whole run, each pair's largest |x_est difference| and the
first step past 1e-3 m, and each run's ATE; then, frame by frame from the
jitted run's own carry (the first ``n_frames`` frames), the eager frame's
and the port's distance from the jitted frame in x_est, the log weights,
the feature means and Neff.  Not part of tier 1 (the eager run takes ~90 s).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv: list[str]) -> None:
    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=1")
    sys.path.insert(0, os.path.dirname(HERE))
    sys.path.insert(0, HERE)
    import jax
    import jax.numpy as jnp
    import torch

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(2)
    from conan_slam_tpu.config import SlamConfig as JSlamConfig
    from conan_slam_tpu.runner import loop as jloop
    from conan_slam_tpu.sim.world import default_world as j_default_world
    from conan_slam_tpu_torch.config import SlamConfig
    from conan_slam_tpu_torch.runner import loop
    from conan_slam_tpu_torch.sim.world import default_world
    from pf_reference import pf_draws, reference_units, torch_carry, torch_draws

    n_steps = int(argv[0]) if argv else 600
    n_frames = int(argv[1]) if len(argv) > 1 else 20
    jcfg, cfg = JSlamConfig(num_particles=16), SlamConfig(num_particles=16)
    key, jworld = jax.random.PRNGKey(1), j_default_world()
    s = jcfg.observe_interval

    _, jit = jloop.run_pf_slam(jworld, jcfg, key, n_steps)
    t0 = time.perf_counter()
    with jax.disable_jit():
        _, eager = jloop.run_pf_slam.__wrapped__(jworld, jcfg, key, n_steps)
    eager_s = time.perf_counter() - t0
    draws = torch_draws(pf_draws(key, jcfg, -(-n_steps // s), jworld.num_landmarks))
    world = default_world(device="cpu")
    _, port = loop.run_pf_slam(world, cfg, None, n_steps, draws=draws)
    runs = {"jit": np.asarray(jit.x_est), "eager": np.asarray(eager.x_est),
            "port": port.x_est.numpy()}
    x_true = np.asarray(jit.x_true)
    print(f"whole run, N = 16, {n_steps} steps (eager run {eager_s:.0f} s):")
    for name, x in runs.items():
        ate = float(np.sqrt((((x - x_true)[:, :2]) ** 2).sum(1).mean()))
        print(f"  ATE {name}: {ate:.4f} m")
    for a, b in (("eager", "jit"), ("port", "jit"), ("port", "eager")):
        d = np.abs(runs[a] - runs[b]).max(1)
        past = np.flatnonzero(d > 1e-3)
        print(f"  |x_est {a} - {b}|: max {d.max():.3e} m, first step past 1e-3 m: "
              f"{past[0] if past.size else None}")

    units = reference_units(key, jcfg, n_frames + 1)
    noise, jnoise = loop.make_noise(cfg, "pf", "cpu"), jloop.make_noise(jcfg, "pf")
    worst = {"eager": {}, "port": {}}
    print(f"frame by frame from the jitted run's carry (frames 0-{n_frames - 1}): "
          "max |difference from the jitted frame|")
    for f in range(n_frames):
        before, ref, _ = units[f]
        after = units[f + 1][0]
        with jax.disable_jit():
            ec, eo = jloop.pf_frame_step(jax.tree_util.tree_map(jnp.asarray, before), None,
                                         cfg=jcfg, world=jworld, noise=jnoise)
        pc, po = loop.pf_frame_step(torch_carry(before), draws(f), cfg=cfg, world=world,
                                    noise=noise)
        got = {"eager": (np.asarray(eo.x_est), np.asarray(ec.ens.log_w), np.asarray(ec.ens.xf),
                         np.asarray(eo.consistency)),
               "port": (po.x_est.numpy(), pc.ens.log_w.numpy(), pc.ens.xf.numpy(),
                        po.consistency.numpy())}
        want = (ref.x_est, after.ens.log_w, after.ens.xf, ref.consistency)
        row = []
        for name, vals in got.items():
            d = dict(x_est=np.abs(vals[0] - want[0]).max(), log_w=np.abs(vals[1] - want[1]).max(),
                     xf=np.abs(vals[2] - want[2]).max(),
                     neff=float(np.abs(vals[3][-1] - want[3][-1]) / want[3][-1]))
            worst[name] = {k: max(v, worst[name].get(k, 0.0)) for k, v in d.items()}
            row.append(f"{name}: " + ", ".join(f"{k} {v:.2e}" for k, v in d.items()))
        print(f"  frame {f}: " + "; ".join(row), flush=True)
    for name, d in worst.items():
        print(f"  largest, {name}: " + ", ".join(f"{k} {v:.3e}" for k, v in d.items()))


if __name__ == "__main__":
    main(sys.argv[1:])
