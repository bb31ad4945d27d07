"""The multi-rank dry run (port of ``__graft_entry__.dryrun_multichip``):
every sharded kernel of the runtime once over a mesh of ``n`` ranks.

    python -m conan_slam_tpu_torch.parallel.dryrun --ranks 4 [--device cpu]

Shardings exercised, as the reference's:
  - ``state`` axis: the row-block-sharded joint covariance; predict,
    heading, the Schur-style batched measurement update and the masked
    augment, then the runner's whole frame step on both gain wires;
  - ``particles`` axis: the ensemble sharded like a batch; predict,
    heading and the whole observation block (proposal, 2x2 feature
    updates, the sharded resample, founding).
With four or more ranks (an even number) the mesh is {"state": 2,
"particles": n / 2}, else {"state": n, "particles": 1}.  The defaults are
the reference's (cap 256, so D ~ 0.5k; 16,384 particles);
``DRYRUN_CAP`` and ``DRYRUN_PARTICLES`` scale them.  On the card every
rank runs on its card (several ranks on one card over gloo).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from conan_slam_tpu_torch.parallel.mesh import PARTICLE_AXIS, STATE_AXIS


def mesh_axes(n: int) -> dict:
    """The dry run's mesh over ``n`` ranks (``__graft_entry__.py:63-66``)."""
    if n >= 4 and n % 2 == 0:
        return {STATE_AXIS: 2, PARTICLE_AXIS: n // 2}
    return {STATE_AXIS: n, PARTICLE_AXIS: 1}


def dryrun_rank(device, n: int, cap: int, n_particles: int) -> dict:
    """One rank of the dry run (a ``parallel.launch`` entry point): every
    sharded kernel once; returns what the summary prints and the checks."""
    from conan_slam_tpu_torch.config import SlamConfig
    from conan_slam_tpu_torch.filters import pf as pf_mod
    from conan_slam_tpu_torch.filters.common import CompactObs
    from conan_slam_tpu_torch.models import sensor
    from conan_slam_tpu_torch.parallel import dist_ekf, dist_pf
    from conan_slam_tpu_torch.parallel.dist_runner import DistEKFCarry, dist_ekf_frame_step
    from conan_slam_tpu_torch.parallel.mesh import make_mesh
    from conan_slam_tpu_torch.runner.loop import make_noise
    from conan_slam_tpu_torch.sim.steering import init_steer_state
    from conan_slam_tpu_torch.sim.world import default_world

    axes = mesh_axes(n)
    mesh = make_mesh(axes, device)

    # --- the EKF state with an active map (the reference's inputs) ---
    num_ids, nz = cap + cap // 2, 16
    d = 3 + 2 * cap
    rng = np.random.default_rng(0)
    feats = rng.uniform(-300.0, 300.0, size=(cap, 2)).astype(np.float32)
    x0 = np.zeros((d,), np.float32)
    x0[3:] = feats.reshape(-1)
    a = rng.normal(size=(d, d)).astype(np.float32) * 0.05
    p0 = a @ a.T + np.eye(d, dtype=np.float32) * 0.1
    t = lambda v: torch.as_tensor(v).to(device)   # noqa: E731
    q = t(np.diag([0.18, 0.0006]).astype(np.float32))
    r = t(np.diag([0.08, 0.0024]).astype(np.float32))
    zp, _, _ = sensor.observe(t(x0[:3]), t(feats[:nz]))
    z = zp + t(rng.normal(size=(nz, 2)).astype(np.float32) * 0.01)
    slots = torch.arange(nz, device=device)
    mask = torch.ones((nz,), dtype=torch.bool, device=device)

    # --- the particle ensemble (divisible by the particle axis) ---
    n_part = max(axes[PARTICLE_AXIS], n_particles // axes[PARTICLE_AXIS] * axes[PARTICLE_AXIS])
    ens = pf_mod.init_ensemble(n_part, cap, num_ids, device=device)
    # Half the observed landmarks in every particle's map, so the
    # observation step runs both branches: the proposal and the 2x2
    # updates (known ids) and founding (unknown ids).
    n_known = nz // 2
    table = torch.full((num_ids,), -1, dtype=torch.int64, device=device)
    table[:n_known] = torch.arange(n_known, device=device)
    xf, pfc = ens.xf.clone(), ens.pf.clone()
    xf[:, :n_known] = t(feats[:n_known])
    pfc[:, :n_known] = torch.eye(2, device=device) * 0.5
    ens = ens._replace(table=table, n_active=torch.tensor(n_known, device=device), xf=xf, pf=pfc)

    xs, ps = dist_ekf.shard_state(mesh, t(x0), t(p0))
    ens_l = dist_pf.shard_ensemble(mesh, ens)
    new_ids = t(np.arange(cap, cap + nz, dtype=np.int64) % num_ids)
    new_mask = torch.zeros((nz,), dtype=torch.bool, device=device)
    new_mask[0] = True
    ekf_table = torch.full((num_ids,), -1, dtype=torch.int64, device=device)
    n_active = torch.tensor(cap // 2, device=device)

    # EKF path: predict -> heading -> Schur-sharded batch update -> augment.
    xs, ps = dist_ekf.sharded_predict(mesh, xs, ps, 80.0, 0.05, q, 73.0, 0.01)
    xs, ps = dist_ekf.sharded_observe_heading(mesh, xs, ps, 0.02, 0.001)
    xs, ps = dist_ekf.sharded_observation_update(mesh, xs, ps, z, slots, mask, r, capacity=cap)
    xs, ps, _, _ = dist_ekf.sharded_augment(mesh, xs, ps, z, new_ids, new_mask, r, n_active,
                                            ekf_table)
    # PF path: the whole frame under particle sharding.
    ens_l = pf_mod.predict(ens_l, t(np.float32(80.0)), t(np.float32(0.05)), q, 73.0, 0.01)
    ens_l = pf_mod.observe_heading(ens_l, 0.02, 0.001)
    pf_mask = torch.ones((nz,), dtype=torch.bool, device=device)
    pf_mask[nz - 1] = False
    pf_obs = CompactObs(z=z, ids=torch.arange(nz, device=device), mask=pf_mask)
    gen = torch.Generator(device=device).manual_seed(0)       # every rank alike
    draws = pf_mod.ObservationDraws(
        prop=torch.randn((n_part, 3), generator=gen, device=device),
        res_u=torch.rand((n_part,), generator=gen, device=device), rough=None,
        samp=torch.randn((n_part, 3), generator=gen, device=device))
    ens_l = dist_pf.sharded_observation_step(mesh, ens_l, pf_obs, r, draws,
                                             num_effective=float(n_part),
                                             sample_proposal_on=True, resample_on=True)
    finite = {"ekf": bool(torch.isfinite(xs).all() and torch.isfinite(ps).all()),
              "pf": bool(torch.isfinite(ens_l.pose).all())}

    # The runner's whole frame step on the same mesh, both gain wires.
    cfg = SlamConfig(max_landmarks=cap, max_obs=nz)
    world = default_world(device)
    carry = DistEKFCarry(steer=init_steer_state(cfg.number_loops, device),
                         x_true=torch.zeros((3,), device=device), x=xs, p=ps,
                         n_active=torch.zeros((), dtype=torch.int64, device=device),
                         table=torch.full((world.num_landmarks,), -1, dtype=torch.int64,
                                          device=device))
    draws = (torch.randn((cfg.observe_interval, 2), generator=gen, device=device),
             torch.randn((world.num_landmarks, 2), generator=gen, device=device))
    for wire in ("f32", "i16"):
        carry2, outs = dist_ekf_frame_step(carry, draws, cfg=cfg.replace(dist_gain_wire=wire),
                                           world=world, noise=make_noise(cfg, "ekf", device),
                                           mesh=mesh)
        finite[wire] = bool(torch.isfinite(carry2.x).all() and torch.isfinite(outs.x_est).all())
    return {"mesh": dict(mesh.shape), "d_padded": xs.shape[0] * mesh.axis(STATE_AXIS).size,
            "particles": n_part, "finite": finite}


def dryrun_multichip(n: int, device: str = "cuda", pool=None) -> dict:
    """The dry run over ``n`` ranks (on ``pool``, a ``RankPool`` of ``n``
    ranks, where given); prints the reference's summary line and returns
    rank 0's record.  Raises if any value is non-finite."""
    from conan_slam_tpu_torch.parallel import launch

    cap = int(os.environ.get("DRYRUN_CAP", "256"))
    n_particles = int(os.environ.get("DRYRUN_PARTICLES", "16384"))
    if pool is None:
        results = launch.run(dryrun_rank, n, n, cap, n_particles, device=device)
    else:
        results = pool.run(dryrun_rank, n, cap, n_particles)
    bad = [(r, k) for r, res in enumerate(results) for k, ok in res["finite"].items() if not ok]
    if bad:
        raise RuntimeError(f"dry run: non-finite values (rank, path): {bad}")
    res = results[0]
    print(f"dryrun_multichip ok: mesh={res['mesh']}, D_padded={res['d_padded']}, "
          f"particles={res['particles']}, "
          f"frame_step=fused-fastframe (ONE sharded frame function + augment), "
          f"pf_frame=full (proposal+feature-update+ring-resample+founding)", flush=True)
    return res


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--ranks", type=int, default=4, help="ranks of the mesh (default 4)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where the ranks run (default: the card, every rank on it)")
    opts = parser.parse_args(argv)
    dryrun_multichip(opts.ranks, opts.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
