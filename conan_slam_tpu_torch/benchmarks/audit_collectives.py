"""The collective bytes of one sharded EKF frame (port-side counterpart of
benchmarks/audit_collectives.py).

The reference reads its collectives from compiled HLO; here every
collective is an explicit call on a mesh axis, and the mesh records each
one (``Mesh.recording``): its logical bytes, which are what XLA's
collective of the same shape moves (an all-gather's or an all-reduce's
output, a permute's block), and the bytes of the buffer the transport was
handed (on one card over gloo an all-gather is an all-reduce over a
zero-filled (n, ...) buffer: n times the logical block).  Two frames of
``parallel.dist_runner.dist_ekf_frame_step`` are counted: the fused frame
(three collective rounds, then the augment) and, under
``fast_frame=False``, the legacy composition (S predict + heading
sub-steps, the batched update, the augment).  It checks the module's
O(m Dp) claim with the reference's bound and its quadratic guard.

    python -m conan_slam_tpu_torch.benchmarks.audit_collectives [--ranks 8]
        [--landmarks 512] [--obs 32] [--gain-wire f32|i16] [--device cpu]

The default shape is the reference's (8 ranks, 512 landmarks, 32
observations: Dp 1280, m 64).  The table goes to stdout, the verdict to
its last line as JSON; exit code 0 when both frames pass.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch


def audit_rank(device, n_landmarks: int, n_obs: int, gain_wire: str) -> dict:
    """One rank: one frame of each route from the empty map, recorded."""
    import torch.distributed as dist

    from conan_slam_tpu_torch.config import SlamConfig
    from conan_slam_tpu_torch.filters.ekf.state import init_state
    from conan_slam_tpu_torch.parallel import dist_ekf
    from conan_slam_tpu_torch.parallel.dist_runner import DistEKFCarry, dist_ekf_frame_step
    from conan_slam_tpu_torch.parallel.mesh import STATE_AXIS, make_mesh
    from conan_slam_tpu_torch.runner.loop import make_noise
    from conan_slam_tpu_torch.sim.steering import init_steer_state
    from conan_slam_tpu_torch.sim.world import default_world, random_world

    mesh = make_mesh({STATE_AXIS: dist.get_world_size()}, device)
    world = default_world(device)
    if n_landmarks > world.num_landmarks:
        # The shapes are what count: any world with as many landmarks.
        gen = torch.Generator(device=device).manual_seed(3)
        world = random_world(gen, n_landmarks, device=device)._replace(waypoints=world.waypoints)
    cfg = SlamConfig(max_landmarks=n_landmarks, max_obs=n_obs, dist_gain_wire=gain_wire)
    state0 = init_state(cfg.max_landmarks, world.num_landmarks, device=device)
    xs, ps = dist_ekf.shard_state(mesh, state0.x, state0.p)
    gen = torch.Generator(device=device).manual_seed(0)
    draws = (torch.randn((cfg.observe_interval, 2), generator=gen, device=device),
             torch.randn((world.num_landmarks, 2), generator=gen, device=device))
    out = {"dp": xs.shape[0] * mesh.axis(STATE_AXIS).size,
           "m": 2 * min(world.num_landmarks, cfg.max_observations()),
           "interval": cfg.observe_interval}
    for route, fast in (("fused", True), ("legacy", False)):
        carry = DistEKFCarry(steer=init_steer_state(cfg.number_loops, device),
                             x_true=torch.zeros((3,), device=device), x=xs, p=ps,
                             n_active=state0.n_active, table=state0.table)
        with mesh.recording() as rec:
            dist_ekf_frame_step(carry, draws, cfg=cfg.replace(fast_frame=fast), world=world,
                                noise=make_noise(cfg, "ekf", device), mesh=mesh)
        out[route] = [tuple(c) for c in rec]
    return out


def bound(dp: int, m: int, interval: int) -> int:
    """The reference's allowance for one frame's collective bytes:
    O(m Dp) + O(interval Dp) with a generous constant."""
    return 4 * (4 * m * dp + 4 * interval * dp * 4 + m * m * 16 + 4096 * 64)


def main(argv: list[str] | None = None) -> int:
    from conan_slam_tpu_torch.parallel import launch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--ranks", type=int, default=8)
    parser.add_argument("--landmarks", type=int, default=512)
    parser.add_argument("--obs", type=int, default=32)
    parser.add_argument("--gain-wire", choices=("f32", "i16"), default="f32")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    opts = parser.parse_args(argv)
    res = launch.run(audit_rank, opts.ranks, opts.landmarks, opts.obs, opts.gain_wire,
                     device=opts.device)[0]
    dp, m = res["dp"], res["m"]
    verdict = {"dp": dp, "m": m, "ranks": opts.ranks, "gain_wire": opts.gain_wire,
               "bound": bound(dp, m, res["interval"]), "quadratic": 4 * dp * dp // 8}
    for route in ("fused", "legacy"):
        rows = res[route]
        print(f"# Collective audit: one sharded frame, {route} (Dp={dp}, m={m}, "
              f"{opts.ranks} ranks on the state axis, {opts.device})")
        print("| collective | operand | logical bytes | transport bytes |")
        print("|---|---|---|---|")
        for axis, op, shape, dtype, logical, transport in rows:
            print(f"| {op} | `{dtype}{list(shape)}` | {logical:,} | {transport:,} |")
        logical = sum(r[4] for r in rows)
        transport = sum(r[5] for r in rows)
        print(f"| **total** ({len(rows)} collectives) | | **{logical:,}** | **{transport:,}** |")
        verdict[route] = {"collectives": len(rows), "logical_bytes": logical,
                          "transport_bytes": transport,
                          "ok": logical <= verdict["bound"] and logical < verdict["quadratic"]}
    verdict["ok"] = verdict["fused"]["ok"] and verdict["legacy"]["ok"]
    print(json.dumps(verdict), flush=True)
    return 0 if verdict["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
