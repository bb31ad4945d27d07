"""The multi-process smoke of the sharded runtime (port-side counterpart of
benchmarks/dcn_smoke.py): ranks in separate processes that meet over an
``env://`` TCP rendezvous on localhost, as ``torchrun`` starts them, run
one sharded frame (parallel.dist_fastframe, f32 and i16 gain wires) and
check its replicated outputs (NIS, pose trace) against the single-device
fused frame (``filters.ekf.fused_frame_step``: H9 on the card, its plain
version on the CPU) computed in each rank: NIS within rtol 1e-3, the pose
trace within 1e-4, as the reference's.

    python -m conan_slam_tpu_torch.benchmarks.dcn_smoke [--ranks 2] [--device cpu]
                                                        [--backend nccl]

The parent prints its verdict as one JSON line (and writes no file);
exit code 0 when every rank passed.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch


def problem(device):
    """The reference smoke's frame (its rng(4) draws): the state, the
    frame's controls and measurements."""
    from conan_slam_tpu_torch.filters.common import CompactObs
    from conan_slam_tpu_torch.filters.ekf.state import EKFState
    from conan_slam_tpu_torch.models import sensor

    rng = np.random.default_rng(4)
    cap = 30
    d = 3 + 2 * cap
    feats = rng.uniform(-500, 500, size=(cap, 2)).astype(np.float32)
    x0 = np.zeros((d,), np.float32)
    x0[:3] = [5.0, -2.0, 0.4]
    x0[3:] = feats.reshape(-1)
    a = rng.normal(size=(d, d)).astype(np.float32) * 0.05
    p0 = a @ a.T + np.eye(d, dtype=np.float32) * 0.1
    t = lambda v: torch.as_tensor(np.asarray(v)).to(device)   # noqa: E731
    state = EKFState(x=t(x0), p=t(p0), n_active=torch.tensor(cap, device=device),
                     table=torch.full((40,), -1, dtype=torch.int64, device=device))
    s_steps = 6
    vns = t((80.0 + rng.normal(size=(s_steps,))).astype(np.float32))
    swans = t((rng.normal(size=(s_steps,)) * 0.03).astype(np.float32))
    phis = t((0.4 + np.cumsum(rng.normal(size=(s_steps,)) * 0.005)).astype(np.float32))
    act = torch.ones((s_steps,), dtype=torch.bool, device=device)
    nz = 5
    zp, _, _ = sensor.observe(state.x[:3], t(feats[:nz]))
    z = zp + t((rng.normal(size=(nz, 2)) * [0.3, 0.01]).astype(np.float32))
    slots = torch.arange(nz, device=device)
    mask = torch.ones((nz,), dtype=torch.bool, device=device)
    q = t(np.diag([0.18, 0.0006]).astype(np.float32))
    r = t(np.diag([0.08, 0.0024]).astype(np.float32))
    return state, (vns, swans, phis, act, q), CompactObs(z=z, ids=slots, mask=mask), slots, mask, r


def dcn_rank(device) -> dict:
    """One rank: the single-device frame, then the sharded frame on both
    wires over every rank; the checks' worst relative errors."""
    import torch.distributed as dist

    from conan_slam_tpu_torch.filters.ekf import fused_frame_step
    from conan_slam_tpu_torch.parallel import dist_ekf
    from conan_slam_tpu_torch.parallel.dist_fastframe import sharded_frame_update
    from conan_slam_tpu_torch.parallel.mesh import STATE_AXIS, make_mesh

    mesh = make_mesh({STATE_AXIS: dist.get_world_size()}, device)
    state, (vns, swans, phis, act, q), obs, slots, mask, r = problem(device)
    sigma_h = 0.000175
    _, pt_ref, nis_ref = fused_frame_step(state, vns, swans, phis, act, q, obs, slots, mask, r,
                                          73.0, 0.01, sigma_h, True)
    xs, ps = dist_ekf.shard_state(mesh, state.x, state.p)
    out = {"rank": dist.get_rank(), "backend": dist.get_backend(), "device": str(device)}
    for wire in ("f32", "i16"):
        _, _, nis, pt = sharded_frame_update(mesh, xs, ps, vns, swans, phis, act, q, obs.z,
                                             slots, mask, r, 73.0, 0.01, sigma_h, True,
                                             gain_wire=wire)
        nis_err = float((nis - nis_ref).abs() / nis_ref.abs())
        pt_err = float(((pt - pt_ref).abs() - 1e-4 * pt_ref.abs()).max())
        out[wire] = {"nis_rel_err": nis_err, "pose_trace_excess": pt_err,
                     "ok": nis_err <= 1e-3 and pt_err <= 1e-4}
    return out


def main(argv: list[str] | None = None) -> int:
    from conan_slam_tpu_torch.parallel import launch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--ranks", type=int, default=2)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    opts = parser.parse_args(argv)
    results = launch.run(dcn_rank, opts.ranks, device=opts.device, backend=opts.backend,
                         init="env", timeout=300.0)
    ok = all(r[w]["ok"] for r in results for w in ("f32", "i16"))
    print(json.dumps({
        "ok": ok, "processes": opts.ranks, "backend": opts.backend, "device": opts.device,
        "rendezvous": "env:// (TCP, localhost)",
        "kernel": "parallel.dist_fastframe.sharded_frame_update (f32 + i16 gain wire)",
        "checks": "NIS + pose trace vs single-device fused frame (rtol 1e-3 / 1e-4)",
        "ranks": results,
    }), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
