"""Rank entry points of the sharded runtime's checks and benches
(``parallel.launch`` runs each as ``fn(device, *args)`` in every rank, its
numpy arguments made tensors on the rank's device).

* ``collectives``: every collective of a mesh axis once, on any route;
* ``state_steps``: this rank's row blocks of (x, P), then a chain of
  sharded EKF functions on them;
* ``ensemble_steps``: this rank's particle block, then a chain of
  per-particle or sharded PF functions;
* ``run_sharded``: ``run_ekf_slam_sharded`` on given draws;
* ``big_frame``: one sharded frame at a size no rank holds whole (P's rows
  made on each rank from a formula the single-device check repeats bit for
  bit), with its timings and its collectives' bytes.

Each returns its blocks or results, the launches of every kernel in this
rank over the task (``launches``), and the collectives it recorded.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from conan_slam_tpu_torch.ops import cuda
from conan_slam_tpu_torch.parallel import dist_ekf, dist_pf
from conan_slam_tpu_torch.parallel.mesh import STATE_AXIS, Mesh, make_mesh


def collectives(device, axes, route: str | None = None) -> dict:
    """Every collective of the state axis once, on values that differ by
    rank (float32, and int16 where the gain wire uses it), the gathers
    over ``route`` (a ``mesh.ROUTES`` entry's name) where given, else
    over the table's route for this backend and device."""
    mesh = Mesh(axes, device, route)        # its own groups
    ax = mesh.axis(STATE_AXIS)
    f = torch.arange(6, dtype=torch.float32, device=device).reshape(2, 3) * (ax.index + 1) - 2.5
    q = (torch.arange(8, dtype=torch.int16, device=device) * (ax.index + 1) - 3).reshape(2, 4)
    return {"psum": ax.psum(f), "pmax": ax.pmax(f), "pmin": ax.pmin(f),
            "gather0": ax.all_gather(f), "gather1": ax.all_gather(f, dim=1),
            "gather_i16": ax.all_gather(q, dim=1), "shift": ax.ppermute(f),
            "shift_i16": ax.ppermute(q), "index": ax.index}


def _launches() -> dict:
    return {k.name: k.launches for k in cuda.KERNELS.values()}


def state_steps(device, axes, x, p, steps) -> dict:
    """Shard (x, P) over ``axes``' state axis, then ``out = fn(mesh, x_l,
    p_l, *args, **kwargs)`` for each ``(fn, args, kwargs)`` of ``steps``,
    carrying ``out[:2]``; every ``out[2:]`` is kept in ``extras``."""
    mesh = make_mesh(axes, device)
    cuda.reset_launch_counts()
    x_l, p_l = dist_ekf.shard_state(mesh, x, p)
    extras = []
    with mesh.recording() as rec:
        for fn, args, kwargs in steps:
            out = fn(mesh, x_l, p_l, *args, **kwargs)
            x_l, p_l = out[0], out[1]
            extras.append(tuple(out[2:]))
    return {"x": x_l, "p": p_l, "extras": extras, "launches": _launches(),
            "collectives": [tuple(c) for c in rec]}


def ensemble_steps(device, axes, ens, steps) -> dict:
    """This rank's particle block of ``ens``, then ``fn(mesh, ens_l, *args,
    **kwargs)`` (``sharded``) or ``fn(ens_l, *args, **kwargs)`` for each
    ``(fn, args, kwargs, sharded)`` of ``steps``."""
    mesh = make_mesh(axes, device)
    cuda.reset_launch_counts()
    ens_l = dist_pf.shard_ensemble(mesh, ens)
    with mesh.recording() as rec:
        for fn, args, kwargs, sharded in steps:
            ens_l = fn(mesh, ens_l, *args, **kwargs) if sharded else fn(ens_l, *args, **kwargs)
    return {"ens": ens_l, "launches": _launches(), "collectives": [tuple(c) for c in rec]}


def run_sharded(device, axes, world, cfg, n_steps: int, state0, ctrl, obs) -> dict:
    """``run_ekf_slam_sharded`` on the draws ``ctrl``, ``obs``; its outputs,
    this rank's final blocks, the wall seconds and the launches."""
    from conan_slam_tpu_torch.parallel.dist_runner import run_ekf_slam_sharded
    from conan_slam_tpu_torch.sim.world import World

    mesh = make_mesh(axes, device)
    cuda.reset_launch_counts()
    t0 = time.perf_counter()
    carry, outs = run_ekf_slam_sharded(World(*world), cfg, None, mesh, n_steps, state0,
                                       ctrl_noise=ctrl, obs_noise=obs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return {"outs": outs, "x": carry.x, "p": carry.p, "n_active": carry.n_active,
            "table": carry.table, "seconds": time.perf_counter() - t0, "launches": _launches()}


def big_inputs(d: int, nz: int, s_steps: int, seed: int, device):
    """A known frame at D = ``d`` with ``nz`` measurements of distinct
    landmarks, as ``big_frame`` and its single-device check take it:
    ``(x, p_rows, frame)`` with ``p_rows(rows)`` P's rows [rows]
    (0.1 I + four rank-one terms, summed elementwise in a fixed order, so
    any block of rows is bit for bit the rows of the whole) and ``frame``
    the sharded frame's arguments after (x, P)."""
    from conan_slam_tpu_torch.models import sensor

    rng = np.random.default_rng(seed)
    cap = (d - 3) // 2
    t = lambda v: torch.as_tensor(np.asarray(v)).to(device)   # noqa: E731
    x = np.zeros((d,), np.float32)
    x[:3] = [5.0, -2.0, 0.4]
    x[3:3 + 2 * cap] = rng.uniform(-500, 500, size=2 * cap).astype(np.float32)
    u = t(rng.normal(size=(4, d)).astype(np.float32) * 0.05)

    def p_rows(rows: slice) -> torch.Tensor:
        out = torch.zeros((rows.stop - rows.start, d), dtype=torch.float32, device=device)
        idx = torch.arange(rows.start, rows.stop, device=device)
        out[torch.arange(idx.shape[0], device=device), idx] = 0.1
        for k in range(4):
            out = out + u[k, rows, None] * u[k, None, :]
        return out

    slots = np.sort(rng.choice(cap, size=nz, replace=False)).astype(np.int64)
    feats = x[3:3 + 2 * cap].reshape(cap, 2)[slots]
    zp, _, _ = sensor.observe(t(x[:3]), t(feats))
    z = zp + t((rng.normal(size=(nz, 2)) * [0.3, 0.01]).astype(np.float32))
    mask = np.ones(nz, bool)
    mask[-1] = False
    frame = (t((80.0 + rng.normal(size=s_steps)).astype(np.float32)),
             t((rng.normal(size=s_steps) * 0.03).astype(np.float32)),
             t((0.4 + np.cumsum(rng.normal(size=s_steps) * 0.005)).astype(np.float32)),
             torch.ones((s_steps,), dtype=torch.bool, device=device),
             t(np.diag([0.18, 0.0006]).astype(np.float32)), z, t(slots), t(mask),
             t(np.diag([0.08, 0.0024]).astype(np.float32)), 73.0, 0.01, 0.000175, True)
    return t(x), p_rows, frame


def big_frame(device, axes, d: int, nz: int, s_steps: int, seed: int, repeats: int) -> dict:
    """One sharded frame at D = ``d`` on both gain wires from the same
    blocks (``big_inputs``): the f32 frame's x, P rows and replicated
    outputs, the i16 frame's distance from it (P rows, x, NIS), the
    launches of one frame each, then ``repeats`` more f32 frames timed:
    the wall µs a frame on every rank and the device µs a frame of rank
    0's kernels (torch.profiler), and the collectives' bytes of one frame.
    ``launches`` counts every frame of the task, ``launches_two_frames``
    the first two."""
    from conan_slam_tpu_torch.parallel.dist_fastframe import sharded_frame_update

    mesh = make_mesh(axes, device)
    ax = mesh.axis(STATE_AXIS)
    x, p_rows, frame = big_inputs(d, nz, s_steps, seed, device)
    x_l, p_l = dist_ekf.shard_state(mesh, x, p_rows)
    cuda.reset_launch_counts()
    with mesh.recording() as rec:
        f32 = sharded_frame_update(mesh, x_l, p_l, *frame, gain_wire="f32")
    collectives = [tuple(c) for c in rec]
    with mesh.recording() as rec:
        i16 = sharded_frame_update(mesh, x_l, p_l, *frame, gain_wire="i16")
    collectives_i16 = [tuple(c) for c in rec]
    res = {"x": f32[0], "p": f32[1], "nis": f32[2], "pose_trace": f32[3],
           "i16": {"p": float((i16[1] - f32[1]).abs().max()), "x": float((i16[0] - f32[0]).abs().max()),
                   "nis": float((i16[2] - f32[2]).abs()), "p_scale": float(f32[1].abs().max())},
           "launches_two_frames": _launches(), "collectives": collectives,
           "collectives_i16": collectives_i16}
    torch.cuda.synchronize(device)
    walls = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        sharded_frame_update(mesh, x_l, p_l, *frame)
        torch.cuda.synchronize(device)
        walls.append(1e6 * (time.perf_counter() - t0))
    res["wall_us"] = walls
    if ax.index == 0:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(repeats):
                sharded_frame_update(mesh, x_l, p_l, *frame)
            torch.cuda.synchronize(device)
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        res["device_us"] = sum(e.self_device_time_total for e in events) / repeats
        res["kernels_us"] = {e.key: e.self_device_time_total / repeats for e in events}
    else:
        for _ in range(repeats):
            sharded_frame_update(mesh, x_l, p_l, *frame)
        torch.cuda.synchronize(device)
    res["launches"] = _launches()
    return res
