#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (conan_slam_tpu_torch) once on one NVIDIA
GPU and check it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases:
  1. Environment: the card's name and power limit, CUDA, nvcc, triton.
     Exits non-zero at once when PyTorch sees no CUDA device.
  2. Build: compiles the CUDA kernels (conan_slam_tpu_torch/csrc) with nvcc.
  3. Each kernel against its plain PyTorch version on the card, at the
     shapes of the main path (D = 2304, NZ = 64) and at a ragged D, with
     each tolerance stated; each kernel's time beside its plain version's
     (CUDA events).
  4. The main path: the bench workload (1024 landmarks from seed 42 over a
     13 km square, all pre-registered; 64-slot measurement buffer;
     19,200 control steps = 3,200 frames) through
     runner.loop.run_ekf_slam_precomputed, with the kernels and then with
     the plain versions.  It asserts every kernel launched once per frame
     and the reference's accuracy gate: ATE < 0.05 m, asym(P) < 1e-4.
     A torch.profiler trace of 100 frames then gives each kernel's device
     time per frame and the device's busy share.
  5. The kernel table and the card as JSON lines, then the last line
     {"ok": true, "device": {...}}.

Any failed check exits non-zero before the last line is printed.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

N_LANDMARKS = 1024      # all pre-registered: D = 3 + 2 * 1024 = 2051, padded 2304
WORLD_EXTENT = 6500.0   # ~40 landmarks visible per frame at 2000 m range
BENCH_STEPS = 19200
SEED = 42
SIGMA0 = 1.0
PROFILE_FRAMES = 100    # frames of the main path traced with torch.profiler

FAILURES: list[str] = []


def log(*a) -> None:
    print(*a, flush=True)


def run(cmd: list[str]) -> str:
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"
    return (res.stdout + res.stderr).strip()


def check(name: str, got, ref, rtol: float, atol: float, why: str) -> float:
    """allclose-style check |got - ref| <= atol + rtol |ref|; returns the
    max abs error and records a failure."""
    import torch

    got = got.detach().double().cpu()
    ref = ref.detach().double().cpu()
    err = (got - ref).abs()
    bound = atol + rtol * ref.abs()
    ok = bool(torch.isfinite(got).all()) and bool((err <= bound).all())
    max_err = float(err.max()) if err.numel() else 0.0
    scale = float(ref.abs().max()) if ref.numel() else 0.0
    log(f"  {'ok  ' if ok else 'FAIL'} {name}: max_abs_err={max_err:.3e} at max|ref|="
        f"{scale:.3e} (rtol={rtol:g}, atol={atol:.3g}; {why})")
    if not ok:
        FAILURES.append(name)
    return max_err


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call on the card (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bench_world(device, pad_multiple=256):
    from conan_slam_tpu_torch.filters.ekf import init_state_with_map
    from conan_slam_tpu_torch.sim.world import _WP_X, _WP_Y, world_from_numpy

    rng = np.random.default_rng(SEED)
    lm = rng.uniform(-WORLD_EXTENT, WORLD_EXTENT, size=(N_LANDMARKS, 2)).astype(np.float32)
    wp = np.stack([_WP_X, _WP_Y], axis=1).astype(np.float32)
    world = world_from_numpy(lm, wp, device)
    state0 = init_state_with_map(world.landmarks, sigma0=SIGMA0,
                                 pad_multiple=pad_multiple, device=device)
    return world, state0


def frame_case(device, n_warm_frames: int, pad_multiple: int):
    """A realistic frame at the bench shape: the state after
    ``n_warm_frames`` plain frames of the bench run, and the next frame's
    inputs, as frame_step takes them."""
    import torch

    from conan_slam_tpu_torch.config import SlamConfig
    from conan_slam_tpu_torch.filters.common import CompactObs
    from conan_slam_tpu_torch.filters.ekf import associate_known
    from conan_slam_tpu_torch.runner.loop import (
        make_noise,
        precompute_rollout,
        run_ekf_slam_precomputed,
    )

    cfg = SlamConfig(max_landmarks=N_LANDMARKS, max_obs=64, enable_augment=False)
    world, state0 = bench_world(device, pad_multiple)
    s = cfg.observe_interval
    n_steps = (n_warm_frames + 1) * s
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    (x_true, swa, active, done), (z_true, ids, zmask) = precompute_rollout(world, cfg, n_steps)
    ctrl = torch.randn((n_warm_frames + 1, s, 2), generator=gen, device=device)
    obsn = torch.randn((n_warm_frames + 1, z_true.shape[1], 2), generator=gen, device=device)
    roll = ((x_true[:-s], swa[:-s], active[:-s], done[:-s]), (z_true[:-1], ids[:-1], zmask[:-1]))
    state, _ = run_ekf_slam_precomputed(world, cfg, None, n_warm_frames * s, state0, roll,
                                        ctrl_noise=ctrl[:-1], obs_noise=obsn[:-1], plain=True)
    f = n_warm_frames
    noise = make_noise(cfg, "ekf", device)
    vns = cfg.velocity + ctrl[f, :, 0] * cfg.sigma_v
    swans = swa[f * s:(f + 1) * s] + ctrl[f, :, 1] * cfg.sigma_swa
    z = z_true[f] + obsn[f] * torch.tensor([cfg.sigma_r, cfg.sigma_b], device=device)
    obs = CompactObs(z=torch.where(zmask[f][:, None], z, 0.0), ids=ids[f], mask=zmask[f])
    assoc = associate_known(state, obs)
    safe = assoc.slots.clamp(0, state.capacity - 1)
    rows = torch.cat([torch.arange(3, device=device),
                      (3 + 2 * safe[:, None] + torch.arange(2, device=device)).reshape(-1)])
    args = (state.p, state.x, rows, vns, swans, x_true[f * s:(f + 1) * s, 2],
            active[f * s:(f + 1) * s], noise.qe, obs.z[:, 0], obs.z[:, 1], assoc.known_mask,
            noise.re)
    tail = (cfg.wheel_base, cfg.dt_controls, cfg.sigma_heading, cfg.switch_heading_known)
    return args, tail


def kernel_checks(device) -> dict:
    """Phase 3: every kernel against its plain version on the card."""
    import torch

    from conan_slam_tpu_torch.ops import frame_kernel as fk
    from conan_slam_tpu_torch.ops.rank_update import rank_update_t, rank_update_t_reference
    from conan_slam_tpu_torch.ops.spd_inverse import sweep_si, sweep_si_reference

    stats = {}

    # --- H1 on a synthetic 128 x 128 innovation-like covariance ---
    log("H1 sweep_inverse, 128 x 128:")
    g = torch.Generator(device=device).manual_seed(7)
    m = 128
    a = torch.randn((m, m), generator=g, device=device)
    s_syn = a @ a.T / m + torch.eye(m, device=device)
    for nblk in (40, 64):
        nb = torch.tensor([nblk], dtype=torch.int32, device=device)
        got = sweep_si(s_syn, nb)
        ref = sweep_si_reference(s_syn, nb)
        k = 2 * nblk   # trailing unswept blocks are -E by design; both agree there too
        check(f"H1 nblk={nblk} leading {k}x{k}", got[:k, :k], ref[:k, :k], 1e-4, 1e-5,
              "same sweep, fp32 FMA contraction differs: ~10 ulps of |S^-1| ~ 1")
    e = torch.randn((m, m), generator=g, device=device) * 1e-3
    si = sweep_si(s_syn + (e - e.T), torch.tensor([64], dtype=torch.int32, device=device))
    asym = float((si - si.T).abs().max())
    log(f"  {'ok  ' if asym == 0.0 else 'FAIL'} H1 asymmetric input -> asym(S^-1)={asym:.1e} "
        "(must be exactly 0: both symmetrizations run)")
    if asym != 0.0:
        FAILURES.append("H1 symmetry")

    # --- the frame at the bench shape (D = 2304) and at a ragged D (2051) ---
    for pad, label in ((256, "D=2304"), (0, "D=2051 ragged")):
        args, tail = frame_case(device, 30, pad)
        d = args[0].shape[0]
        log(f"frame kernels at {label} (D={d}, NZ=64):")
        fi = fk.frame_inputs(*args)
        chain_args = (fi.subs, fi.qc, fi.zin, fi.rsc, fi.x0rows, fi.prc, fi.mp, *tail)
        ch_k = fk.frame_chain(*chain_args)
        ch_p = fk._frame_chain_reference(*chain_args)
        # The recursion runs at the reference's heading sigma (r ~ 3e-8),
        # where float32 cancellation is amplified in any order (the
        # reference's own f64-oracle test); K4 and S carry it.
        check(f"H2 {label} pose trace", ch_k.pt, ch_p.pt, 1e-6, 1e-4,
              "~5 km positions: a few fp32 ulps (4.9e-4 m)")
        check(f"H2 {label} Hc, hp2, hg", ch_k.rowc[:, :7], ch_p.rowc[:, :7], 1e-3, 1e-6,
              "sqrtf/divisions vs torch, fp32 contraction")
        check(f"H2 {label} innovation v", ch_k.rowc[:, 7], ch_p.rowc[:, 7], 0.0, 5e-4,
              "range innovations are z - |d| at ranges up to 2 km, where the fp32 spacing "
              "is 1.2e-4 m: a few ulps of the range")
        check(f"H2 {label} pose, corr0, K4", ch_k.ms, ch_p.ms, 1e-3, 1e-4,
              "K4 carries the heading gain's amplified fp32 cancellation (r ~ 3e-8)")
        e2 = check(f"H2 {label} S", ch_k.s, ch_p.s, 1e-3, 1e-6 * float(ch_p.s.abs().max()),
                   "compact vs dense Hc products, fp32 order")
        si_k = sweep_si(ch_p.s, fi.nblk)
        si_p = sweep_si_reference(ch_p.s, fi.nblk)
        e1 = check(f"H1 {label} S^-1", si_k, si_p, 1e-3, 1e-5 * float(si_p.abs().max()),
                   "same sweep on the frame's S, fp32 contraction")
        pk = fk.frame_panels(ch_p.rowc, ch_p.ms, si_p, fi.prows, args[1])
        pp = fk._frame_panels_reference(ch_p.rowc, ch_p.ms, si_p, fi.prows, args[1])
        e3 = check(f"H3 {label} pht", pk[0], pp[0], 1e-4, 1e-6, "5-term vs dense product")
        check(f"H3 {label} xn", pk[1], pp[1], 1e-6, 1e-3, "~5 km means: fp32 ulps (4.9e-4 m)")
        check(f"H3 {label} nis", pk[2], pp[2], 1e-4, 1e-5, "fp32 reduction order")
        gmat, mmid = fk._frame_gm(pp[0], si_p, ch_p.k4[:4, :4], fi.prows[2:3], fi.mp)
        pu_k = rank_update_t(args[0], gmat, mmid)
        pu_p = rank_update_t_reference(args[0], gmat, mmid)
        e4 = check(f"H4 {label} P + G^T M G (r={gmat.shape[0]})", pu_k, pu_p, 1e-4, 1e-6,
                   "fp32 FMA over r terms vs cuBLAS fp32")
        full_k = fk.frame_step(*args, *tail)
        full_p = fk.frame_step(*args, *tail, plain=True)
        mp, rp = fi.mp, fi.rp
        oracle = fk._frame_step_reference(*args[:8], fi.zin, fi.rsc, mp, rp, *tail)
        for ref_name, ref in (("plain split schedule", full_p), ("fastframe oracle", oracle)):
            check(f"frame {label} vs {ref_name}: pose trace", full_k.pose_trace, ref.pose_trace,
                  1e-6, 1e-3, "~5 km positions, fp32 ulps")
            check(f"frame {label} vs {ref_name}: x", full_k.x, ref.x, 1e-6, 2e-3,
                  "~5 km means, fp32 ulps")
            check(f"frame {label} vs {ref_name}: P", full_k.p, ref.p, 1e-3, 1e-4,
                  "the reference test's tolerance")
            check(f"frame {label} vs {ref_name}: nis", full_k.nis, ref.nis, 1e-3, 1e-5,
                  "the reference test's tolerance")
        if pad == 256:
            stats["frame_chain"] = dict(
                max_abs_err=e2,
                ms=time_ms(lambda: fk.frame_chain(*chain_args), 50),
                plain_ms=time_ms(lambda: fk._frame_chain_reference(*chain_args), 10))
            stats["sweep_inverse"] = dict(
                max_abs_err=e1,
                ms=time_ms(lambda: sweep_si(ch_p.s, fi.nblk), 50),
                plain_ms=time_ms(lambda: sweep_si_reference(ch_p.s, fi.nblk), 5))
            pargs = (ch_p.rowc, ch_p.ms, si_p, fi.prows, args[1])
            stats["frame_panels"] = dict(
                max_abs_err=e3,
                ms=time_ms(lambda: fk.frame_panels(*pargs), 50),
                plain_ms=time_ms(lambda: fk._frame_panels_reference(*pargs), 50))
            stats["rank_update"] = dict(
                max_abs_err=e4,
                ms=time_ms(lambda: rank_update_t(args[0], gmat, mmid), 50),
                plain_ms=time_ms(lambda: rank_update_t_reference(args[0], gmat, mmid), 50))
            stats["frame_step"] = dict(
                ms=time_ms(lambda: fk.frame_step(*args, *tail), 50),
                plain_ms=time_ms(lambda: fk.frame_step(*args, *tail, plain=True), 10))
    for name, st in stats.items():
        log(f"  time {name}: kernel {st['ms']:.4f} ms, plain {st['plain_ms']:.4f} ms")
    return stats


def main_path(device, n_steps: int) -> tuple[dict, dict]:
    """Phase 4: the bench workload through the port's driver."""
    import torch

    from conan_slam_tpu_torch.config import SlamConfig
    from conan_slam_tpu_torch.ops import cuda
    from conan_slam_tpu_torch.runner.loop import precompute_rollout, run_ekf_slam_precomputed
    from conan_slam_tpu_torch.runner.metrics import ate_rmse

    cfg = SlamConfig(max_landmarks=N_LANDMARKS, max_obs=64, enable_augment=False)
    world, state0 = bench_world(device)
    roll = precompute_rollout(world, cfg, n_steps)
    n_frames = n_steps // cfg.observe_interval
    nz = roll[1][0].shape[1]
    gen = torch.Generator(device=device).manual_seed(SEED)
    ctrl = torch.randn((n_frames, cfg.observe_interval, 2), generator=gen, device=device)
    obsn = torch.randn((n_frames, nz, 2), generator=gen, device=device)
    log(f"main path: D={state0.x.shape[0]}, NZ={nz}, {n_steps} steps = {n_frames} frames")

    results = {}
    for plain in (False, True):
        label = "plain" if plain else "kernels"
        # Warm-up: allocator, ctypes bindings, first launches.
        warm = (tuple(a[:60] for a in roll[0]), tuple(a[:10] for a in roll[1]))
        run_ekf_slam_precomputed(world, cfg, None, 60, state0, warm,
                                 ctrl_noise=ctrl[:10], obs_noise=obsn[:10], plain=plain)
        torch.cuda.synchronize()
        cuda.reset_launch_counts()
        t0 = time.perf_counter()
        state, outs = run_ekf_slam_precomputed(world, cfg, None, n_steps, state0, roll,
                                               ctrl_noise=ctrl, obs_noise=obsn, plain=plain)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = {k.name: k.launches for k in cuda.KERNELS.values()}
        ate = float(ate_rmse(outs.x_true, outs.x_est))
        asym = float((state.p - state.p.T).abs().max())
        finite = bool(torch.isfinite(state.p).all() and torch.isfinite(outs.x_est).all())
        results[label] = dict(steps_per_s=n_steps / secs, seconds=secs, ate=ate, asym=asym,
                              counts=counts, x_est=outs.x_est)
        log(f"  {label}: {n_steps} steps in {secs:.3f} s = {n_steps / secs:,.1f} steps/s, "
            f"ATE={ate:.4f} m, asym(P)={asym:.2e}, finite={finite}, launches={counts}")
        if not finite:
            FAILURES.append(f"main path ({label}): non-finite state")
    k = results["kernels"]
    for name, c in k["counts"].items():
        if c != n_frames:
            FAILURES.append(f"{name} launched {c} times for {n_frames} frames")
    if any(c != 0 for c in results["plain"]["counts"].values()):
        FAILURES.append("the plain run launched a kernel")
    ok_gate = k["ate"] < 0.05 and k["asym"] < 1e-4
    log(f"  {'ok  ' if ok_gate else 'FAIL'} accuracy gate: ATE {k['ate']:.4f} < 0.05 m, "
        f"asym(P) {k['asym']:.2e} < 1e-4")
    if not ok_gate:
        FAILURES.append("accuracy gate")
    dev = float((k["x_est"] - results["plain"]["x_est"]).abs().max())
    log(f"  kernels vs plain trajectory: max |dx_est| = {dev:.3e} m")
    return results, k["counts"]


def profile_frames(device, n_frames: int) -> None:
    """A torch.profiler trace of ``n_frames`` frames of the main path:
    device time per kernel per frame and the device's busy share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from conan_slam_tpu_torch.config import SlamConfig
    from conan_slam_tpu_torch.runner.loop import precompute_rollout, run_ekf_slam_precomputed

    cfg = SlamConfig(max_landmarks=N_LANDMARKS, max_obs=64, enable_augment=False)
    world, state0 = bench_world(device)
    n_steps = n_frames * cfg.observe_interval
    roll = precompute_rollout(world, cfg, n_steps)
    gen = torch.Generator(device=device).manual_seed(SEED)
    run_ekf_slam_precomputed(world, cfg, gen, n_steps, state0, roll)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_ekf_slam_precomputed(world, cfg, gen, n_steps, state0, roll)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
        rows.append((us, e.count, e.key))
    busy = sum(r[0] for r in rows)
    log(f"profile, {n_frames} frames: wall {wall_us / n_frames:.1f} us/frame under the "
        f"profiler, device busy {busy / n_frames:.1f} us/frame "
        f"({100.0 * busy / wall_us:.1f}% of wall)")
    for us, count, key in sorted(rows, reverse=True)[:15]:
        log(f"  {us / n_frames:9.2f} us/frame  {count / n_frames:5.2f} launches/frame  {key[:90]}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=BENCH_STEPS,
                        help="control steps of the main-path run (default: the bench's 19,200)")
    opts = parser.parse_args()

    import torch

    # --- phase 1: environment ---
    if not torch.cuda.is_available():
        print("chip_smoke: PyTorch sees no CUDA device", file=sys.stderr)
        return 1
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    log(f"nvidia-smi: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    try:
        import triton
        log(f"triton {triton.__version__}")
    except ImportError:
        log("triton: not installed")

    from conan_slam_tpu_torch.ops import cuda

    log(f"nvcc: {run([cuda._nvcc(), '--version']).splitlines()[-1]}")
    device = torch.device("cuda", 0)

    # --- phase 2: build ---
    path, secs, out = cuda.build(("-Xptxas", "-v"))
    log(f"build: {path.name} in {secs:.1f} s")
    for line in out.splitlines():
        if "Compiling entry" in line or "registers" in line:
            log("  " + line.strip())
    cuda.library()

    # --- phase 3: every kernel against its plain version ---
    t0 = time.perf_counter()
    stats = kernel_checks(device)
    log(f"kernel checks: {time.perf_counter() - t0:.1f} s")

    # --- phase 4: the main path ---
    results, counts = main_path(device, opts.steps)

    profile_frames(device, PROFILE_FRAMES)

    # --- phase 5: report ---
    order = ("sweep_inverse", "frame_chain", "frame_panels", "rank_update")
    table = {"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
         "launches": counts[k.name], "max_abs_err": stats[k.name]["max_abs_err"],
         "ms": stats[k.name]["ms"], "plain_ms": stats[k.name]["plain_ms"]}
        for k in sorted(cuda.KERNELS.values(), key=lambda k: order.index(k.name))
    ]}
    summary = {
        "steps_per_s": results["kernels"]["steps_per_s"],
        "plain_steps_per_s": results["plain"]["steps_per_s"],
        "ate_m": results["kernels"]["ate"], "asym_p": results["kernels"]["asym"],
        "frame_ms": stats["frame_step"]["ms"], "frame_plain_ms": stats["frame_step"]["plain_ms"],
    }
    log(json.dumps(summary))
    if FAILURES:
        log("FAILED: " + "; ".join(FAILURES))
        return 1
    print(json.dumps(table), flush=True)
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
