#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (conan_slam_tpu_torch) once on one NVIDIA
GPU and check it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases:
  1. Environment: the card's name and power limit, CUDA, nvcc, triton.
     Exits non-zero at once when PyTorch sees no CUDA device.
  2. Build: compiles the CUDA kernels (conan_slam_tpu_torch/csrc) with nvcc,
     one process per source, all in parallel, and prints each kernel's
     -Xptxas -v record (registers, shared memory, stack frame, spills).
  3. Each kernel against its plain PyTorch version on the card, with each
     tolerance stated, and each kernel's time beside its plain version's
     (CUDA events):
       a. the known-association frame at the bench shape (D = 2304,
          NZ = 64) and at a ragged D: H9 (the default route, one
          cooperative launch) and the split schedule's H1-H4, each against
          its plain version; H9 over MP 32/128/224, S 1/6/16, heading on
          and off and D 2304/2051/13 against the split kernels (within the
          fp32 rounding of the sums they order differently) and its plain
          version (two calls bit-equal, asym(P) exactly 0), its device time
          against MP and S, its phases (%globaltimer), its plan and bound;
          and the routes past H1's registers: the frame and the pair at
          MP 240 on the split schedule with H1's cooperative sweep (H1 also
          at MP 480), the gated frame at MP 160-224 (H10) and 240/480 (the
          split with H7 in bands), the known frame at S = 17/33/64 (H9 and
          the split), the plain route with no launch where neither package
          has a kernel, and a raise with no launch where only the
          reference has one;
       b. the gated frame (H5-H8, H1, H4, H10 and the whole
          frame_update_obs on both routes) at BASELINE config 2's shape
          (D = 1024, NZ = 64, K = 510) on a mid-run frame, at a ragged D
          (1003) and at the 10k-landmark shape (D = 20,224), with a
          cross-check against the known-association frame on the same rows
          and the frame's mean against a float64 witness.  H10 (the default
          route, one cooperative launch) against its plain version and
          against the split kernels (within the fp32 rounding of the sums
          they order differently), two calls bit-equal, asym(P) exactly 0;
          its device time against the split's in turns (H10, split, split,
          H10) at config 2 and at the 10k shape, against MP and NBP, its
          phases (%globaltimer), its plan and bound;
       c. the frame pair (two frames, one H4 pass at r = 2 (MP + 8)) at the
          bench shape and at a ragged D, against its plain version and
          against two sequential kernel frames, and H4 at r = 272;
       d. the T9 probes: H11 (the sweep variants unroll2, unroll4 and
          wide4 at MP 128, NBLK 40 and 39: sym(unroll) bit for bit H1, each
          against its plain version, the symmetry harness of
          tests/test_pallas_ops.py:83, each variant's time a pivot), H12
          (the stream copy at D 2304 and past the L2, its TB/s), H13, H14
          (both observe paths) and H4's probe entry (its plan bit for bit
          H4, tiles 32/64/128 persistent or one a tile, no P read, rank
          3 r), each against its plain version; then, with the launch
          counts set to 0, the port-side benches
          (conan_slam_tpu_torch/benchmarks: probe_sweep, probe_rankpass,
          probe_mosaic, and bench_framestep's graph-chained modes at
          FS_STEPS 2400), each gating its kernels before it prints its µs
          (CUDA graph and eager) beside the library call's.
     Beside them, the time of one PyTorch call computing the same function
     where there is one (torch.linalg.inv for H1, torch.addmm for H4), and
     each kernel's bound: the larger of its bytes over 3.35 TB/s and its
     operations over 67 TFLOP/s (fp32), from this run's shapes and data.
     H1, H2 and H3 also report their device time (profiler), H2 and H3
     the plan their wrappers chose and two calls bit for bit equal, and H2
     its device time at S = 1, 6, 16 sub-steps and MP = 32, 64, 128 (which
     phase sets its time).
     H4 is measured as its kernel entry rank_update_vbt(P, G, MG) against
     torch.addmm(P, G^T, MG) on the same tensors (device time from the
     profiler, and CUDA events), at the known, config 2 and pair shapes,
     with the tile edge and grid it chose, its square (2 D^2 r) and
     symmetric (D (D + 1) r) bounds, and three checks: two calls bit for
     bit equal, an exactly symmetric output for symmetric P and M, and the
     entry no slower than addmm.
  4. The main paths through runner.loop.run_ekf_slam_precomputed:
       a. the bench workload (1024 landmarks from seed 42 over a 13 km
          square, all pre-registered; 64-slot measurement buffer;
          19,200 control steps = 3,200 frames) through H9, in turns with
          the split schedule (H9, split, split, H9), and 600 steps with
          the plain versions.  Asserts H9 launched once per frame and H1-H4
          never on the H9 runs (H1-H4 once per frame on the split runs),
          and the reference's accuracy gate on each: ATE < 0.05 m,
          asym(P) < 1e-4.
       b. BASELINE config 2 (500 landmarks of random_world(PRNGKey(7), 500)
          on the default tour, empty map, gated association and
          augmentation; 25,002 steps = 4,167 frames) through H10 in turns
          with the split schedule (H10, split, split, H10): asserts the
          reference's gated_full gate (ATE < 0.5 m, 270 <= mapped <= 340)
          on each run, and that H5, H6 and H10 launched once per frame and
          no other kernel (H5, H6, H7, H8, H1 and H4 on the split runs);
          the two routes' largest |dx_est| and the steps whose map sizes
          differ.  600 steps with the plain versions (the reference's gated
          gate: finite, mapped > 0, ATE < 1 m), against the kernels' first
          600 steps.  600 steps of a 10,000-landmark world on each route,
          after 60 untimed steps.
       c. the bench workload in frame pairs (cfg.frame_pair): 19,200 steps =
          1,600 pairs with the kernels, timed in turns with the per-frame
          path (H9; per-frame, pair, pair, per-frame); the ate gate, H2, H1
          and H3 twice per pair and H4 once; 300 steps of the plain pair.
       d. the chunked driver (run_ekf_slam_precomputed_chunked) on the pair
          path in chunks of 4,800 steps with checkpoints: a run killed in
          its third chunk and resumed must equal an uninterrupted run bit
          for bit; the seconds and bytes of one checkpoint.
     Then a torch.profiler trace of 100 frames of each path (the known
     path and the gated path each through its one-launch kernel and
     through the split schedule, 100 pairs of the pair path, 20 frames of
     the 10k-landmark shape on both routes) gives each kernel's device
     time per frame, the PyTorch ops dispatched per frame and the device's
     busy share.
  5. The kernel table and the card as JSON lines, then the last line
     {"ok": true, "device": {...}}.

Any failed check exits non-zero before the last line is printed.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

N_LANDMARKS = 1024      # all pre-registered: D = 3 + 2 * 1024 = 2051, padded 2304
BENCH_STEPS = 19200
PLAIN_STEPS = 600       # the known path's plain-version run (its kernels run all 19,200)
SEED = 42
PROFILE_FRAMES = 100    # frames of each main path traced with torch.profiler
GATED_STEPS = 25_002    # BASELINE config 2: 25,000 steps rounded up to whole frames
GATED_PLAIN_STEPS = 600 # the gated path's plain run (its kernels run all 25,002)
PAIR_PLAIN_STEPS = 300  # the pair path's plain run (its kernels run all 19,200)
BIG_LANDMARKS = 10_000  # the 10k-landmark shape: D = 20,224, K = 10,110
BIG_STEPS = 600
BIG_WARM_STEPS = 60     # untimed steps before the timed 10k run
BIG_PROFILE_FRAMES = 20 # frames of the 10k shape traced with torch.profiler
KNOWN_KERNELS = ("frame_step",)   # H9: the known frame's default route
SPLIT_KERNELS = ("sweep_inverse", "frame_chain", "frame_panels", "rank_update")
GATED_KERNELS = ("factor_strip", "gating_scores", "obs_step")   # H10: the gated default
GATED_SPLIT_KERNELS = ("factor_strip", "gating_scores", "obs_chain", "sweep_inverse",
                       "obs_panels", "rank_update")
ORDER = ("sweep_inverse", "frame_chain", "frame_panels", "rank_update", "factor_strip",
         "gating_scores", "obs_chain", "obs_panels", "frame_step", "obs_step", "sweep_probe",
         "stream_copy", "probe_dots", "probe_observe", "rank_update_tile")
# The kernels of the T9 probes (phase 3d): H11-H14 and H4's probe entry.
PROBE_KERNELS = ("sweep_probe", "stream_copy", "probe_dots", "probe_observe", "rank_update_tile")
# The kernels the probe path drives besides them (bench_framestep's modes).
PROBE_PATH_KERNELS = PROBE_KERNELS + ("sweep_inverse", "rank_update", "frame_step", "obs_step",
                                      "factor_strip", "frame_chain", "frame_panels")
PROBE_FS_MODES = ("sweeponly", "sweep", "chol", "noop", "ppass", "stepkernel", "stepkernel_big",
                  "fullkernel", "factkernel")
CHUNK_STEPS = 4800      # the chunked driver's chunk: 800 frames = 400 pairs
# The card's published peaks (H100 SXM data sheet, at 700 W): fp32 outside
# the tensor cores, and HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

FAILURES: list[str] = []


def log(*a) -> None:
    print(*a, flush=True)


def run(cmd: list[str]) -> str:
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"
    return (res.stdout + res.stderr).strip()


def ptxas_record(out: str) -> dict[str, str]:
    """Each kernel's ``nvcc -Xptxas -v`` record from the build's output
    (registers, barriers, static shared memory, stack frame and spills),
    keyed by kernel name with its template arguments."""
    rec: dict[str, str] = {}
    name = None
    for line in out.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            sym = entry.group(1)
            found = re.findall(r"([a-z]+(?:_[a-z]+)*_kernel)(I\w*?EE)?", sym)
            base, targs = found[-1] if found else (sym, "")
            args = re.findall(r"L[a-z](\d+)E", targs)
            name = base + (f"<{','.join(args)}>" if args else "")
            rec[name] = ""
        elif name and ("stack frame" in line or "Used" in line):
            part = line.split("Used", 1)[1].strip() if "Used" in line else line.strip()
            rec[name] = f"{rec[name]}; {part}" if rec[name] else part
    return rec


def check(name: str, got, ref, rtol: float, atol: float, why: str) -> float:
    """allclose-style check |got - ref| <= atol + rtol |ref|; returns the
    max abs error and records a failure."""
    import torch

    got = got.detach().double()
    ref = ref.detach().double()
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


def require(ok: bool, name: str, detail: str) -> None:
    log(f"  {'ok  ' if ok else 'FAIL'} {name}: {detail}")
    if not ok:
        FAILURES.append(name)


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


def device_ms(fn, iters: int = 20, traces: int = 3, kernel: str | None = None) -> float:
    """Mean device milliseconds per call, without the host's work, from
    torch.profiler traces of ``iters`` calls (after two untraced ones):
    the sum, over the kernels and copies a call launches (each once), of
    their median durations, or only the kernel named ``kernel``.  A name
    seen fewer than iters / 2 times in a trace is a stray of another trace;
    ``kernel`` matches a whole word of the demangled name (which may carry
    ``void``, a namespace and template arguments).
    The profiler can drop a trace's device events, which lowers its
    reading or leaves it empty, and one trace can read high (a clock dip),
    so up to 3 ``traces`` traces are taken until ``traces`` of them hold
    events, and the median of those is kept."""
    import statistics

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    readings = []
    for _ in range(3 * traces):
        if len(readings) == traces:
            break
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        durations: dict[str, list[float]] = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                durations.setdefault(e.name, []).append(e.time_range.elapsed_us())
        reading = sum(statistics.median(d) for name, d in durations.items()
                      if len(d) >= iters / 2
                      and (kernel is None or re.search(rf"\b{kernel}\b", name)))
        if reading > 0.0:
            readings.append(reading)
    if not readings:
        require(False, "device time", f"no profiler trace of {iters} calls held device events")
        return 0.0
    return statistics.median(readings) / 1e3


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: int, flops: float) -> dict:
    """The least time the card could take for a function that moves
    ``n_bytes`` (each input read once, each output written once) and does
    ``flops`` fp32 operations, and which of the two limits it."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations", bytes=n_bytes, flops=flops)


def rank_update_entry_work(p, vt, vbt, symmetric: bool = True) -> dict:
    """H4's kernel entry P + Vt^T VBt: P read once and written once, both
    strips read once; D (D + 1) r operations when only the upper triangle
    of the symmetric product is formed (2 D^2 r for the whole square), and
    the add."""
    d, r = p.shape[0], vt.shape[0]
    flops = (d * (d + 1) * r if symmetric else 2.0 * d * d * r) + d * d
    return bound(nbytes(p, vt, vbt) + nbytes(p), flops)


def h4_measure(label: str, p, gmat, mmid, max_abs_err: float) -> dict:
    """H4 at one of the main path's shapes: the kernel entry
    rank_update_vbt(P, G, MG) against torch.addmm(P, G^T, MG) on the same
    tensors, the wrapper rank_update_t (which also forms MG), the square and
    symmetric bounds, the plan H4 chose, and three checks: two calls are bit
    for bit equal, the output is exactly symmetric when P and M are, and
    the entry takes no more device time than addmm."""
    import torch

    from conan_slam_tpu_torch.ops.rank_update import (
        rank_update_plan,
        rank_update_t,
        rank_update_vbt,
        rank_update_vbt_reference,
    )

    d, r = p.shape[0], gmat.shape[0]
    mg = mmid @ gmat
    tile, grid = rank_update_plan(d, p.device)
    first, second = rank_update_vbt(p, gmat, mg), rank_update_vbt(p, gmat, mg)
    require(bool(torch.equal(first, second)), f"H4 {label} deterministic",
            "two calls on the same inputs are bit for bit equal")
    ps = 0.5 * (p + p.T)                      # exactly symmetric P and M
    ms = 0.5 * (mmid + mmid.T)
    out = rank_update_vbt(ps, gmat, ms @ gmat)
    asym = float((out - out.T).abs().max())
    require(asym == 0.0, f"H4 {label} symmetry",
            f"symmetric P and M -> asym(out) = {asym:.1e} (must be exactly 0: the upper "
            "triangle is mirrored)")
    entry = lambda: rank_update_vbt(p, gmat, mg)          # noqa: E731
    library = lambda: torch.addmm(p, gmat.T, mg)          # noqa: E731
    st = dict(max_abs_err=max_abs_err, ms=time_ms(entry, 50),
              wrapper_ms=time_ms(lambda: rank_update_t(p, gmat, mmid), 50),
              plain_ms=time_ms(lambda: rank_update_vbt_reference(p, gmat, mg), 50),
              library_ms=time_ms(library, 50),
              device_ms=device_ms(entry), library_device_ms=device_ms(library),
              tile=tile, grid=grid, d=d, r=r, **rank_update_entry_work(p, gmat, mg))
    st["bound_square_ms"] = rank_update_entry_work(p, gmat, mg, symmetric=False)["bound_ms"]
    log(f"  H4 {label} (D={d}, r={r}): tile {tile}, grid {grid} blocks; kernel entry "
        f"{st['device_ms'] * 1e3:.2f} us of device time vs torch.addmm "
        f"{st['library_device_ms'] * 1e3:.2f} us on the same (P, G, MG) "
        f"({st['library_device_ms'] / st['device_ms']:.2f}x); events with host work: entry "
        f"{st['ms'] * 1e3:.2f} us, addmm {st['library_ms'] * 1e3:.2f} us, wrapper with MG "
        f"{st['wrapper_ms'] * 1e3:.2f} us; bound square {st['bound_square_ms'] * 1e3:.2f} us, "
        f"symmetric {st['bound_ms'] * 1e3:.2f} us ({st['bound_by']}): "
        f"{100.0 * st['bound_ms'] / st['device_ms']:.1f}% of the symmetric bound")
    require(st["device_ms"] <= st["library_device_ms"], f"H4 {label} vs torch.addmm",
            f"kernel entry {st['device_ms'] * 1e3:.2f} us <= addmm "
            f"{st['library_device_ms'] * 1e3:.2f} us of device time")
    return st


def bench_world(device, pad_multiple=256):
    """The bench workload's world and start state (benchmarks.world, which
    bench_framestep runs on too)."""
    from conan_slam_tpu_torch.benchmarks.world import bench_world as world_of

    _, world, state0 = world_of(N_LANDMARKS, device, pad_multiple)
    return world, state0


def gated_cfg(n_landmarks: int):
    from conan_slam_tpu_torch.config import SlamConfig

    return SlamConfig(max_landmarks=n_landmarks, max_obs=64, switch_association_known=False)


def big_world(device):
    """A 10,000-landmark world from a numpy seed over the 10 km square of
    the reference's random_world, on the default tour."""
    from conan_slam_tpu_torch.sim.world import _WP_X, _WP_Y, world_from_numpy

    lm = np.random.default_rng(SEED + 11).uniform(-5000.0, 5000.0, size=(BIG_LANDMARKS, 2))
    return world_from_numpy(lm.astype(np.float32), np.stack([_WP_X, _WP_Y], axis=1), device)


def warm_frame(device, world, cfg, state0, n_warm_frames: int, n_next: int = 1):
    """A realistic frame: the state after ``n_warm_frames`` plain frames of
    the run from ``state0``, and the inputs ``(ctrl_args, obs)`` of each of
    the ``n_next`` frames after them: ``(state, [(ctrl_args, obs), ...],
    noise)``."""
    import torch

    from conan_slam_tpu_torch.filters.common import CompactObs
    from conan_slam_tpu_torch.runner.loop import (
        make_noise,
        precompute_rollout,
        run_ekf_slam_precomputed,
    )

    s = cfg.observe_interval
    n_steps = (n_warm_frames + n_next) * s
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    (x_true, swa, active, done), (z_true, ids, zmask) = precompute_rollout(world, cfg, n_steps)
    ctrl = torch.randn((n_warm_frames + n_next, s, 2), generator=gen, device=device)
    obsn = torch.randn((n_warm_frames + n_next, z_true.shape[1], 2), generator=gen, device=device)
    w, ws = n_warm_frames, n_warm_frames * s
    roll = ((x_true[:ws], swa[:ws], active[:ws], done[:ws]), (z_true[:w], ids[:w], zmask[:w]))
    state, _ = run_ekf_slam_precomputed(world, cfg, None, ws, state0, roll,
                                        ctrl_noise=ctrl[:w], obs_noise=obsn[:w], plain=True)
    frames = []
    for f in range(w, w + n_next):
        vns = cfg.velocity + ctrl[f, :, 0] * cfg.sigma_v
        swans = swa[f * s:(f + 1) * s] + ctrl[f, :, 1] * cfg.sigma_swa
        z = z_true[f] + obsn[f] * torch.tensor([cfg.sigma_r, cfg.sigma_b], device=device)
        obs = CompactObs(z=torch.where(zmask[f][:, None], z, 0.0), ids=ids[f], mask=zmask[f])
        frames.append(((vns, swans, x_true[f * s:(f + 1) * s, 2], active[f * s:(f + 1) * s]), obs))
    return state, frames, make_noise(cfg, "ekf", device)


def frame_case(device, n_warm_frames: int, pad_multiple: int):
    """A realistic frame at the bench shape: the state after
    ``n_warm_frames`` plain frames of the bench run, and the next frame's
    inputs, as frame_step takes them (the slots and the capacity)."""
    import torch

    from conan_slam_tpu_torch.config import SlamConfig
    from conan_slam_tpu_torch.filters.ekf import associate_known

    cfg = SlamConfig(max_landmarks=N_LANDMARKS, max_obs=64, enable_augment=False)
    world, state0 = bench_world(device, pad_multiple)
    state, [((vns, swans, phis, acts), obs)], noise = warm_frame(device, world, cfg, state0,
                                                                 n_warm_frames)
    assoc = associate_known(state, obs)
    args = (state.p, state.x, assoc.slots, state.capacity, vns, swans, phis, acts, noise.qe,
            obs.z[:, 0], obs.z[:, 1], assoc.known_mask, noise.re)
    tail = (cfg.wheel_base, cfg.dt_controls, cfg.sigma_heading, cfg.switch_heading_known)
    return args, tail


def chain_sweep(fi, tail) -> dict:
    """H2's device time against the length of its recursion (S = 1, 6 and
    16 sub-steps: the frame's controls repeated) and against its dense work
    (MP = 32, 64, 128: the frame's first 16, 32, 64 measurements), to show
    which phase sets its time."""
    from conan_slam_tpu_torch.ops import frame_kernel as fk

    by_s, by_mp = {}, {}
    for s in (1, 6, 16):
        a = (fi.subs.repeat(1, 3)[:, :s].contiguous(), fi.qc, fi.zin, fi.rsc, fi.x0rows, fi.prc,
             fi.mp, *tail)
        by_s[s] = device_ms(lambda: fk.frame_chain(*a))
    for nz in (16, 32, 64):
        mp, rp = fk.frame_shapes(nz)
        a = (fi.subs, fi.qc, fi.zin[:, :nz].contiguous(), fi.rsc, fi.x0rows[:rp].contiguous(),
             fi.prc[:rp, :rp].contiguous(), mp, *tail)
        by_mp[mp] = device_ms(lambda: fk.frame_chain(*a))
    log("  H2 device time against S (MP = 128): " + ", ".join(
        f"S={s} {t * 1e3:.2f} us" for s, t in by_s.items()) + "; against MP (S = 6): " + ", ".join(
        f"MP={m} {t * 1e3:.2f} us" for m, t in by_mp.items()))
    return dict(device_ms_by_s=by_s, device_ms_by_mp=by_mp)


def frame_inputs(args):
    """The packed kernel inputs (ops.frame_kernel.frame_inputs) of
    frame_step's ``args``."""
    from conan_slam_tpu_torch.ops import frame_kernel as fk

    p, x, slots, cap, *rest = args
    return fk.frame_inputs(p, x, fk.frame_rows(slots, cap), *rest[:9])


def ulp_bounds(fargs, got) -> dict:
    """Elementwise bounds on two fp32 routes of one frame (frame_step's
    ``fargs``, tail included) that differ only in the order of their sums:
    H9 and the split schedule run the same chain, sweep and pht code and
    sum M G and the mean in other orders.  Each route rounds two nested
    sums of at most r = MP + 8 terms (M G, then G^T M G; siv, then the
    mean), each within r eps of its terms' magnitudes to first order, so
    the two differ by at most 4 r eps times the magnitudes, from the plain
    versions: |P| + |G|^T |M| |G| for P, |x| + |xn| + |v|^T |S^-1| |pht|
    for the mean, |v|^T |S^-1| |v| for the NIS."""
    from conan_slam_tpu_torch.ops import frame_kernel as fk
    from conan_slam_tpu_torch.ops.spd_inverse import sweep_si_reference

    fi = frame_inputs(fargs[:13])
    ch = fk._frame_chain_reference(fi.subs, fi.qc, fi.zin, fi.rsc, fi.x0rows, fi.prc, fi.mp,
                                   *fargs[13:])
    si = sweep_si_reference(ch.s, fi.nblk)
    p, x = fargs[0], fargs[1]
    pht = fk._frame_panels_reference(ch.rowc, ch.ms, si, fi.prows, x)[0]
    gmat, mmid = fk._frame_gm(pht, si, ch.k4[:4, :4], fi.prows[2:3], fi.mp)
    vsi = ch.rowc[:, 7].abs() @ si.abs()
    u = 4.0 * (fi.mp + 8) * 2.0**-23
    return dict(pose_trace=u * got.pose_trace.abs(),
                x=u * (x.abs() + got.x.abs() + vsi @ pht.abs()),
                p=u * (p.abs() + gmat.abs().T @ (mmid.abs() @ gmat.abs())),
                nis=u * (vsi @ ch.rowc[:, 7].abs()))


def split_excess(bounds: dict, got, split) -> dict:
    """Each output of a one-launch kernel (H9, H10) against the split
    schedule's: the largest |kernel - split| over its fp32 bound in
    ``bounds`` (ulp_bounds, obs_ulp_bounds; at most 1 passes; an entry
    whose bound is 0, a zero row of P past D, passes only if equal)."""
    import torch

    out = {}
    for key, tol in bounds.items():
        err = (getattr(got, key) - getattr(split, key)).abs()
        ratio = torch.where(err == 0, 0.0, err / tol)
        out[key] = float(torch.nan_to_num(ratio, nan=float("inf")).max())
    return out


def h9_checks(label: str, args, tail, split_frame, oracle) -> float:
    """H9 against its plain version and the fastframe oracle at the
    reference's frame tolerances, and against the split schedule's kernels
    within the fp32 rounding of the sums the two order differently
    (ulp_bounds); two calls bit-equal; an exactly symmetric P stays exactly
    symmetric.  Returns P's max abs error against the plain version."""
    import torch

    from conan_slam_tpu_torch.ops import frame_kernel as fk

    got, again = fk.frame_step(*args, *tail), fk.frame_step(*args, *tail)
    plain = fk.frame_step(*args, *tail, plain=True)
    excess = split_excess(ulp_bounds((*args, *tail), got), got, split_frame)
    require(max(excess.values()) <= 1.0, f"H9 {label} vs split kernels",
            "|H9 - split| over its fp32 bound (4 (MP + 8) eps x the terms' magnitudes) at most "
            "1: " + ", ".join(f"{k} {v:.3f}" for k, v in excess.items()))
    err = 0.0
    for ref_name, ref in (("plain version", plain), ("fastframe oracle", oracle)):
        check(f"H9 {label} vs {ref_name}: pose trace", got.pose_trace, ref.pose_trace, 1e-6, 1e-3,
              "~5 km positions, fp32 ulps")
        check(f"H9 {label} vs {ref_name}: x", got.x, ref.x, 1e-6, 2e-3, "~5 km means, fp32 ulps")
        e = check(f"H9 {label} vs {ref_name}: P", got.p, ref.p, 1e-3, 1e-4,
                  "the reference test's tolerance")
        check(f"H9 {label} vs {ref_name}: nis", got.nis, ref.nis, 1e-3, 1e-5,
              "the reference test's tolerance")
        err = e if ref_name == "plain version" else err
    require(all(torch.equal(a, b) for a, b in zip(got, again)), f"H9 {label} deterministic",
            "two calls on the same inputs are bit for bit equal")
    p = args[0]
    sym = fk.frame_step(0.5 * (p + p.T), *args[1:], *tail)
    asym = float((sym.p - sym.p.T).abs().max())
    require(asym == 0.0, f"H9 {label} symmetry",
            f"symmetric P -> asym(P out) = {asym:.1e} (must be exactly 0: the upper triangle is "
            "mirrored)")
    return err


def h9_work(d: int, mp: int, rp: int, nblk: int) -> float:
    """H9's operations: the chain (as H2), the sweep over nblk pivots (as
    H1), pht and the mean (as H3), -S^-1 pht (2 MP^2 D), the P pass's upper
    triangle at r = MP + 8 (D (D + 1) r) and its add."""
    return (20.0 * mp * rp + 10.0 * mp * mp + 4.0 * mp * mp * nblk + 22.0 * mp * d
            + 2.0 * mp * mp + 2.0 * mp * mp * d + d * (d + 1.0) * (mp + 8) + d * d)


def synthetic_frame(device, d: int, nz: int, s_steps: int, use_heading: bool, seed: int = 79):
    """A frame at D = ``d``: NZ = ``nz`` distinct landmarks of a 100 m
    square measured (one masked), S = ``s_steps`` sub-steps (the last
    inactive when S > 1), an exactly symmetric P; frame_step's arguments."""
    import torch

    from conan_slam_tpu_torch.filters.ekf import init_state_with_map

    rng = np.random.default_rng(seed)
    cap = (d - 3) // 2
    lm = rng.uniform(-50, 50, size=(cap, 2)).astype(np.float32)
    st = init_state_with_map(torch.as_tensor(lm), sigma0=0.5,
                             pad_multiple=128 if d % 128 == 0 else 0, device=device)
    a = torch.as_tensor(rng.normal(size=(d, 8)).astype(np.float32) * 0.05, device=device)
    p = st.p + a @ a.T
    ids = rng.choice(cap, size=nz, replace=False)
    z = np.stack([np.hypot(lm[ids, 0], lm[ids, 1]) + rng.normal(size=nz) * 0.1,
                  np.arctan2(lm[ids, 1], lm[ids, 0]) + rng.normal(size=nz) * 0.01], -1)
    mask = np.ones(nz, bool)
    mask[-2] = False
    t = lambda v: torch.as_tensor(np.asarray(v), device=device)  # noqa: E731
    return (0.5 * (p + p.T), st.x, t(ids.astype(np.int64)), cap,
            t((83.33 + rng.normal(size=s_steps) * 0.3).astype(np.float32)),
            t((rng.normal(size=s_steps) * 0.2).astype(np.float32)),
            t((rng.normal(size=s_steps) * 0.5).astype(np.float32)),
            t(np.arange(s_steps) < max(1, s_steps - 1)),
            t(np.diag([0.3**2, (np.pi / 180) ** 2]).astype(np.float32)),
            t(z[:, 0].astype(np.float32)), t(z[:, 1].astype(np.float32)), t(mask),
            t(np.diag([0.1**2, 0.5 * np.pi / 180]).astype(np.float32)),
            73.0, 0.01, 0.01 * np.pi / 180, use_heading)


def known_witness(args):
    """The frame of frame_step's ``args`` (tail included) in float64
    through the port's independent oracle (fastframe factors, dense
    products, a Cholesky inverse): ``FrameStep``."""
    import torch

    from conan_slam_tpu_torch.ops import frame_kernel as fk

    p, x, slots, cap, *rest = (
        a.double() if torch.is_tensor(a) and a.dtype == torch.float32 else a for a in args)
    return fk._plain_frame(p, x, fk.frame_rows(slots, cap), *rest[:9], tuple(rest[9:]))


def h9_sweep(device) -> None:
    """H9 over MP 32, 128 and 224 (NZ 10, 64, 112), S = 1, 6 and 16, the
    heading update on and off, at D = 2304, a ragged D = 2051 and D = 13
    (smaller than one tile).  In every case: two calls bit-equal, asym(P)
    exactly 0, and H9 against the split schedule's kernels within the fp32
    rounding of the sums the two order differently (ulp_bounds), which
    tells a fault of H9 from the conditioning of S.  Against its plain
    version: the reference's frame tolerances (pose 1e-5, x 1e-4, P rtol
    1e-3 / atol 1e-4, NIS rtol 1e-3), except on the F1 frames (heading
    update off over 16 sub-steps), where S is conditioned so that fp32
    rounding anywhere before the sweep moves x and P by ~1e-4 to 1e-3 in
    any route (tests/test_torch_ops.py): there x and P are held to a
    float64 witness, no further from it than twice the plain version, plus
    the reference's 1e-4."""
    import torch

    from conan_slam_tpu_torch.ops import frame_kernel as fk

    cases = [(d, nz, s, h) for d in (2304, 2051) for nz in (10, 64, 112) for s in (1, 6, 16)
             for h in (True, False)] + [(13, 5, s, h) for s in (1, 6, 16) for h in (True, False)]
    worst = dict.fromkeys(("pose trace", "nis", "x", "P"), 0.0)
    excess_max: dict[str, float] = {}
    bad = []
    for d, nz, s, h in cases:
        args = synthetic_frame(device, d, nz, s, h)
        got, again = fk.frame_step(*args), fk.frame_step(*args)
        split = fk.frame_step(*args, schedule="split")
        ref = fk.frame_step(*args, plain=True)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        asym = float((got.p - got.p.T).abs().max())
        excess = split_excess(ulp_bounds(args, got), got, split)
        for key, v in excess.items():
            excess_max[key] = max(excess_max.get(key, 0.0), v)
        ok = same and asym == 0.0 and max(excess.values()) <= 1.0
        for key, a, b, rtol, atol in (("pose trace", got.pose_trace, ref.pose_trace, 1e-5, 1e-5),
                                      ("nis", got.nis, ref.nis, 1e-3, 1e-5),
                                      ("x", got.x, ref.x, 1e-4, 1e-4),
                                      ("P", got.p, ref.p, 1e-3, 1e-4)):
            err = (a.double() - b.double()).abs()
            worst[key] = max(worst[key], float(err.max()))
            if key in ("x", "P") and not h and s == 16:
                continue
            ok = ok and bool((err <= atol + rtol * b.double().abs()).all())
        if not h and s == 16:
            wit = known_witness(args)
            for key, a, b, w in (("x", got.x, ref.x, wit.x), ("P", got.p, ref.p, wit.p)):
                e_h9, e_plain = (float((t.double() - w).abs().max()) for t in (a, b))
                worst[f"{key} - {key}64 (F1)"] = max(worst.get(f"{key} - {key}64 (F1)", 0.0), e_h9)
                ok = ok and e_h9 <= 2.0 * e_plain + 1e-4
        if not ok:
            bad.append(f"D={d} NZ={nz} S={s} heading={h} (equal={same}, asym={asym:.1e}, "
                       f"vs split {max(excess.values()):.3f} of its bound)")
    require(not bad, f"H9 over {len(cases)} shapes",
            "vs the split kernels within 4 (MP + 8) eps of the terms' magnitudes (worst "
            + ", ".join(f"{k} {v:.3f}" for k, v in excess_max.items())
            + " of the bound); vs its plain version within the reference's frame tolerances "
            "(pose 1e-5, x 1e-4, P rtol 1e-3 / atol 1e-4, NIS rtol 1e-3), x and P of the F1 "
            "frames within twice the plain version's distance + 1e-4 of a float64 witness; "
            "two calls bit-equal, asym(P) = 0; worst "
            + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
            + ("; failed: " + "; ".join(bad) if bad else ""))


def launched_now() -> dict:
    """The kernels launched since the counts were last set to 0."""
    from conan_slam_tpu_torch.ops import cuda

    return {k.name: k.launches for k in cuda.KERNELS.values() if k.launches}


def raises_unported(fn) -> str:
    """What ``fn()`` raised, or "nothing"."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return "nothing"


def synthetic_pair(device, d: int, nz: int, seed: int = 83):
    """A frame-start state at D = ``d`` (an exactly symmetric P) and two
    frames of ``nz`` measurements at the sensors' noise scale (speed about
    a standstill, heading at sigma_heading), frame B measured from frame
    A's updated mean, as frame_step_pair takes them."""
    import torch

    from conan_slam_tpu_torch.filters.ekf import init_state_with_map
    from conan_slam_tpu_torch.ops import frame_kernel as fk

    rng = np.random.default_rng(seed)
    cap = (d - 3) // 2
    lm = rng.uniform(-50, 50, size=(cap, 2)).astype(np.float32)
    st = init_state_with_map(torch.as_tensor(lm), sigma0=0.5,
                             pad_multiple=128 if d % 128 == 0 else 0, device=device)
    a = torch.as_tensor(rng.normal(size=(d, 8)).astype(np.float32) * 0.05, device=device)
    p, x = st.p + a @ a.T, st.x
    p = 0.5 * (p + p.T)
    tail = (73.0, 0.01, 0.01 * np.pi / 180, True)
    q = torch.diag(torch.tensor([0.3**2, (np.pi / 180) ** 2], device=device))
    r = torch.diag(torch.tensor([0.1**2, 0.5 * np.pi / 180], device=device))
    t = lambda v: torch.as_tensor(np.asarray(v), device=device)  # noqa: E731
    f32 = np.float32

    def frame(xs):
        ids = rng.choice(cap, size=nz, replace=False)
        fx, fy = xs[3 + 2 * ids] - xs[0], xs[4 + 2 * ids] - xs[1]
        mask = np.ones(nz, bool)
        mask[rng.integers(nz)] = False
        ctrl = (t((rng.normal(size=6) * 0.3).astype(f32)), t((rng.normal(size=6) * 0.02).astype(f32)),
                t((xs[2] + rng.normal(size=6) * tail[2]).astype(f32)),
                t(np.array([1, 1, 1, 1, 1, 0], bool)))
        meas = (t((np.hypot(fx, fy) + rng.normal(size=nz) * 0.1).astype(f32)),
                t((np.arctan2(fy, fx) - xs[2] + rng.normal(size=nz) * 0.01).astype(f32)), t(mask))
        return fk.frame_rows(t(ids.astype(np.int64)), cap), ctrl, meas

    rows_a, ctrl_a, meas_a = frame(x.cpu().numpy())
    fa = fk._plain_frame(p, x, rows_a, *ctrl_a, q, *meas_a, r, tail)
    rows_b, ctrl_b, meas_b = frame(fa.x.cpu().numpy())
    return (p, x, rows_a, ctrl_a, meas_a, rows_b, ctrl_b, meas_b, q, r, *tail)


def synthetic_gated(device, d: int, nz: int, s_steps: int = 6, use_heading: bool = True):
    """frame_update_obs's arguments for a synthetic gated frame at D = ``d``
    (synthetic_frame's state and measurements, the factors from H5's plain
    version: NBP 16, 24 or 56 at S 6 without and with the heading update,
    S 18 with it)."""
    import torch

    from conan_slam_tpu_torch.filters.ekf.state import EKFState
    from conan_slam_tpu_torch.ops.factor_kernel import _frame_factors_reference

    p, x, slots, cap, vns, swans, phis, acts, q, zr, zb, mask, r, *tail = synthetic_frame(
        device, d, nz, s_steps, use_heading)
    st = EKFState(x=x, p=p, n_active=torch.tensor(cap, device=device),
                  table=torch.zeros(1, dtype=torch.int64, device=device))
    st1, _, vtf, bmat = _frame_factors_reference(st, vns, swans, phis, acts, q, *tail)
    return (st1.p, st1.x, slots, cap, zr, zb, mask, r, bmat, vtf)


def route_checks(device) -> dict:
    """F2 and F3: the frames past H1's registers, past 16 sub-steps and past
    the port's kernels.  MP 240 (NZ 120) at D = 2304 and 403: frame_step
    and frame_step_pair take the split schedule, with H1's cooperative
    sweep, held to their plain versions; H1 alone at MP 240 and 480 against
    its plain version, with its device time.  The gated frame at MP 160,
    192 and 224 (D = 1024): H10, one launch; at MP 240 and 480: the split
    with H7 in bands and H1's cooperative sweep; each against its plain
    version.  The known frame at S = 17, 33 and 64 (D = 2304): H9, and the
    split schedule's H2 and H1-H4, against the plain version.  frame_step
    over 257 sub-steps at D = 2051 and frame_update_obs at MP 2080 (D =
    2063): the plain route on the card (neither the port's kernels nor the
    reference's TPU schedules hold them), the same numbers as on the CPU,
    no launch.  257 sub-steps at D = 2304 (frame_step) and D = 1024
    (frame_factors_fused): "unported", a raise before any launch.  Returns
    H1's device ms by MP past 224."""
    import torch

    from conan_slam_tpu_torch.ops import cuda
    from conan_slam_tpu_torch.ops import frame_kernel as fk
    from conan_slam_tpu_torch.ops.factor_kernel import frame_factors_fused
    from conan_slam_tpu_torch.ops.spd_inverse import sweep_si, sweep_si_reference

    split = dict.fromkeys(("sweep_inverse", "frame_chain", "frame_panels"), 1)
    for d in (2304, 403):
        fargs = synthetic_frame(device, d, 120, 6, True)
        route = fk.frame_route(d, 120, device, 6)
        cuda.reset_launch_counts()
        got = fk.frame_step(*fargs)
        torch.cuda.synchronize()
        launched = launched_now()
        log(f"MP 240 (NZ 120, D {d}): frame_route {route!r}, launches {launched}")
        require(route == "split" and launched == {**split, "rank_update": 1},
                f"MP 240 at D {d} split schedule", "H2, H1 (cooperative), H3, H4 once each")
        ref = fk.frame_step(*fargs, plain=True)
        check(f"MP 240 D {d} frame vs plain: pose trace", got.pose_trace, ref.pose_trace, 1e-5,
              1e-5, "the reference test's tolerance")
        check(f"MP 240 D {d} frame vs plain: x", got.x, ref.x, 1e-4, 1e-4,
              "the reference test's tolerance")
        check(f"MP 240 D {d} frame vs plain: P", got.p, ref.p, 1e-3, 1e-4,
              "the reference test's tolerance")
        check(f"MP 240 D {d} frame vs plain: nis", got.nis, ref.nis, 1e-3, 1e-5,
              "the reference test's tolerance")
        pargs = synthetic_pair(device, d, 120)
        cuda.reset_launch_counts()
        got = fk.frame_step_pair(*pargs)
        torch.cuda.synchronize()
        launched = launched_now()
        require(launched == {**dict.fromkeys(split, 2), "rank_update": 1},
                f"MP 240 at D {d} pair launches", f"H2, H1, H3 twice and H4 once: {launched}")
        ref = fk.frame_step_pair(*pargs, plain=True)
        check(f"MP 240 D {d} pair vs plain: x", got.x, ref.x, 1e-4, 2e-4,
              "the reference's pair-test tolerance")
        check(f"MP 240 D {d} pair vs plain: P", got.p, ref.p, 1e-3, 2e-4,
              "the reference's pair-test tolerance")
        check(f"MP 240 D {d} pair vs plain: nis", got.nis, ref.nis, 1e-3, 1e-5,
              "the reference's pair-test tolerance")

    coop = {}
    g = torch.Generator(device=device).manual_seed(11)
    for m in (240, 480):
        a = torch.randn((m, m), generator=g, device=device)
        s_syn = a @ a.T / m + torch.eye(m, device=device)
        nb = torch.tensor([m // 2], dtype=torch.int32, device=device)
        out = sweep_si(s_syn, nb)
        check(f"H1 cooperative, MP {m}", out, sweep_si_reference(s_syn, nb), 1e-4, 1e-5,
              "same sweep, fp32 contraction differs: ulps of |S^-1| ~ 1")
        require(torch.equal(out, out.T), f"H1 cooperative, MP {m} symmetry", "S^-1 exactly symmetric")
        coop[m] = device_ms(lambda: sweep_si(s_syn, nb))
    log("  H1 cooperative sweep device time (all pivots): " + ", ".join(
        f"MP={m} {t * 1e3:.2f} us ({t * 1e3 / (m // 2):.2f} us a pivot)" for m, t in coop.items()))

    # F3a: the gated frame from MP 160 (where H7's one block outgrew shared
    # memory) to 480.
    obs_split = dict.fromkeys(("obs_chain", "sweep_inverse", "obs_panels", "rank_update"), 1)
    gated_us = {}
    for nz in (80, 96, 112, 120, 240):
        uargs = synthetic_gated(device, 1024, nz)
        mp = fk.frame_shapes(nz)[0]
        route = fk.obs_route(1024, nz, uargs[8].shape[0], device)
        cuda.reset_launch_counts()
        got = fk.frame_update_obs(*uargs)
        torch.cuda.synchronize()
        launched = launched_now()
        want = {"obs_step": 1} if mp <= 224 else obs_split
        log(f"gated MP {mp} (NZ {nz}, D 1024): obs_route {route!r}, launches {launched}")
        require(route == ("resident" if mp <= 224 else "split") and launched == want,
                f"gated MP {mp} route", "H10 once to MP 224, then H7 (bands), H1 (cooperative), "
                "H8, H4 once each")
        ref = fk.frame_update_obs(*uargs, plain=True)
        check(f"gated MP {mp} vs plain: x", got.x, ref.x, 1e-4, 1e-4,
              "the reference's megakernel-test tolerance")
        check(f"gated MP {mp} vs plain: P", got.p, ref.p, 1e-3, 1e-4,
              "the reference's megakernel-test tolerance")
        check(f"gated MP {mp} vs plain: nis", got.nis, ref.nis, 1e-3, 1e-5,
              "the reference's megakernel-test tolerance")
        kernel = "obs_step_kernel" if mp <= 224 else "obs_chain_kernel"
        gated_us[mp] = (kernel, 1e3 * device_ms(lambda: fk.frame_update_obs(*uargs), kernel=kernel))
    log("  gated frame device time: " + ", ".join(
        f"MP={m} {k} {t:.2f} us" for m, (k, t) in gated_us.items()))

    # F3b: the known frame past 16 sub-steps, on both schedules.
    from conan_slam_tpu_torch.filters.ekf.state import EKFState

    steps_us = {}
    for s_steps in (17, 33, 64):
        fargs = synthetic_frame(device, 2304, 64, s_steps, True)
        route = fk.frame_route(2304, 64, device, s_steps)
        cuda.reset_launch_counts()
        got = fk.frame_step(*fargs)
        sp = fk.frame_step(*fargs, schedule="split")
        torch.cuda.synchronize()
        launched = launched_now()
        log(f"S {s_steps} (D 2304, NZ 64): frame_route {route!r}, launches {launched}")
        require(route == "resident" and launched == {"frame_step": 1, **split, "rank_update": 1},
                f"S {s_steps} kernels", "H9 once, and H2, H1, H3, H4 once on the split schedule")
        ref = fk.frame_step(*fargs, plain=True)
        for name, out in (("H9", got), ("split", sp)):
            check(f"S {s_steps} {name} vs plain: pose trace", out.pose_trace, ref.pose_trace, 1e-5,
                  1e-4, "poses to ~55 m over 64 sub-steps: a few fp32 ulps")
            check(f"S {s_steps} {name} vs plain: x", out.x, ref.x, 1e-4, 1e-4,
                  "the reference test's tolerance")
            check(f"S {s_steps} {name} vs plain: P", out.p, ref.p, 1e-3, 1e-4,
                  "the reference test's tolerance")
            check(f"S {s_steps} {name} vs plain: nis", out.nis, ref.nis, 1e-3, 1e-5,
                  "the reference test's tolerance")
        st = EKFState(x=fargs[1], p=fargs[0], n_active=torch.tensor(0, device=device),
                      table=torch.zeros(1, dtype=torch.int64, device=device))
        steps_us[s_steps] = tuple(1e3 * device_ms(fn, kernel=kernel) for fn, kernel in (
            (lambda: fk.frame_step(*fargs), "frame_step_kernel"),
            (lambda: fk.frame_step(*fargs, schedule="split"), "frame_chain_kernel"),
            (lambda: frame_factors_fused(st, *fargs[4:9], *fargs[13:]), "factor_strip_kernel")))
    log("  device time past 16 sub-steps (D 2304, MP 128): " + ", ".join(
        f"S={k} H9 {a:.2f} us, H2 {b:.2f} us, H5 {c:.2f} us" for k, (a, b, c) in steps_us.items()))

    cpu = lambda a: a.cpu() if torch.is_tensor(a) else a  # noqa: E731
    fargs = synthetic_frame(device, 2051, 64, 257, True)
    uargs = synthetic_gated(device, 2063, 1030)
    route = fk.frame_route(2051, 64, device, 257)
    oroute = fk.obs_route(2063, 1030, uargs[8].shape[0], device)
    cuda.reset_launch_counts()
    fs, fu = fk.frame_step(*fargs), fk.frame_update_obs(*uargs)
    torch.cuda.synchronize()
    launched = launched_now()
    fs_c, fu_c = fk.frame_step(*map(cpu, fargs)), fk.frame_update_obs(*map(cpu, uargs))
    log(f"S 257 (D 2051): frame_route {route!r}; MP 2080 (D 2063): obs_route {oroute!r}")
    require(route == "plain" and oroute == "plain" and not launched, "plain route",
            f"no kernel of the port or the reference holds these frames; launches "
            f"{launched or 'none'}")
    for name, a, b in (("frame_step x", fs.x, fs_c.x), ("frame_step P", fs.p, fs_c.p),
                       ("frame_update_obs x", fu.x, fu_c.x), ("frame_update_obs P", fu.p, fu_c.p)):
        check(f"plain route {name} card vs CPU", a.cpu(), b, 1e-3, 1e-4,
              "the same plain route, cuBLAS/cuSOLVER vs CPU order")

    fargs = synthetic_frame(device, 2304, 64, 257, True)
    p, x, slots, cap, vns, swans, phis, acts, q, *_, tail_wb, tail_dt, tail_sh, _ = fargs
    st = EKFState(x=x[:1024].contiguous(), p=p[:1024, :1024].contiguous(),
                  n_active=torch.tensor(0, device=device),
                  table=torch.zeros(1, dtype=torch.int64, device=device))
    route = fk.frame_route(2304, 64, device, 257)
    cuda.reset_launch_counts()
    raised = (raises_unported(lambda: fk.frame_step(*fargs)),
              raises_unported(lambda: frame_factors_fused(st, vns, swans, phis, acts, q, tail_wb,
                                                          tail_dt, tail_sh, True)))
    torch.cuda.synchronize()
    launched = launched_now()
    log(f"S 257 (D 2304 frame, D 1024 factors): frame_route {route!r}, raised: {raised}")
    require(route == "unported" and launched == {}
            and all("reference runs a TPU kernel" in e for e in raised), "unported frames raise",
            f"before any launch ({launched or 'none'}): the reference runs a TPU kernel there "
            "and no kernel of the port holds the frame")
    return coop


def h9_measure(device, args, tail, err: float, nblk: int) -> dict:
    """H9 at the known check frame: CUDA-event time of the wrapper, device
    time (profiler), the plain version's time, its plan and bound; and its
    device time against MP (32, 128, 224 at S = 6) and S (1, 6, 16 at MP
    128) on synthetic frames at D = 2304."""
    import torch

    from conan_slam_tpu_torch.ops import frame_kernel as fk

    fargs = (*args, *tail)
    d, nz = args[0].shape[0], args[9].shape[0]
    mp, rp = fk.frame_shapes(nz)
    plan = fk.frame_step_plan(d, mp, device, args[4].shape[0])
    out = fk.frame_step(*fargs)
    ins = [a for a in fargs if torch.is_tensor(a)]
    st = dict(max_abs_err=err, library_ms=None,
              ms=time_ms(lambda: fk.frame_step(*fargs), 50),
              device_ms=device_ms(lambda: fk.frame_step(*fargs), kernel="frame_step_kernel"),
              plain_ms=time_ms(lambda: fk.frame_step(*fargs, plain=True), 10),
              plan=f"grid {plan.grid} x {plan.block} threads, {plan.smem:,} B shared; "
                   f"{plan.bands} chain bands, {plan.panels} panels, {plan.tiles} tiles of "
                   f"{fk.FS_TILE}",
              **bound(nbytes(*ins, *out), h9_work(d, mp, rp, nblk)))
    by_mp, by_s = {}, {}
    for nz_, s in ((16, 6), (64, 6), (112, 6), (64, 1), (64, 16)):
        a = synthetic_frame(device, 2304, nz_, s, True)
        t = device_ms(lambda: fk.frame_step(*a), kernel="frame_step_kernel")
        if s == 6:
            by_mp[fk.frame_shapes(nz_)[0]] = t
        if nz_ == 64:
            by_s[s] = t
    st.update(device_ms_by_mp=by_mp, device_ms_by_s=by_s, phases_us=h9_phases(fargs, plan.grid))
    log("  H9 device time against MP (S = 6): " + ", ".join(
        f"MP={m} {t * 1e3:.2f} us" for m, t in by_mp.items()) + "; against S (MP = 128): "
        + ", ".join(f"S={k} {t * 1e3:.2f} us" for k, t in sorted(by_s.items())))
    return st


def stamp_phases(name: str, launch, grid: int, device, launches: int = 20) -> dict:
    """A cooperative kernel's phases (H9, H10), from each block's
    %globaltimer at its phase boundaries (``launch(stamps)`` runs the kernel
    once with a (grid, 8) int64 ``stamps`` buffer: ops.frame_kernel's
    _frame_step_h9 and _obs_step_h10), the median over ``launches``
    launches, in us: the chain (first start to the last block done), each
    barrier (last block in to last block out), block 0's sweep and the
    other blocks' pht panels (side by side), the gains and the mean, the P
    pass, and the whole launch.  The stamps add a block barrier at each
    phase's end."""
    import torch

    runs = []
    for _ in range(launches + 2):
        stamps = torch.zeros((grid, 8), dtype=torch.int64, device=device)
        launch(stamps)
        runs.append(stamps)
    torch.cuda.synchronize()
    rows = []
    for stamps in runs[2:]:
        t = stamps.cpu().double() / 1e3
        last = t.max(dim=0).values
        rows.append({
            "chain": last[1] - t[:, 0].min(), "barrier 1": last[2] - last[1],
            "sweep (block 0)": t[0, 3] - t[0, 2],
            "pht panels (other blocks)": t[1:, 3].max() - t[1:, 2].min(),
            "barrier 2": last[4] - last[3], "gains and mean": last[5] - last[4],
            "barrier 3": last[6] - last[5], "P pass": last[7] - last[6],
            "launch": last[7] - t[:, 0].min()})
    phases = {k: float(torch.tensor([r[k] for r in rows]).median()) for k in rows[0]}
    log(f"  {name} phases (median of {launches} launches, %globaltimer): " + ", ".join(
        f"{k} {v:.2f} us" for k, v in phases.items()))
    return phases


def h9_phases(fargs, grid: int) -> dict:
    """H9's phases at frame_step's ``fargs`` (stamp_phases)."""
    from conan_slam_tpu_torch.ops import frame_kernel as fk

    return stamp_phases("H9", lambda st: fk._frame_step_h9(*fargs, stamps=st), grid,
                        fargs[0].device)


def kernel_checks(device) -> dict:
    """Phase 3a: the known-association frame's kernels against their plain
    versions."""
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
    require(asym == 0.0, "H1 symmetry",
            f"asymmetric input -> asym(S^-1)={asym:.1e} (must be exactly 0: both "
            "symmetrizations run)")

    # --- the frame at the bench shape (D = 2304) and at a ragged D (2051) ---
    for pad, label in ((256, "D=2304"), (0, "D=2051 ragged")):
        args, tail = frame_case(device, 30, pad)
        d = args[0].shape[0]
        log(f"frame kernels at {label} (D={d}, NZ=64):")
        fi = frame_inputs(args)
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
        full_k = fk.frame_step(*args, *tail, schedule="split")
        full_p = fk.frame_step(*args, *tail, plain=True, schedule="split")
        oracle = fk._plain_frame(args[0], args[1], fk.frame_rows(args[2], args[3]), *args[4:],
                                 tail)
        e9 = h9_checks(label, args, tail, full_k, oracle)
        for ref_name, ref in (("plain split schedule", full_p), ("fastframe oracle", oracle)):
            check(f"frame {label} vs {ref_name}: pose trace", full_k.pose_trace, ref.pose_trace,
                  1e-6, 1e-3, "~5 km positions, fp32 ulps")
            check(f"frame {label} vs {ref_name}: x", full_k.x, ref.x, 1e-6, 2e-3,
                  "~5 km means, fp32 ulps")
            check(f"frame {label} vs {ref_name}: P", full_k.p, ref.p, 1e-3, 1e-4,
                  "the reference test's tolerance")
            check(f"frame {label} vs {ref_name}: nis", full_k.nis, ref.nis, 1e-3, 1e-5,
                  "the reference test's tolerance")
        pargs = (ch_p.rowc, ch_p.ms, si_p, fi.prows, args[1])
        require(all(torch.equal(a, b) for a, b in
                    zip((*ch_k, *pk), (*fk.frame_chain(*chain_args), *fk.frame_panels(*pargs)))),
                f"H2, H3 {label} deterministic", "two calls on the same inputs are bit for bit equal")
        if pad == 256:
            mp, rp, d = fi.mp, fi.rp, args[0].shape[0]
            # H2: the recursion (a few hundred scalar operations), then
            # Hc P'[rows] with five nonzeros a row of Hc plus P''s three
            # factored terms, and S = psub Hc^T.
            cplan = fk.frame_chain_plan(mp)
            stats["frame_chain"] = dict(
                max_abs_err=e2, library_ms=None,
                ms=time_ms(lambda: fk.frame_chain(*chain_args), 50),
                device_ms=device_ms(lambda: fk.frame_chain(*chain_args)),
                plain_ms=time_ms(lambda: fk._frame_chain_reference(*chain_args), 10),
                plan=f"band {cplan.band} rows, grid {cplan.grid} blocks",
                **bound(nbytes(*chain_args[:6], *ch_k), 20.0 * mp * rp + 10.0 * mp * mp))
            stats["frame_chain"].update(chain_sweep(fi, tail))
            # H1: one rank-2 update of the (MP, MP) matrix per swept pivot
            # block, nblk of them in this frame.
            stats["sweep_inverse"] = dict(
                max_abs_err=e1,
                ms=time_ms(lambda: sweep_si(ch_p.s, fi.nblk), 50),
                device_ms=device_ms(lambda: sweep_si(ch_p.s, fi.nblk)),
                # The same launch sweeping no pivot: its load, symmetrize
                # and store, the part of the time no pivot adds to.
                fixed_ms=device_ms(lambda: sweep_si(ch_p.s, torch.zeros_like(fi.nblk))),
                plain_ms=time_ms(lambda: sweep_si_reference(ch_p.s, fi.nblk), 5),
                library_ms=time_ms(lambda: torch.linalg.inv(ch_p.s), 50),
                **bound(nbytes(ch_p.s, fi.nblk, si_k), 4.0 * mp * mp * int(fi.nblk)))
            # H3: pht from five Hc nonzeros and P''s factored terms a row,
            # siv = v^T S^-1, the mean x + siv pht and the NIS.
            pplan = fk.frame_panels_plan(mp, d)
            stats["frame_panels"] = dict(
                max_abs_err=e3, library_ms=None,
                ms=time_ms(lambda: fk.frame_panels(*pargs), 50),
                device_ms=device_ms(lambda: fk.frame_panels(*pargs)),
                plain_ms=time_ms(lambda: fk._frame_panels_reference(*pargs), 50),
                plan=f"{pplan.width}-column panels, {pplan.panels} of {pplan.grid} blocks, "
                     f"clusters of {pplan.cluster} ({pplan.siv_block} siv entries a block)",
                **bound(nbytes(*pargs, *pk), 22.0 * mp * d + 2.0 * mp * mp))
            stats["rank_update"] = h4_measure("known", args[0], gmat, mmid, e4)
            # The whole frame on the split schedule: its four kernels'
            # operations; P in and out.
            stats["split frame"] = dict(
                ms=time_ms(lambda: fk.frame_step(*args, *tail, schedule="split"), 50),
                plain_ms=time_ms(lambda: fk.frame_step(*args, *tail, plain=True,
                                                       schedule="split"), 10),
                library_ms=None,
                **bound(nbytes(*(a for a in args if torch.is_tensor(a)), *full_k),
                        sum(stats[k]["flops"] for k in SPLIT_KERNELS)))
            stats["frame_step"] = h9_measure(device, args, tail, e9, int(fi.nblk))
    h9_sweep(device)
    stats["sweep_inverse"]["device_ms_coop"] = route_checks(device)
    log_times(stats, "")
    return stats


def log_times(stats: dict, shape: str) -> None:
    for name, st in stats.items():
        extra = ""
        if "bound_ms" in st:
            lib = st["library_ms"]
            extra = (f", bound {st['bound_ms'] * 1e3:.3f} us ({st['bound_by']}: "
                     f"{st['bytes']:,} B, {st['flops']:,.0f} flop), library "
                     + ("none" if lib is None else f"{lib:.4f} ms"))
        if "device_ms" in st:
            extra += f", device {st['device_ms'] * 1e3:.2f} us"
            if "bound_ms" in st and st["device_ms"] > 0:
                extra += f" ({100.0 * st['bound_ms'] / st['device_ms']:.2f}% of the bound)"
        if "fixed_ms" in st:
            extra += f" ({st['fixed_ms'] * 1e3:.2f} us with nblk = 0)"
        if "plan" in st:
            extra += f"; plan: {st['plan']}"
        log(f"  time {name}{shape}: kernel {st['ms']:.4f} ms, plain {st['plain_ms']:.4f} ms"
            + extra)


def gated_cases(device):
    """The gated frame at config 2's shape (a frame after 300 plain frames
    from an empty map), the same frame at the unpadded D = 1003, and a frame
    at the 10k-landmark shape (after 30 plain frames)."""
    from conan_slam_tpu_torch.filters.ekf import EKFState, init_state
    from conan_slam_tpu_torch.sim.world import config2_world

    world, cfg = config2_world(device), gated_cfg(500)
    state, [(ctrl, obs)], noise = warm_frame(device, world, cfg,
                                             init_state(500, 500, device=device), 300)
    yield "config 2, D=1024", state, cfg, (ctrl, obs, noise)
    d = 3 + 2 * 500       # the padded slots are never active: crop them
    ragged = EKFState(x=state.x[:d].clone(), p=state.p[:d, :d].contiguous(),
                      n_active=state.n_active, table=state.table)
    yield "config 2 ragged, D=1003", ragged, cfg, (ctrl, obs, noise)
    world, cfg = big_world(device), gated_cfg(BIG_LANDMARKS)
    state, [(ctrl, obs)], noise = warm_frame(
        device, world, cfg, init_state(BIG_LANDMARKS, BIG_LANDMARKS, device=device), 30)
    yield "10k landmarks, D=20224", state, cfg, (ctrl, obs, noise)


def gated_witness(p, x, slots, cap, zr, zb, mask, r_cov, bmat, vtf):
    """The gated frame in float64 through the port's independent oracle
    (dense products and a Cholesky inverse, neither H10 nor the split):
    ``FrameUpdateObs(p, x, nis)``."""
    import torch
    import torch.nn.functional as F

    from conan_slam_tpu_torch.ops import frame_kernel as fk

    rows = fk.frame_rows(slots, cap)
    f64 = torch.float64
    mp, rp = fk.frame_shapes(zr.shape[0])
    zin, rsc, _ = fk._pack_meas(zr.to(f64), zb.to(f64), mask, r_cov.to(f64), mp // 2)
    pad = rp - rows.shape[0]
    prows = F.pad(p[rows].to(f64), (0, 0, 0, pad))
    return fk._frame_update_obs_reference(p.to(f64), x.to(f64), F.pad(rows, (0, pad), value=-1),
                                          prows, zin, rsc, bmat.to(f64), vtf.to(f64), mp, rp)


def obs_ulp_bounds(uargs, got) -> dict:
    """Elementwise bounds on two fp32 routes of one gated frame
    (frame_update_obs's ``uargs``) that differ only in the order of their
    sums: H10 and the split run the same chain, sweep and pht code and sum
    M G and the mean in other orders; each rounds two nested sums of at
    most r = MP + NBP + 8 terms, each within r eps of its terms' magnitudes
    to first order, so they differ by at most 4 r eps times |P| +
    |G|^T |M| |G| for P, |x| + |xn| + |v|^T |S^-1| |pht| for the mean,
    |v|^T |S^-1| |v| for the NIS (from the plain versions)."""
    import torch

    from conan_slam_tpu_torch.ops import frame_kernel as fk
    from conan_slam_tpu_torch.ops.spd_inverse import sweep_si_reference

    p, x, slots, cap, zr, zb, mask, r, bmat, vtf = uargs
    oi = fk.obs_inputs(p, x, fk.frame_rows(slots, cap), zr, zb, mask, r, vtf)
    s, rowc, hvb = fk._obs_chain_reference(oi.zin, oi.rsc, oi.xrows, oi.prc, oi.vrows, bmat, oi.mp)
    si = sweep_si_reference(s, oi.nblk)
    pht = fk._obs_panels_reference(rowc, hvb, si, oi.prows, vtf, x)[0]
    gabs = torch.cat([vtf, pht]).abs()
    mabs = torch.block_diag(bmat.abs(), si.abs())
    vsi = rowc[:, 7].abs() @ si.abs()
    u = 4.0 * (oi.mp + bmat.shape[0] + 8) * 2.0**-23
    return dict(x=u * (x.abs() + got.x.abs() + vsi @ pht.abs()),
                p=u * (p.abs() + gabs.T @ (mabs @ gabs)), nis=u * (vsi @ rowc[:, 7].abs()))


def h10_checks(label: str, uargs, split, plain, dx_tol: float) -> float:
    """H10 at a gated frame (``frame_update_obs``'s arguments ``uargs``)
    against its plain version (``plain``) at the gated frame's tolerances
    (the mean within ``dx_tol``), against the split schedule's kernels
    (``split``) within the fp32 rounding of the sums the two order
    differently (obs_ulp_bounds); two calls bit-equal; an exactly
    symmetric P stays exactly symmetric.  Returns P's max abs error
    against the plain version."""
    import torch

    from conan_slam_tpu_torch.ops import frame_kernel as fk

    got, again = fk.frame_update_obs(*uargs), fk.frame_update_obs(*uargs)
    excess = split_excess(obs_ulp_bounds(uargs, got), got, split)
    require(max(excess.values()) <= 1.0, f"H10 {label} vs split kernels",
            "|H10 - split| over its fp32 bound (4 (MP + NBP + 8) eps x the terms' magnitudes) "
            "at most 1: " + ", ".join(f"{k} {v:.3f}" for k, v in excess.items()))
    check(f"H10 {label} vs plain: x", got.x, plain.x, 1e-6, dx_tol,
          "~5 km means, fp32 ulps, plus twice the plain version's distance from a float64 "
          "witness")
    err = check(f"H10 {label} vs plain: P", got.p, plain.p, 1e-3,
                1e-4 * max(1.0, float(plain.p.abs().max())),
                "the reference test's tolerance, on P's scale")
    check(f"H10 {label} vs plain: nis", got.nis, plain.nis, 1e-3, 1e-5,
          "the reference test's tolerance")
    require(all(torch.equal(a, b) for a, b in zip(got, again)), f"H10 {label} deterministic",
            "two calls on the same inputs are bit for bit equal")
    p = uargs[0]
    sym = fk.frame_update_obs(0.5 * (p + p.T), *uargs[1:])
    asym = float((sym.p - sym.p.T).abs().max())
    require(asym == 0.0, f"H10 {label} symmetry",
            f"symmetric P -> asym(P out) = {asym:.1e} (must be exactly 0: the upper triangle is "
            "mirrored)")
    log(f"  H10 {label}: vs split within " + ", ".join(f"{k} {v:.3f}" for k, v in excess.items())
        + f" of the fp32 bound; two calls bit-equal; asym(P) {asym:.1e}")
    return err


def h10_work(d: int, mp: int, rp: int, nbp: int, nblk: int) -> float:
    """H10's operations: the chain (as H7), the sweep over nblk pivots (as
    H1), pht = Hc P[rows] + hvb vtf and the mean (as H8), -S^-1 pht and
    B vtf, the P pass's upper triangle at r = NBP + MP (D (D + 1) r) and
    its add."""
    chain = (10.0 * mp * nbp + 2.0 * mp * nbp * nbp + 10.0 * mp * rp + 2.0 * mp * nbp * rp
             + 10.0 * mp * mp)
    return (chain + 4.0 * mp * mp * nblk + (12.0 + 2.0 * nbp) * mp * d + 2.0 * mp * mp * d
            + 2.0 * nbp * nbp * d + d * (d + 1.0) * (nbp + mp) + d * d)


def h10_phases(uargs, grid: int, launches: int = 20) -> dict:
    """H10's phases at frame_update_obs's ``uargs`` (stamp_phases)."""
    from conan_slam_tpu_torch.ops import frame_kernel as fk

    return stamp_phases("H10", lambda st: fk._obs_step_h10(*uargs, stamps=st), grid,
                        uargs[0].device, launches)


def h10_measure(device, uargs, err: float, nblk: int) -> dict:
    """H10 at config 2's check frame: CUDA-event time of the wrapper,
    device time (profiler), the plain version's time, its plan, bound and
    phases; its device time against MP (32, 128, 224 at NBP 24) and NBP
    (16, 24, 56 at MP 128) on synthetic frames at D = 1024; and the split
    schedule's device time on the same frame, in turns (H10, split, split,
    H10)."""
    import torch

    from conan_slam_tpu_torch.ops import frame_kernel as fk

    d, nz, nbp = uargs[0].shape[0], uargs[4].shape[0], uargs[8].shape[0]
    mp, rp = fk.frame_shapes(nz)
    plan = fk.obs_step_plan(d, mp, nbp, device)
    out = fk.frame_update_obs(*uargs)
    ins = [a for a in uargs if torch.is_tensor(a)]
    h10 = lambda: fk.frame_update_obs(*uargs)                     # noqa: E731
    split = lambda: fk.frame_update_obs(*uargs, schedule="split")  # noqa: E731
    turns = [device_ms(fn) for fn in (h10, split, split, h10)]
    st = dict(max_abs_err=err, library_ms=None, ms=time_ms(h10, 50),
              device_ms=device_ms(h10, kernel="obs_step_kernel"),
              plain_ms=time_ms(lambda: fk.frame_update_obs(*uargs, plain=True), 10),
              split_ms=time_ms(split, 50), device_ms_turns=turns,
              plan=f"grid {plan.grid} x {plan.block} threads, {plan.smem:,} B shared; "
                   f"{plan.bands} chain bands, {plan.panels} panels, {plan.tiles} tiles of "
                   f"{plan.tile}",
              **bound(nbytes(*ins, *out), h10_work(d, mp, rp, nbp, nblk)))
    log(f"  H10 vs split, device time of a call in turns (all its kernels and copies): "
        + ", ".join(f"{n} {t * 1e3:.2f} us" for n, t in zip(("H10", "split", "split", "H10"),
                                                             turns)))
    by_mp, by_nbp = {}, {}
    for nz_, s, h in ((16, 6, True), (64, 6, True), (112, 6, True), (64, 6, False),
                      (64, 18, True)):
        a = synthetic_gated(device, 1024, nz_, s, h)
        t = device_ms(lambda: fk.frame_update_obs(*a), kernel="obs_step_kernel")
        if (s, h) == (6, True):
            by_mp[fk.frame_shapes(nz_)[0]] = t
        if nz_ == 64:
            by_nbp[a[8].shape[0]] = t
    st.update(device_ms_by_mp=by_mp, device_ms_by_nbp=by_nbp,
              phases_us=h10_phases(uargs, plan.grid))
    log("  H10 device time against MP (NBP 24): " + ", ".join(
        f"MP={m} {t * 1e3:.2f} us" for m, t in by_mp.items()) + "; against NBP (MP 128): "
        + ", ".join(f"NBP={k} {t * 1e3:.2f} us" for k, t in sorted(by_nbp.items())))
    return st


def gated_kernel_checks(device) -> dict:
    """Phase 3b: the gated frame's kernels against their plain versions.
    Each kernel is fed its plain upstream's outputs."""
    import torch

    from conan_slam_tpu_torch.filters.ekf.associate import _innovation_blocks, gated_scores_dense
    from conan_slam_tpu_torch.ops import frame_kernel as fk
    from conan_slam_tpu_torch.ops.factor_kernel import (
        _frame_factors_reference,
        frame_factors_fused,
    )
    from conan_slam_tpu_torch.ops.gating_kernel import _gating_scores_reference, gating_scores
    from conan_slam_tpu_torch.ops.rank_update import rank_update_t, rank_update_t_reference
    from conan_slam_tpu_torch.ops.spd_inverse import sweep_si, sweep_si_reference

    stats = {}
    for label, state, cfg, (ctrl, obs, noise) in gated_cases(device):
        d, k = state.x.shape[0], state.capacity
        log(f"gated frame kernels at {label} (D={d}, K={k}, NZ={obs.z.shape[0]}, "
            f"mapped={int(state.n_active)}):")
        fargs = (state, *ctrl, noise.qe, cfg.wheel_base, cfg.dt_controls, cfg.sigma_heading,
                 cfg.switch_heading_known)
        fk_k = frame_factors_fused(*fargs)
        st1, pt, vtf, bmat = _frame_factors_reference(*fargs)
        check(f"H5 {label} pose trace", fk_k[1], pt, 1e-6, 1e-4,
              "~5 km positions: a few fp32 ulps (4.9e-4 m), sinf/cosf vs torch")
        check(f"H5 {label} post-frame mean", fk_k[0].x, st1.x, 1e-6, 1e-3,
              "~5 km means: fp32 ulps")
        e5 = check(f"H5 {label} vtf", fk_k[2], vtf, 1e-3, 1e-5 * float(vtf.abs().max()),
                   "the heading gains carry the recursion's amplified fp32 cancellation "
                   "(r ~ 3e-8), as H2's K4")
        check(f"H5 {label} B", fk_k[3], bmat, 1e-6, 1e-7, "constants and a copy of P[2, 2]")

        # H6 on the virtual covariance P + vtf^T B vtf, as the frame loop runs it.
        blocks = [b.contiguous() for b in _innovation_blocks(st1, vtf.T, bmat)]
        gargs = (obs.z.contiguous(), st1.pose, st1.features, st1.active_mask, *blocks,
                 noise.re, cfg.gate_reject)
        nd_k, j_k, mn_k = gating_scores(*gargs)
        nd_p, j_p, mn_p = _gating_scores_reference(*gargs)
        found_k, found_p = nd_k < 1e38, nd_p < 1e38
        nis_tol = lambda v: 1e-3 + 1e-4 * v.abs()  # noqa: E731
        # The runner-up's nd and every slot's nis, from the dense scores.
        nis_d, nd_d = gated_scores_dense(st1, obs.z, noise.re, vtf.T, bmat)
        nd_g = torch.where(nis_d < cfg.gate_reject, nd_d, torch.inf)
        two = nd_g.topk(2, dim=1, largest=False).values
        tie = (two[:, 1] - two[:, 0]) <= nis_tol(two[:, 0])
        gate_r, gate_a = torch.tensor(cfg.gate_reject), torch.tensor(cfg.gate_augment)
        near_reject = ((nis_d - cfg.gate_reject).abs() <= nis_tol(gate_r)).any(dim=1)
        near_augment = (mn_p - cfg.gate_augment).abs() <= nis_tol(gate_a)
        both = found_k & found_p
        e6 = check(f"H6 {label} best nd", nd_k[both], nd_p[both], 1e-4, 1e-3,
                   "same algebra; atan2f/remainder wrap and FMA contraction: ulps of "
                   "km-scale predictions, ~1e-4 of a NIS")
        check(f"H6 {label} min nis", mn_k, mn_p, 1e-4, 1e-3, "as best nd")
        valid = obs.mask
        require(bool(((found_k == found_p) | near_reject | ~valid).all()), f"H6 {label} found",
                f"equal except within tolerance of gate_reject ({int((near_reject & valid).sum())} "
                "valid measurements that close)")
        new_k = valid & ~found_k & (mn_k > cfg.gate_augment)
        new_p = valid & ~found_p & (mn_p > cfg.gate_augment)
        require(bool(((new_k == new_p) | near_augment | near_reject | ~valid).all()),
                f"H6 {label} new", f"equal except within tolerance of gate_augment "
                f"({int((near_augment & valid).sum())} valid measurements that close)")
        exact = both & ~tie
        require(bool((j_k[exact] == j_p[exact]).all()), f"H6 {label} best slot",
                f"equal on {int(exact.sum())} measurements whose runner-up is further than "
                f"the tolerance ({int((both & tie).sum())} near-ties left out)")

        slots = torch.where(found_p, j_p.to(torch.int64), 0)
        mask = obs.mask & found_p
        rows = fk.frame_rows(slots, k)
        oi = fk.obs_inputs(st1.p, st1.x, rows, obs.z[:, 0], obs.z[:, 1], mask, noise.re, vtf)
        chain = (oi.zin, oi.rsc, oi.xrows, oi.prc, oi.vrows, bmat, oi.mp)
        s_k, rowc_k, hvb_k = fk.obs_chain(*chain)
        s_p, rowc_p, hvb_p = fk._obs_chain_reference(*chain)
        e7 = check(f"H7 {label} S", s_k, s_p, 1e-3, 1e-6 * float(s_p.abs().max()),
                   "compact vs dense Hc products, fp32 order")
        check(f"H7 {label} Hc", rowc_k[:, :7], rowc_p[:, :7], 1e-3, 1e-6,
              "sqrtf/divisions vs torch, fp32 contraction")
        check(f"H7 {label} innovation v", rowc_k[:, 7], rowc_p[:, 7], 0.0, 5e-4,
              "z - |d| at ranges up to 2 km: a few fp32 ulps of the range (1.2e-4 m)")
        check(f"H7 {label} hvb", hvb_k, hvb_p, 1e-3, 1e-6 * float(hvb_p.abs().max()),
              "NBP-term sums in another order")
        si_k = sweep_si(s_p, oi.nblk)
        si_p = sweep_si_reference(s_p, oi.nblk)
        e1 = check(f"H1 {label} S^-1", si_k, si_p, 1e-3, 1e-5 * float(si_p.abs().max()),
                   "same sweep on the frame's S, fp32 contraction")
        pan = (rowc_p, hvb_p, si_p, oi.prows, vtf, st1.x)
        pk = fk.obs_panels(*pan)
        pp = fk._obs_panels_reference(*pan)
        e8 = check(f"H8 {label} pht", pk[0], pp[0], 1e-4, 1e-6 * float(pp[0].abs().max()),
                   "5 + NBP-term vs dense products")
        check(f"H8 {label} xn", pk[1], pp[1], 1e-6, 1e-3, "~5 km means: fp32 ulps")
        check(f"H8 {label} nis", pk[2], pp[2], 1e-4, 1e-5, "fp32 reduction order")
        gmat, mmid = torch.cat([vtf, pp[0]]), torch.block_diag(bmat, -si_p)
        pu_k = rank_update_t(st1.p, gmat, mmid)
        pu_p = rank_update_t_reference(st1.p, gmat, mmid)
        e4 = check(f"H4 {label} P + G^T M G (r={gmat.shape[0]})", pu_k, pu_p, 1e-4,
                   1e-6 * float(pu_p.abs().max()),
                   "fp32 sums over r terms whose products reach P's largest prior")
        uargs = (st1.p, st1.x, slots, k, obs.z[:, 0], obs.z[:, 1], mask, noise.re, bmat, vtf)
        full_k = fk.frame_update_obs(*uargs, schedule="split")
        full_p = fk.frame_update_obs(*uargs, plain=True, schedule="split")
        # The mean's correction siv pht carries S's fp32 rounding through
        # S^-1, amplified by S's condition number, in any order of the
        # products.  An independent float64 witness measures how far the
        # fp32 plain version lies from the exact mean (e_plain); the kernel
        # must lie no further than twice that from both, plus fp32 ulps.
        wit = gated_witness(*uargs)
        e_plain = float((full_p.x.double() - wit.x).abs().max())
        dx_tol = 2e-3 + 2.0 * e_plain
        log(f"  float64 witness at {label}: |x - x64| plain {e_plain:.3e}, kernel "
            f"{float((full_k.x.double() - wit.x).abs().max()):.3e}; |P - P64| plain "
            f"{float((full_p.p.double() - wit.p).abs().max()):.3e}, kernel "
            f"{float((full_k.p.double() - wit.p).abs().max()):.3e}")
        check(f"gated frame {label} vs float64 witness: x", full_k.x, wit.x, 1e-6, dx_tol,
              "~5 km means, fp32 ulps, plus twice the fp32 plain version's own distance "
              "from the witness")
        check(f"gated frame {label} vs plain: x", full_k.x, full_p.x, 1e-6, dx_tol,
              "as against the witness")
        del wit
        check(f"gated frame {label} vs plain: P", full_k.p, full_p.p, 1e-3,
              1e-4 * max(1.0, float(full_p.p.abs().max())),
              "the reference test's tolerance, on P's scale")
        check(f"gated frame {label} vs plain: nis", full_k.nis, full_p.nis, 1e-3, 1e-5,
              "the reference test's tolerance")
        # H10, the default route, against its plain version and the split's
        # kernels.
        h10_plain = fk.frame_update_obs(*uargs, plain=True)
        e10 = h10_checks(label, uargs, full_k, h10_plain, dx_tol)
        # The factored frame equals slice 1's frame on the same rows:
        # P + vtf^T B vtf = P + U K4 U^T.
        fs = fk.frame_step(state.p, state.x, slots, k, *ctrl, noise.qe, obs.z[:, 0], obs.z[:, 1],
                           mask, noise.re, cfg.wheel_base, cfg.dt_controls, cfg.sigma_heading,
                           cfg.switch_heading_known)
        fu = fk.frame_update_obs(st1.p, fk_k[0].x, slots, k, obs.z[:, 0], obs.z[:, 1], mask,
                                 noise.re, fk_k[3], fk_k[2])
        check(f"cross {label} frame_update_obs vs frame_step: pose trace", fk_k[1],
              fs.pose_trace, 1e-6, 1e-3, "~5 km positions, fp32 ulps")
        check(f"cross {label} frame_update_obs vs frame_step: x", fu.x, fs.x, 1e-6, 2e-3,
              "~5 km means, fp32 ulps")
        check(f"cross {label} frame_update_obs vs frame_step: P", fu.p, fs.p, 1e-3,
              1e-4 * max(1.0, float(fs.p.abs().max())),
              "two factorizations of the same P', fp32; on P's scale")
        check(f"cross {label} frame_update_obs vs frame_step: nis", fu.nis, fs.nis, 1e-3, 1e-5,
              "the reference test's tolerance")
        if label.startswith("config 2, D=1024"):
            mp, nbp, rp = oi.mp, bmat.shape[0], oi.prows.shape[0]
            nz = obs.z.shape[0]
            nb = 2 + 2 * ctrl[0].shape[0] + (ctrl[0].shape[0] if cfg.switch_heading_known else 0)
            # H5: NB factor columns of four terms each, and the mean.
            stats["factor_strip"] = dict(
                max_abs_err=e5, ms=time_ms(lambda: frame_factors_fused(*fargs), 50),
                # The kernel alone: the wrapper also packs the controls.
                device_ms=device_ms(lambda: frame_factors_fused(*fargs),
                                    kernel="factor_strip_kernel"),
                plain_ms=time_ms(lambda: _frame_factors_reference(*fargs), 10), library_ms=None,
                **bound(nbytes(*ctrl, noise.qe, state.x, state.p[2], fk_k[0].x, *fk_k[1:]),
                        8.0 * nb * d + 2.0 * d))
            # H6: each slot's 2x2 innovation covariance and its geometry
            # (~70 operations), then ~15 a measurement-slot pair.
            stats["gating_scores"] = dict(
                max_abs_err=e6, ms=time_ms(lambda: gating_scores(*gargs), 50),
                plain_ms=time_ms(lambda: _gating_scores_reference(*gargs), 10), library_ms=None,
                **bound(nbytes(*(a for a in gargs if torch.is_tensor(a)), nd_k, j_k, mn_k),
                        70.0 * k + 15.0 * nz * k))
            # H7: hvb = (Hc vrows^T) B, psub = Hc prc + hvb vrows (five Hc
            # nonzeros a row), S = psub Hc^T.
            stats["obs_chain"] = dict(
                max_abs_err=e7, ms=time_ms(lambda: fk.obs_chain(*chain), 50),
                plain_ms=time_ms(lambda: fk._obs_chain_reference(*chain), 10), library_ms=None,
                **bound(nbytes(*chain[:6], s_k, rowc_k, hvb_k),
                        10.0 * mp * nbp + 2.0 * mp * nbp * nbp + 10.0 * mp * rp
                        + 2.0 * mp * nbp * rp + 10.0 * mp * mp))
            # H8: pht = Hc P[rows] + hvb vtf, siv, the mean and the NIS.
            stats["obs_panels"] = dict(
                max_abs_err=e8, ms=time_ms(lambda: fk.obs_panels(*pan), 50),
                plain_ms=time_ms(lambda: fk._obs_panels_reference(*pan), 10), library_ms=None,
                **bound(nbytes(*pan, *pk), 10.0 * mp * d + 2.0 * mp * nbp * d + 2.0 * mp * d
                        + 2.0 * mp * mp))
            stats["gated sweep_inverse"] = dict(
                max_abs_err=e1, ms=time_ms(lambda: sweep_si(s_p, oi.nblk), 50),
                device_ms=device_ms(lambda: sweep_si(s_p, oi.nblk)),
                plain_ms=time_ms(lambda: sweep_si_reference(s_p, oi.nblk), 5),
                library_ms=time_ms(lambda: torch.linalg.inv(s_p), 50),
                **bound(nbytes(s_p, oi.nblk, si_k), 4.0 * mp * mp * int(oi.nblk)))
            stats["gated rank_update"] = h4_measure("config 2", st1.p, gmat, mmid, e4)
            stats["frame_update_obs"] = dict(
                ms=time_ms(lambda: fk.frame_update_obs(*uargs, schedule="split"), 50),
                plain_ms=time_ms(lambda: fk.frame_update_obs(*uargs, plain=True,
                                                             schedule="split"), 10))
            stats["obs_step"] = h10_measure(device, uargs, e10, int(oi.nblk))
        if label.startswith("10k"):
            # H10 against the split at the 10k-landmark shape, where the P
            # pass dominates: each call's device time in turns.
            h10 = lambda: fk.frame_update_obs(*uargs)                     # noqa: E731
            split = lambda: fk.frame_update_obs(*uargs, schedule="split")  # noqa: E731
            turns = [device_ms(fn, iters=5) for fn in (h10, split, split, h10)]
            big = bound(nbytes(*(a for a in uargs if torch.is_tensor(a)), *full_k),
                        h10_work(d, oi.mp, oi.prows.shape[0], bmat.shape[0], int(oi.nblk)))
            plan = fk.obs_step_plan(d, oi.mp, bmat.shape[0], device)
            stats["obs_step"].update(
                device_ms_10k=device_ms(h10, iters=5, kernel="obs_step_kernel"),
                device_ms_turns_10k=turns, bound_ms_10k=big["bound_ms"],
                bound_by_10k=big["bound_by"], tile_10k=plan.tile,
                phases_us_10k=h10_phases(uargs, plan.grid, launches=5))
            log(f"  H10 vs split at {label}, device time of a call in turns (all its kernels "
                "and copies): " + ", ".join(
                    f"{n} {t * 1e3:.2f} us" for n, t in zip(("H10", "split", "split", "H10"),
                                                             turns))
                + f"; H10 alone {stats['obs_step']['device_ms_10k'] * 1e3:.2f} us "
                f"(P-pass tile {plan.tile}), bound {big['bound_ms'] * 1e3:.2f} us "
                f"({big['bound_by']})")
    log_times(stats, " (config 2 shape)")
    return stats


def pair_case(device, n_warm_frames: int, pad_multiple: int):
    """Two consecutive frames at the bench shape after ``n_warm_frames``
    plain frames, as frame_step_pair takes them, and each frame's slots and
    the capacity (frame_step's)."""
    from conan_slam_tpu_torch.config import SlamConfig
    from conan_slam_tpu_torch.filters.ekf import associate_known
    from conan_slam_tpu_torch.ops.frame_kernel import frame_rows

    cfg = SlamConfig(max_landmarks=N_LANDMARKS, max_obs=64, enable_augment=False)
    world, state0 = bench_world(device, pad_multiple)
    state, frames, noise = warm_frame(device, world, cfg, state0, n_warm_frames, n_next=2)
    per_frame, slots = [], []
    for ctrl, obs in frames:
        assoc = associate_known(state, obs)      # one table for both frames
        per_frame += [frame_rows(assoc.slots, state.capacity), ctrl,
                      (obs.z[:, 0], obs.z[:, 1], assoc.known_mask)]
        slots.append(assoc.slots)
    return ((state.p, state.x, *per_frame, noise.qe, noise.re, cfg.wheel_base, cfg.dt_controls,
             cfg.sigma_heading, cfg.switch_heading_known), *slots, state.capacity)


def pair_checks(device) -> dict:
    """Phase 3c: the frame pair against its plain version and against two
    sequential kernel frames, and H4 at the pair's rank."""
    import torch

    from conan_slam_tpu_torch.ops import frame_kernel as fk
    from conan_slam_tpu_torch.ops.rank_update import rank_update_t, rank_update_t_reference

    stats = {}
    for pad, label in ((256, "D=2304"), (0, "D=2051 ragged")):
        args, slots_a, slots_b, cap = pair_case(device, 30, pad)
        (p, x, rows_a, ctrl_a, meas_a, rows_b, ctrl_b, meas_b, q, r, *tail) = args
        log(f"frame pair at {label} (D={p.shape[0]}, NZ=64):")
        got = fk.frame_step_pair(*args)
        plain = fk.frame_step_pair(*args, plain=True)
        fa = fk.frame_step(p, x, slots_a, cap, *ctrl_a, q, *meas_a, r, *tail)
        fb = fk.frame_step(fa.p, fa.x, slots_b, cap, *ctrl_b, q, *meas_b, r, *tail)
        two = fk.FramePair(p=fb.p, x=fb.x, pose_trace=torch.stack([fa.pose_trace, fb.pose_trace]),
                           nis=torch.stack([fa.nis, fb.nis]), pose_mid=fa.x[:3])
        # Frame B reads strips rebuilt from frame A's (G, M): against two
        # frames its rounding differs there too, inside the same bounds.
        for ref_name, ref in (("plain pair", plain), ("two kernel frames", two)):
            for k, frame in enumerate("AB"):
                check(f"pair {label} vs {ref_name}: pose trace {frame}", got.pose_trace[k],
                      ref.pose_trace[k], 1e-6, 1e-3, "~5 km positions, fp32 ulps")
            check(f"pair {label} vs {ref_name}: pose_mid", got.pose_mid, ref.pose_mid, 1e-6, 2e-3,
                  "frame A's updated pose: ~5 km means, fp32 ulps")
            check(f"pair {label} vs {ref_name}: x", got.x, ref.x, 1e-6, 2e-3,
                  "~5 km means, fp32 ulps")
            check(f"pair {label} vs {ref_name}: P", got.p, ref.p, 1e-3, 1e-4,
                  "the reference test's tolerance")
            check(f"pair {label} vs {ref_name}: nis", got.nis, ref.nis, 1e-3, 1e-5,
                  "the reference test's tolerance")
        if pad != 256:
            continue
        # H4 at r = 2 (MP + 8) on frame A's and frame B's (G, M), each
        # from the plain chain: B's against the materialised P_A.
        gms, chain_flops = [], 0.0
        for pp, xx, rows, ctrl, meas in ((p, x, rows_a, ctrl_a, meas_a),
                                         (fa.p, fa.x, rows_b, ctrl_b, meas_b)):
            fi = fk.frame_inputs(pp, xx, rows, *ctrl, q, *meas, r)
            ch, si, pht, _, _ = fk._frame_measure(fi, xx, tail, True)
            gms.append(fk._frame_gm(pht, si, ch.k4[:4, :4], fi.prows[2:3], fi.mp))
            mp, rp, d = fi.mp, fi.rp, pp.shape[0]
            # H2, H1 and H3 of this frame, counted as in kernel_checks.
            chain_flops += (20.0 * mp * rp + 10.0 * mp * mp + 4.0 * mp * mp * int(fi.nblk)
                            + 22.0 * mp * d + 2.0 * mp * mp)
        gmat, mmid = torch.cat([gms[0][0], gms[1][0]]), torch.block_diag(gms[0][1], gms[1][1])
        pu_k = rank_update_t(p, gmat, mmid)
        pu_p = rank_update_t_reference(p, gmat, mmid)
        e4 = check(f"H4 {label} P + G^T M G (r={gmat.shape[0]})", pu_k, pu_p, 1e-4, 1e-6,
                   "fp32 FMA over r terms vs cuBLAS fp32")
        stats["pair rank_update"] = h4_measure("pair", p, gmat, mmid, e4)
        def two_frames():
            a = fk.frame_step(p, x, slots_a, cap, *ctrl_a, q, *meas_a, r, *tail)
            return fk.frame_step(a.p, a.x, slots_b, cap, *ctrl_b, q, *meas_b, r, *tail)

        # The whole pair: both frames' chains and panels, M_A G_A, the
        # strip rebuild, M_B G_B and the one pass at r = 2 (MP + 8); P in
        # and out once.
        r1 = gms[0][0].shape[0]
        stats["frame_step_pair"] = dict(
            ms=time_ms(lambda: fk.frame_step_pair(*args), 50),
            plain_ms=time_ms(lambda: fk.frame_step_pair(*args, plain=True), 10),
            two_frames_ms=time_ms(two_frames, 50), library_ms=None,
            **bound(nbytes(p, x, rows_a, *ctrl_a, *meas_a, rows_b, *ctrl_b, *meas_b, q, r, *got),
                    chain_flops + 2 * 2.0 * r1 * r1 * d + 2.0 * rp * r1 * d
                    + 2.0 * d * d * 2 * r1 + d * d))
    log_times(stats, " (bench shape)")
    log(f"  time two kernel frame_step calls (bench shape): "
        f"{stats['frame_step_pair']['two_frames_ms']:.4f} ms")
    return stats


def probe_checks(device) -> dict:
    """Phase 3d, first half: each probe kernel (H11-H14, H4's probe entry)
    against its plain version on the card at the probes' shapes, with its
    time, its plain version's, the library call's and its bound."""
    import torch

    from conan_slam_tpu_torch.benchmarks.probe_mosaic import dots_inputs, observe_inputs
    from conan_slam_tpu_torch.benchmarks.probe_sweep import probe_matrix
    from conan_slam_tpu_torch.ops import probes as pr
    from conan_slam_tpu_torch.ops.rank_update import (
        rank_update_plan,
        rank_update_vbt,
        rank_update_vbt_reference,
    )
    from conan_slam_tpu_torch.ops.spd_inverse import sweep_si

    stats = {}
    eps = torch.finfo(torch.float32).eps

    # --- H11 at the sweep probe's shape (MP 128, NBLK 40), and NBLK 39 (R6) ---
    mp = 128
    s_np = probe_matrix(mp)
    s_np = 0.5 * (s_np + s_np.T)
    np.fill_diagonal(s_np, 1.0)      # H1's scaling and symmetrization are then the identity
    s = torch.as_tensor(s_np, device=device)
    log(f"H11 sweep_probe, MP {mp} (S exactly symmetric, unit diagonal):")
    worst = 0.0
    for nblk in (40, 39):
        k = 2 * nblk
        h1 = sweep_si(s, torch.tensor([nblk], dtype=torch.int32, device=device))
        inv = torch.as_tensor(np.linalg.inv(s_np[:k, :k].astype(np.float64)), device=device)
        for variant in pr.SWEEP_VARIANTS:
            got = pr.sweep_probe(s, nblk, variant)
            plain = pr.sweep_probe_reference(s, nblk, variant)
            tol = 4 * mp * eps * float(h1[:k, :k].abs().max())
            if variant != "wide4":
                require(torch.equal(0.5 * (got + got.T), h1), f"H11 {variant} nblk={nblk} vs H1",
                        "sym(H11) bit for bit H1, which symmetrizes after its sweep (the same "
                        "fmaf chain a pivot)")
            worst = max(worst, check(f"H11 {variant} nblk={nblk} vs plain", got, plain, 0.0, tol,
                                     "the probe's algebra, another fp32 order: 4 MP eps x "
                                     "max|swept block|"))
            check(f"H11 {variant} nblk={nblk} swept block vs float64 inverse", got[:k, :k], inv,
                  0.0, 1e-4, "the probe's own gate")
        require(torch.equal(pr.sweep_probe(s, nblk, "wide4"), pr.sweep_probe(s, nblk, "wide4")),
                f"H11 wide4 nblk={nblk} deterministic", "two calls bit for bit equal")
    # The symmetry property of tests/test_pallas_ops.py:83 (an S with an
    # antisymmetric 1e-3 part): H11 sweeps what it is given, so it is
    # given sym(S), scaled to a unit diagonal, as H1 forms it.
    rng = np.random.default_rng(5)
    a = rng.normal(size=(mp, mp)).astype(np.float32)
    e = rng.normal(size=(mp, mp)).astype(np.float32) * 1e-3
    s_asym = (a @ a.T / mp + np.eye(mp, dtype=np.float32) + (e - e.T)).astype(np.float64)
    s_sym = 0.5 * (s_asym + s_asym.T)
    dsc = 1.0 / np.sqrt(np.diag(s_sym))
    s_sc = torch.as_tensor((s_sym * dsc[:, None] * dsc[None, :]).astype(np.float32), device=device)
    inv = torch.as_tensor(np.linalg.inv(s_sc.double().cpu().numpy()), device=device)
    for variant in pr.SWEEP_VARIANTS:
        got = pr.sweep_probe(s_sc, mp // 2, variant)
        asym = float((got - got.T).abs().max())
        require(asym < 1e-6, f"H11 {variant} symmetry",
                f"sym(S) in -> asym(S^-1) = {asym:.1e} < 1e-6 (the harness's bound)")
        check(f"H11 {variant} symmetry harness vs inverse", got, inv, 5e-3, 1e-4,
              "the harness's bounds")
    nb40 = 40
    fn = lambda: pr.sweep_probe(s, nb40, "wide4")        # noqa: E731
    st = dict(max_abs_err=worst, ms=time_ms(fn, 200),
              plain_ms=time_ms(lambda: pr.sweep_probe_reference(s, nb40, "wide4"), 5),
              library_ms=time_ms(lambda: torch.linalg.inv_ex(s), 200), device_ms=device_ms(fn),
              **bound(2 * nbytes(s), nb40 * 4.0 * mp * mp))
    # Each variant at NBLK 40 and at NBLK 0 (its load and store alone): the
    # difference over 40 is its time a pivot.
    h1_nb = {n: torch.tensor([n], dtype=torch.int32, device=device) for n in (0, nb40)}
    st["variants_device_ms"], st["variants_fixed_ms"] = {}, {}
    for v in pr.SWEEP_VARIANTS + ("v0 (H1)",):
        for n, key in ((nb40, "variants_device_ms"), (0, "variants_fixed_ms")):
            fn = ((lambda n=n: sweep_si(s, h1_nb[n])) if v == "v0 (H1)"
                  else (lambda v=v, n=n: pr.sweep_probe(s, n, v)))
            st[key][v] = device_ms(fn)
    log("  H11 device time at NBLK 40 (profiler): " + ", ".join(
        f"{k} {t * 1e3:.2f} us ({st['variants_fixed_ms'][k] * 1e3:.2f} at NBLK 0: "
        f"{(t - st['variants_fixed_ms'][k]) * 1e3 / nb40:.3f} us a pivot)"
        for k, t in st["variants_device_ms"].items()))
    stats["sweep_probe"] = st

    # --- H12 at the rank-pass probe's D (2304) ---
    d = 2304
    x = torch.randn((d, d), device=device, generator=torch.Generator(device).manual_seed(12))
    out = torch.empty_like(x)
    got = pr.stream_copy(x)
    require(torch.equal(got, x), "H12 stream_copy", "bit for bit the input (D 2304)")
    fn = lambda: pr.stream_copy(x)                        # noqa: E731
    st = dict(max_abs_err=0.0, ms=time_ms(fn, 200), plain_ms=time_ms(lambda: x.clone(), 200),
              library_ms=time_ms(lambda: out.copy_(x), 200), device_ms=device_ms(fn),
              library_device_ms=device_ms(lambda: out.copy_(x)), **bound(2 * nbytes(x), 0.0))
    st["tb_per_s"] = 2 * nbytes(x) / (st["device_ms"] * 1e-3) / 1e12
    st["library_tb_per_s"] = 2 * nbytes(x) / (st["library_device_ms"] * 1e-3) / 1e12
    log(f"  H12 at D {d}: {st['device_ms'] * 1e3:.2f} us of device time = {st['tb_per_s']:.3f} "
        f"TB/s (Tensor.copy_ {st['library_device_ms'] * 1e3:.2f} us = "
        f"{st['library_tb_per_s']:.3f} TB/s) against the 3.35 TB/s spec "
        f"({st['bound_ms'] * 1e3:.2f} us); P's 21 MB in and out fit the 50 MB L2")
    # Past the L2: a (4 D)^2 copy, 340 MB in and out, from device memory.
    big = torch.randn((4 * d, 4 * d), device=device,
                      generator=torch.Generator(device).manual_seed(13))
    big_out = torch.empty_like(big)
    require(torch.equal(pr.stream_copy(big), big), "H12 stream_copy past L2", "bit for bit")
    t_big = device_ms(lambda: pr.stream_copy(big))
    t_big_lib = device_ms(lambda: big_out.copy_(big))
    st["tb_per_s_past_l2"] = 2 * nbytes(big) / (t_big * 1e-3) / 1e12
    st["library_tb_per_s_past_l2"] = 2 * nbytes(big) / (t_big_lib * 1e-3) / 1e12
    log(f"  H12 at D {4 * d} (past L2): {t_big * 1e3:.2f} us = {st['tb_per_s_past_l2']:.3f} TB/s "
        f"(Tensor.copy_ {t_big_lib * 1e3:.2f} us = {st['library_tb_per_s_past_l2']:.3f} TB/s)")
    del big, big_out
    stats["stream_copy"] = st

    # --- H13 at the dots probe's shape ---
    args = [torch.as_tensor(a, device=device) for a in dots_inputs()]
    got, ref = pr.probe_dots(*args), pr.probe_dots_reference(*args)
    err = max(check(f"H13 probe_dots {n}", g, r, 0.0, 1e-5 * float(r.abs().max()),
                    "sums of 136 / 128 products in another order: 1e-5 of max|ref|")
              for n, g, r in zip(("phtt", "sipht", "sivpht"), got, ref))
    dd, mpd, rpd = args[0].shape[1], args[1].shape[0], args[1].shape[1]

    def dots_lib():
        phtt = torch.matmul(args[0].T, args[1].T)
        return phtt, torch.matmul(args[2], phtt.T), torch.matmul(args[3], phtt.T)
    fn = lambda: pr.probe_dots(*args)                     # noqa: E731
    st = dict(max_abs_err=err, ms=time_ms(fn, 200),
              plain_ms=time_ms(lambda: pr.probe_dots_reference(*args), 200),
              library_ms=time_ms(dots_lib, 200), device_ms=device_ms(fn),
              **bound(nbytes(*args, *got), 2.0 * dd * mpd * rpd + 2.0 * mpd * mpd * dd
                      + 2.0 * mpd * dd))
    stats["probe_dots"] = st

    # --- H14 at the observe probe's inputs, both paths ---
    (xrows, zin, rsc, mpo, rpo), refs = observe_inputs()
    args = [torch.as_tensor(a, device=device) for a in (xrows, zin, rsc)]
    plain = pr.probe_observe_reference(*args, mpo, rpo)
    err = 0.0
    for path in pr.OBSERVE_PATHS:
        got = pr.probe_observe(*args, mpo, rpo, path)
        for (name, tol), g, p_, r in zip((("hc", 1e-4), ("rmat", 1e-5), ("v", 1e-4)), got,
                                         plain, refs):
            err = max(err, check(f"H14 {path} {name} vs plain", g, p_, 1e-5,
                                 1.6e-5 if name == "v" else 1e-6,
                                 "atan2f, sqrtf and divisions against torch's: a few ulps; v's "
                                 "range rows are differences of ~60 m ranges (2 ulps of 64 m)"))
            check(f"H14 {path} {name} vs numpy", g, torch.as_tensor(r, device=device), 0.0, tol,
                  "the probe's own tolerance")
    fn = lambda: pr.probe_observe(*args, mpo, rpo, "gated")     # noqa: E731
    st = dict(max_abs_err=err, ms=time_ms(fn, 200),
              plain_ms=time_ms(lambda: pr.probe_observe_reference(*args, mpo, rpo), 20),
              library_ms=None, device_ms=device_ms(fn),
              **bound(nbytes(*args, *plain), 40.0 * mpo // 2))
    st["known_device_ms"] = device_ms(lambda: pr.probe_observe(*args, mpo, rpo, "known"))
    stats["probe_observe"] = st

    # --- H4's probe entry at the rank-pass probe's shape (D 2304, r 288) ---
    r = 288
    g = torch.Generator(device).manual_seed(4)
    p = torch.randn((d, d), device=device, generator=g)
    vt = torch.randn((r, d), device=device, generator=g) * 1e-2
    b = torch.randn((r, r), device=device, generator=g)
    vbt = (0.5 * (b + b.T)) @ vt
    tile, grid = rank_update_plan(d, device)
    default = rank_update_vbt(p, vt, vbt)
    require(torch.equal(pr.rank_update_tile(p, vt, vbt, tile, grid), default),
            "H4 probe entry at the plan", f"tile {tile}, grid {grid}: bit for bit H4's default")
    ref = rank_update_vbt_reference(p, vt, vbt)
    err = 0.0
    for t in pr.RANK_TILES:
        for gr in (0, grid):
            err = max(err, check(f"H4 probe entry tile {t} grid {gr or 'one a tile'}",
                                 pr.rank_update_tile(p, vt, vbt, t, gr), ref, 1e-5, 1e-4,
                                 "fp32 sums of 288 products in another order"))
        check(f"H4 probe entry tile {t}, no P read", pr.rank_update_tile(None, vt, vbt, t),
              pr.rank_update_tile_reference(None, vt, vbt), 1e-5, 1e-4,
              "fp32 sums of 288 products in another order")
    fn = lambda: pr.rank_update_tile(p, vt, vbt, tile, grid)      # noqa: E731
    st = dict(max_abs_err=err, ms=time_ms(fn, 50),
              plain_ms=time_ms(lambda: rank_update_vbt_reference(p, vt, vbt), 50),
              library_ms=time_ms(lambda: torch.addmm(p, vt.T, vbt), 50), device_ms=device_ms(fn),
              **rank_update_entry_work(p, vt, vbt))
    st["device_ms_by_tile"] = {
        f"{t}, {'persistent' if gr else 'one a tile'}":
            device_ms(lambda t=t, gr=gr: pr.rank_update_tile(p, vt, vbt, t, gr))
        for t in pr.RANK_TILES for gr in (0, grid)}
    st["no_p_device_ms_by_tile"] = {
        t: device_ms(lambda t=t: pr.rank_update_tile(None, vt, vbt, t)) for t in pr.RANK_TILES}
    # mmonly's plain version and torch.mm, and make_stacked's one pass at
    # rank 3 r (H4's default entry) against its plain version and addmm.
    st["no_p_plain_ms"] = time_ms(lambda: pr.rank_update_tile_reference(None, vt, vbt), 50)
    st["no_p_library_ms"] = time_ms(lambda: torch.mm(vt.T, vbt), 50)
    st["no_p_library_device_ms"] = device_ms(lambda: torch.mm(vt.T, vbt))
    g3, m3 = torch.cat([vt] * 3), torch.cat([vbt] * 3)
    st["stack3"] = dict(device_ms=device_ms(lambda: rank_update_vbt(p, g3, m3)),
                        plain_ms=time_ms(lambda: rank_update_vbt_reference(p, g3, m3), 20),
                        library_ms=time_ms(lambda: torch.addmm(p, g3.T, m3), 20),
                        library_device_ms=device_ms(lambda: torch.addmm(p, g3.T, m3)),
                        **rank_update_entry_work(p, g3, m3))
    log(f"  H4 at rank 3 r = {3 * r} (stack3): {st['stack3']['device_ms'] * 1e3:.2f} us of device "
        f"time (torch.addmm {st['stack3']['library_device_ms'] * 1e3:.2f} us), bound "
        f"{st['stack3']['bound_ms'] * 1e3:.2f} us ({st['stack3']['bound_by']}); no P read, "
        f"torch.mm {st['no_p_library_device_ms'] * 1e3:.2f} us")
    log("  H4 probe entry at D 2304, r 288 (device time): " + ", ".join(
        f"tile {k}: {v * 1e3:.2f} us" for k, v in st["device_ms_by_tile"].items())
        + "; no P read: " + ", ".join(
        f"tile {k}: {v * 1e3:.2f} us" for k, v in st["no_p_device_ms_by_tile"].items()))
    stats["rank_update_tile"] = st
    log_times({k: stats[k] for k in PROBE_KERNELS}, " (probe shapes)")
    return stats


def probe_path(device) -> tuple[dict, dict, dict]:
    """Phase 3d, second half: the T9 probes' own path, the port-side
    benches at their defaults (every variant of probe_sweep and
    probe_rankpass, both probe_mosaic probes, and bench_framestep's
    graph-chained modes at FS_STEPS 2400), with the launch counts of that
    run alone: the wrappers' calls (captures, eager loops, warm-ups, gates)
    and, apart, the launches replayed in CUDA graphs (captured x replays).
    Each bench gates its kernels before it times them and holds each
    graph's carry to the eager loop's; a bench that raises fails the
    phase."""
    import traceback

    import torch

    from conan_slam_tpu_torch.benchmarks import (
        bench_framestep,
        probe_mosaic,
        probe_rankpass,
        probe_sweep,
    )
    from conan_slam_tpu_torch.ops import cuda

    runs = (("probe_sweep", probe_sweep, None), ("probe_rankpass", probe_rankpass,
                                                  list(probe_rankpass.ALL)),
            ("probe_mosaic", probe_mosaic, ["all"]),
            ("bench_framestep", bench_framestep, list(PROBE_FS_MODES)))
    torch.cuda.synchronize()
    cuda.reset_launch_counts()
    t0 = time.perf_counter()
    results = {}
    for name, module, argv in runs:
        log(f"probe path: {name} {' '.join(argv or [])}")
        try:
            results[name] = module.main(argv, device=str(device))
        except Exception:          # a failed gate or capture fails the phase, not the run
            log(traceback.format_exc())
            FAILURES.append(f"probe path: {name}")
    torch.cuda.synchronize()
    counts = launches()
    log(f"probe path: {time.perf_counter() - t0:.1f} s, launches {counts}")
    for k in PROBE_PATH_KERNELS:
        require(counts[k] > 0, f"probe path launches {k}", f"{counts[k]} launches")
    replayed: dict[str, int] = {}

    def add(tree):      # every scan_graph result's "launches" in the benches' results
        if isinstance(tree, dict):
            for k, n in tree.get("launches", {}).items():
                replayed[k] = replayed.get(k, 0) + n
            for v in tree.values():
                add(v)
    add(results)
    log(f"probe path: launches replayed in CUDA graphs (captured x replays): {replayed}")
    for k in PROBE_PATH_KERNELS:
        require(replayed.get(k, 0) > 0, f"probe path replays {k}",
                f"{replayed.get(k, 0)} launches replayed")
    return results, counts, replayed


def launches() -> dict:
    from conan_slam_tpu_torch.ops import cuda

    return {k.name: k.launches for k in cuda.KERNELS.values()}


def known_workload(device, n_steps: int):
    """The bench workload: world, initial state, rollout and noise draws
    (the same for every run of it in this call)."""
    import torch

    from conan_slam_tpu_torch.config import SlamConfig
    from conan_slam_tpu_torch.runner.loop import precompute_rollout

    cfg = SlamConfig(max_landmarks=N_LANDMARKS, max_obs=64, enable_augment=False)
    world, state0 = bench_world(device)
    roll = precompute_rollout(world, cfg, n_steps)
    s = cfg.observe_interval
    gen = torch.Generator(device=device).manual_seed(SEED)
    ctrl = torch.randn((n_steps // s, s, 2), generator=gen, device=device)
    obsn = torch.randn((n_steps // s, roll[1][0].shape[1], 2), generator=gen, device=device)
    return cfg, world, state0, roll, ctrl, obsn


@contextlib.contextmanager
def known_schedule(schedule: str):
    """The driver's known frames on ``schedule`` ("auto": H9, "split"):
    frame_step's own test hook, bound where fused_frame_step looks
    frame_step up."""
    from conan_slam_tpu_torch.filters.ekf import update
    from conan_slam_tpu_torch.ops import frame_kernel as fk

    update.frame_step = functools.partial(fk.frame_step, schedule=schedule)
    try:
        yield
    finally:
        update.frame_step = fk.frame_step


def drive_known(workload, steps: int, plain: bool = False, frame_pair: bool = False,
                schedule: str = "auto") -> dict:
    """One timed run of the first ``steps`` steps of the bench workload,
    after a 60-step warm-up (allocator, ctypes bindings, first launches),
    with the launch counts of the timed run alone; ``schedule="split"``
    runs the known frame on the split schedule instead of H9."""
    import torch

    from conan_slam_tpu_torch.ops import cuda
    from conan_slam_tpu_torch.runner.loop import run_ekf_slam_precomputed
    from conan_slam_tpu_torch.runner.metrics import ate_rmse

    cfg, world, state0, roll, ctrl, obsn = workload
    cfg = cfg.replace(frame_pair=frame_pair)
    s = cfg.observe_interval
    f = steps // s
    part = (tuple(a[:steps] for a in roll[0]), tuple(a[:f] for a in roll[1]))
    warm = (tuple(a[:60] for a in roll[0]), tuple(a[:10] for a in roll[1]))
    with known_schedule(schedule):
        run_ekf_slam_precomputed(world, cfg, None, 60, state0, warm, ctrl_noise=ctrl[:10],
                                 obs_noise=obsn[:10], plain=plain)
        torch.cuda.synchronize()
        cuda.reset_launch_counts()
        t0 = time.perf_counter()
        state, outs = run_ekf_slam_precomputed(world, cfg, None, steps, state0, part,
                                               ctrl_noise=ctrl[:f], obs_noise=obsn[:f],
                                               plain=plain)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    res = dict(steps_per_s=steps / secs, seconds=secs, counts=launches(), x_est=outs.x_est,
               ate=float(ate_rmse(outs.x_true, outs.x_est)),
               asym=float((state.p - state.p.T).abs().max()),
               finite=bool(torch.isfinite(state.p).all() and torch.isfinite(outs.x_est).all()))
    label = (("plain" if plain else "kernels") + (", pairs" if frame_pair else "")
             + (", split schedule" if schedule == "split" else ""))
    log(f"  {label}: {steps} steps in {secs:.3f} s = {steps / secs:,.1f} steps/s, "
        f"ATE={res['ate']:.4f} m, asym(P)={res['asym']:.2e}, finite={res['finite']}, "
        f"launches={res['counts']}")
    if not res["finite"]:
        FAILURES.append(f"known path ({label}): non-finite state")
    return res


def main_path(device, n_steps: int) -> tuple[dict, dict, dict]:
    """Phase 4a: the bench workload through the port's driver: H9 in turns
    with the split schedule (H9, split, split, H9), then the plain
    versions.  Returns the results, and the launch counts of an H9 run and
    of a split run."""
    workload = known_workload(device, n_steps)
    s = workload[0].observe_interval
    n_frames = n_steps // s
    plain_steps = min(PLAIN_STEPS, n_steps) // s * s
    log(f"main path (known association): D={workload[2].x.shape[0]}, "
        f"NZ={workload[3][1][0].shape[1]}, {n_steps} steps = {n_frames} frames through H9 in "
        f"turns with the split schedule, {plain_steps} steps with the plain versions")
    order = ("auto", "split", "split", "auto")
    runs = [drive_known(workload, n_steps, schedule=schedule) for schedule in order]
    for schedule, res in zip(order, runs):
        kernels = KNOWN_KERNELS if schedule == "auto" else SPLIT_KERNELS
        want = {**dict.fromkeys(res["counts"], 0), **dict.fromkeys(kernels, n_frames)}
        route = "H9" if schedule == "auto" else "H1-H4"
        require(res["counts"] == want, f"known path launches ({schedule})",
                f"{route} once per frame ({n_frames}), no other kernel")
        require(res["ate"] < 0.05 and res["asym"] < 1e-4, f"accuracy gate ({schedule})",
                f"ATE {res['ate']:.4f} < 0.05 m, asym(P) {res['asym']:.2e} < 1e-4")
    results = {"kernels": runs[0], "split": runs[1],
               "plain": drive_known(workload, plain_steps, plain=True)}
    require(not any(results["plain"]["counts"].values()), "known path plain launches",
            "the plain run launched no kernel")
    k = results["kernels"]
    dev = float((k["x_est"][:plain_steps] - results["plain"]["x_est"]).abs().max())
    dsplit = float((k["x_est"] - runs[1]["x_est"]).abs().max())
    log(f"  kernels vs plain trajectory over {plain_steps} steps: max |dx_est| = {dev:.3e} m; "
        f"H9 vs split over {n_steps} steps: max |dx_est| = {dsplit:.3e} m")
    log("  steps/s in turns: " + ", ".join(
        f"{'H9' if o == 'auto' else 'split'} {r['steps_per_s']:,.1f}" for o, r in zip(order, runs)))
    results.update(turns=[r["steps_per_s"] for r in runs], dx_split=dsplit)
    return results, runs[0]["counts"], runs[1]["counts"]


def pair_path(device) -> tuple[dict, dict]:
    """Phase 4c: the bench workload in frame pairs, in turns with the
    per-frame path (per-frame, pair, pair, per-frame), and 600 steps of
    the plain pair."""
    workload = known_workload(device, BENCH_STEPS)
    n_frames = BENCH_STEPS // workload[0].observe_interval
    log(f"main path (known association, frame pairs): {BENCH_STEPS} steps = {n_frames // 2} "
        f"pairs, in turns with the per-frame path; {PAIR_PLAIN_STEPS} steps of the plain pair")
    runs = [drive_known(workload, BENCH_STEPS, frame_pair=pair)
            for pair in (False, True, True, False)]
    k = runs[1]
    for res in runs[1:3]:
        want = {**dict.fromkeys(res["counts"], 0), **dict.fromkeys(SPLIT_KERNELS, n_frames),
                "rank_update": n_frames // 2}
        require(res["counts"] == want, "pair path launches",
                f"H2, H1, H3 twice per pair ({n_frames}), H4 once ({n_frames // 2}), "
                "no other kernel")
        require(res["ate"] < 0.05 and res["asym"] < 1e-4, "pair path accuracy gate",
                f"ATE {res['ate']:.4f} < 0.05 m, asym(P) {res['asym']:.2e} < 1e-4")
    p = drive_known(workload, PAIR_PLAIN_STEPS, plain=True, frame_pair=True)
    require(not any(p["counts"].values()), "pair path plain launches",
            "the plain run launched no kernel")
    dx_plain = float((k["x_est"][:PAIR_PLAIN_STEPS] - p["x_est"]).abs().max())
    dx_frames = float((k["x_est"] - runs[0]["x_est"]).abs().max())
    log(f"  pair kernels vs plain pair over {PAIR_PLAIN_STEPS} steps: max |dx_est| = "
        f"{dx_plain:.3e} m; pair vs per-frame (kernels, {BENCH_STEPS} steps): max |dx_est| = "
        f"{dx_frames:.3e} m")
    order = ("per-frame", "pair", "pair", "per-frame")
    log("  steps/s in turns: " + ", ".join(f"{o} {r['steps_per_s']:,.1f}"
                                          for o, r in zip(order, runs)))
    return dict(steps_per_s=[r["steps_per_s"] for r in runs], order=order, ate=k["ate"],
                asym=k["asym"], plain_steps_per_s=p["steps_per_s"], dx_plain=dx_plain,
                dx_frames=dx_frames), k["counts"]


class _Killed(Exception):
    """The simulated kill of a chunked run (phase 4d)."""


def chunked_path(device) -> dict:
    """Phase 4d: the chunked driver on the pair path with checkpoints; a
    run killed inside its third chunk and resumed equals an uninterrupted
    run bit for bit."""
    import torch

    from conan_slam_tpu_torch.runner import loop
    from conan_slam_tpu_torch.runner.metrics import ate_rmse
    from conan_slam_tpu_torch.utils import checkpoint

    cfg, world, state0, roll, _, _ = known_workload(device, BENCH_STEPS)
    cfg = cfg.replace(frame_pair=True)
    n_chunks = -(-BENCH_STEPS // CHUNK_STEPS)
    log(f"chunked driver (frame pairs): {BENCH_STEPS} steps in {n_chunks} chunks of "
        f"{CHUNK_STEPS}, checkpointed")
    driver = loop.run_ekf_slam_precomputed
    with tempfile.TemporaryDirectory() as tmp:
        def chunked(name):
            out = loop.run_ekf_slam_precomputed_chunked(world, cfg, SEED, BENCH_STEPS, CHUNK_STEPS,
                                                        state0, roll, os.path.join(tmp, name))
            torch.cuda.synchronize()
            return out

        t0 = time.perf_counter()
        ref = chunked("uninterrupted")
        secs = time.perf_counter() - t0
        runs = []

        def killed_in_chunk_2(*args, **kwargs):
            runs.append(args[3])
            if len(runs) == 3:
                raise _Killed
            return driver(*args, **kwargs)

        def counted(*args, **kwargs):
            runs.append(args[3])
            return driver(*args, **kwargs)

        killed = False
        try:
            loop.run_ekf_slam_precomputed = killed_in_chunk_2
            try:
                chunked("killed")
            except _Killed:
                killed = True
            runs.clear()
            loop.run_ekf_slam_precomputed = counted
            resumed = chunked("killed")
        finally:
            loop.run_ekf_slam_precomputed = driver
        left = sorted(os.listdir(os.path.join(tmp, "uninterrupted")))
        ckpt_bytes = os.path.getsize(os.path.join(tmp, "uninterrupted", "chunk_00000.pt"))
        tree = {"state": ref[0], "outs": loop._outs_like(CHUNK_STEPS, device)}
        path = os.path.join(tmp, "timed.pt")
        t0 = time.perf_counter()
        for _ in range(3):
            checkpoint.save(path, tree)
        save_s = (time.perf_counter() - t0) / 3
        t0 = time.perf_counter()
        for _ in range(3):
            checkpoint.restore(path, tree)
        torch.cuda.synchronize()
        restore_s = (time.perf_counter() - t0) / 3
    rest = [min(CHUNK_STEPS, BENCH_STEPS - s0) for s0 in range(2 * CHUNK_STEPS, BENCH_STEPS,
                                                                CHUNK_STEPS)]
    require(killed and runs == rest, "chunked resume",
            f"the killed run stopped in chunk 2; the rerun resumed after 2 checkpoints and ran "
            f"{len(runs)} of {n_chunks} chunks")
    same = [bool(torch.equal(a, b)) for a, b in zip((*resumed[0], *resumed[1]), (*ref[0], *ref[1]))]
    require(all(same), "chunked kill-and-resume bit-identical",
            f"final state and outputs equal bit for bit ({sum(same)} of {len(same)} tensors)")
    ate = float(ate_rmse(ref[1].x_true, ref[1].x_est))
    asym = float((ref[0].p - ref[0].p.T).abs().max())
    require(ate < 0.05 and asym < 1e-4, "chunked accuracy gate",
            f"ATE {ate:.4f} < 0.05 m, asym(P) {asym:.2e} < 1e-4")
    log(f"  uninterrupted: {BENCH_STEPS} steps in {secs:.3f} s with {n_chunks} checkpoints "
        f"({BENCH_STEPS / secs:,.1f} steps/s); files {left}; one checkpoint {ckpt_bytes:,} bytes, "
        f"save {save_s:.4f} s, restore {restore_s:.4f} s")
    return dict(seconds=secs, steps_per_s=BENCH_STEPS / secs, checkpoint_bytes=ckpt_bytes,
                save_s=save_s, restore_s=restore_s, bit_identical=all(same), ate=ate)


@contextlib.contextmanager
def gated_schedule(schedule: str):
    """The frame loop's gated frames on ``schedule`` ("auto": H10, "split"):
    frame_update_obs's own test hook, bound where fused_frame_update looks
    frame_update_obs up."""
    from conan_slam_tpu_torch.filters.ekf import update
    from conan_slam_tpu_torch.ops import frame_kernel as fk

    update.frame_update_obs = functools.partial(fk.frame_update_obs, schedule=schedule)
    try:
        yield
    finally:
        update.frame_update_obs = fk.frame_update_obs


def gated_path(device) -> tuple[dict, dict, dict]:
    """Phase 4b: BASELINE config 2 through the port's frame loop: H10 in turns
    with the split schedule (H10, split, split, H10), then the plain
    versions; and the 10k-landmark shape on both routes.  Returns the
    results and the launch counts of an H10 run and of a split run."""
    import torch

    from conan_slam_tpu_torch.ops import cuda
    from conan_slam_tpu_torch.runner.loop import precompute_rollout, run_ekf_slam_precomputed
    from conan_slam_tpu_torch.runner.metrics import ate_rmse
    from conan_slam_tpu_torch.sim.world import config2_world

    world, cfg = config2_world(device), gated_cfg(500)
    s = cfg.observe_interval
    roll = precompute_rollout(world, cfg, GATED_STEPS)
    n_steps = roll[0][0].shape[0]
    n_frames = n_steps // s
    nz = roll[1][0].shape[1]
    gen = torch.Generator(device=device).manual_seed(0)
    ctrl = torch.randn((n_frames, s, 2), generator=gen, device=device)
    obsn = torch.randn((n_frames, nz, 2), generator=gen, device=device)
    log(f"main path (gated, BASELINE config 2): 500 landmarks, empty map, K=500 in D=1024, "
        f"NZ={nz}, {n_steps} steps = {n_frames} frames through H10 in turns with the split "
        f"schedule, {GATED_PLAIN_STEPS} steps with the plain versions")

    def drive(plain: bool, steps: int, schedule: str = "auto"):
        f = steps // s
        part = (tuple(a[:steps] for a in roll[0]), tuple(a[:f] for a in roll[1]))
        warm = (tuple(a[:60] for a in roll[0]), tuple(a[:10] for a in roll[1]))
        with gated_schedule(schedule):
            run_ekf_slam_precomputed(world, cfg, None, 60, None, warm,
                                     ctrl_noise=ctrl[:10], obs_noise=obsn[:10], plain=plain)
            torch.cuda.synchronize()
            cuda.reset_launch_counts()
            t0 = time.perf_counter()
            state, outs = run_ekf_slam_precomputed(world, cfg, None, steps, None, part,
                                                   ctrl_noise=ctrl[:f], obs_noise=obsn[:f],
                                                   plain=plain)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        counts = launches()
        res = dict(steps_per_s=steps / secs, seconds=secs, counts=counts, outs=outs,
                   ate=float(ate_rmse(outs.x_true, outs.x_est, ~outs.done)),
                   mapped=int(state.n_active),
                   finite=bool(torch.isfinite(state.p).all() and torch.isfinite(state.x).all()
                               and torch.isfinite(outs.x_est).all()))
        label = "plain" if plain else "H10" if schedule == "auto" else "split schedule"
        log(f"  {label}: {steps} steps in {secs:.3f} s = "
            f"{steps / secs:,.1f} steps/s, ATE={res['ate']:.4f} m, mapped={res['mapped']}, "
            f"finite={res['finite']}, launches={counts}")
        return res

    order = ("auto", "split", "split", "auto")
    runs = [drive(False, n_steps, schedule) for schedule in order]
    for schedule, res in zip(order, runs):
        kernels = GATED_KERNELS if schedule == "auto" else GATED_SPLIT_KERNELS
        want = {**dict.fromkeys(res["counts"], 0), **dict.fromkeys(kernels, n_frames)}
        require(res["counts"] == want, f"gated path launches ({schedule})",
                ("H5, H6, H10" if schedule == "auto" else "H5, H6, H7, H8, H1, H4")
                + f" once per frame ({n_frames}), no other kernel")
        require(res["finite"] and res["ate"] < 0.5 and 270 <= res["mapped"] <= 340,
                f"gated_full gate ({schedule})",
                f"finite, ATE {res['ate']:.4f} < 0.5 m, 270 <= mapped {res['mapped']} <= 340")
    k, sp = runs[0], runs[1]
    dx_split = float((k["outs"].x_est - sp["outs"].x_est).abs().max())
    dmap_split = (k["outs"].n_active - sp["outs"].n_active).abs()
    log(f"  H10 vs split over {n_steps} steps: max |dx_est| = {dx_split:.3e} m, mapped "
        f"{k['mapped']} vs {sp['mapped']}, steps with a different map size: "
        f"{int((dmap_split > 0).sum())} (max |d mapped| {int(dmap_split.max())})")
    log("  steps/s in turns: " + ", ".join(
        f"{'H10' if o == 'auto' else 'split'} {r['steps_per_s']:,.1f}" for o, r in zip(order, runs)))
    p = drive(True, GATED_PLAIN_STEPS)
    require(not any(p["counts"].values()), "gated path plain launches",
            "the plain run launched no kernel")
    require(p["finite"] and p["mapped"] > 0 and p["ate"] < 1.0, "gated gate (plain)",
            f"finite, mapped {p['mapped']} > 0, ATE {p['ate']:.4f} < 1 m")
    ko, po = k["outs"], p["outs"]
    dx = float((ko.x_est[:GATED_PLAIN_STEPS] - po.x_est).abs().max())
    dmap = (ko.n_active[:GATED_PLAIN_STEPS] - po.n_active).abs()
    log(f"  kernels vs plain over {GATED_PLAIN_STEPS} steps: max |dx_est| = {dx:.3e} m, "
        f"mapped {int(ko.n_active[GATED_PLAIN_STEPS - 1])} vs {int(po.n_active[-1])}, "
        f"max |d mapped| over the steps = {int(dmap.max())}, "
        f"steps with a different map size: {int((dmap > 0).sum())}")

    # The 10k-landmark shape, kernels only, on both routes: no gate is
    # stored for it.  A few untimed frames first, so the timed run starts
    # warm.
    big, bcfg = big_world(device), gated_cfg(BIG_LANDMARKS)
    big_runs = {}
    for schedule in ("auto", "split"):
        with gated_schedule(schedule):
            run_ekf_slam_precomputed(big, bcfg, torch.Generator(device=device).manual_seed(1),
                                     BIG_WARM_STEPS)
            torch.cuda.synchronize()
            cuda.reset_launch_counts()
            t0 = time.perf_counter()
            state, outs = run_ekf_slam_precomputed(big, bcfg, torch.Generator(device=device)
                                                   .manual_seed(0), BIG_STEPS)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        bf = outs.x_est.shape[0] // s
        counts = launches()
        finite = bool(torch.isfinite(state.p).all() and torch.isfinite(outs.x_est).all())
        label = "H10" if schedule == "auto" else "split schedule"
        log(f"  10k landmarks ({label}): D={state.x.shape[0]}, K={state.capacity}, {bf * s} "
            f"steps in {secs:.3f} s = {bf * s / secs:,.1f} steps/s (after {BIG_WARM_STEPS} "
            f"untimed steps), mapped={int(state.n_active)}, finite={finite}, launches={counts}")
        kernels = GATED_KERNELS if schedule == "auto" else GATED_SPLIT_KERNELS
        want = {**dict.fromkeys(counts, 0), **dict.fromkeys(kernels, bf)}
        require(finite and int(state.n_active) > 0 and counts == want,
                f"10k-landmark run ({schedule})", "finite, mapped > 0, the route's kernels once "
                "per frame")
        big_runs[schedule] = bf * s / secs
    return (dict(steps_per_s=k["steps_per_s"], ate=k["ate"], mapped=k["mapped"],
                 turns=[r["steps_per_s"] for r in runs], split_ate=sp["ate"],
                 split_mapped=sp["mapped"], dx_split=dx_split,
                 map_steps_differ=int((dmap_split > 0).sum()),
                 plain_steps_per_s=p["steps_per_s"], big_steps_per_s=big_runs["auto"],
                 big_split_steps_per_s=big_runs["split"]),
            k["counts"], sp["counts"])


def profile_frames(device, n_frames: int, label: str, world, cfg, state0,
                   schedule: str = "auto") -> None:
    """A torch.profiler trace of ``n_frames`` frames of a main path: device
    time per kernel per frame, the PyTorch ops dispatched per frame and the
    device's busy share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from conan_slam_tpu_torch.runner.loop import precompute_rollout, run_ekf_slam_precomputed

    n_steps = n_frames * cfg.observe_interval
    roll = precompute_rollout(world, cfg, n_steps)
    gen = torch.Generator(device=device).manual_seed(SEED)
    with known_schedule(schedule), gated_schedule(schedule):
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
    # Host work: the PyTorch ops the frame loop dispatches (outermost only).
    ops: dict[str, int] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.cpu_parent is None and e.name.startswith("aten::"):
            ops[e.name] = ops.get(e.name, 0) + 1
    log(f"profile, {label}, {n_frames} frames: wall {wall_us / n_frames:.1f} us/frame under the "
        f"profiler, device busy {busy / n_frames:.1f} us/frame "
        f"({100.0 * busy / wall_us:.1f}% of wall); {sum(ops.values()) / n_frames:.1f} PyTorch "
        "ops dispatched per frame, most frequent: " + ", ".join(
            f"{k} {v / n_frames:.1f}" for k, v in sorted(ops.items(), key=lambda kv: -kv[1])[:8]))
    rows.sort(reverse=True)
    ours = tuple(f"{name}_kernel" for name in ORDER)
    for us, count, key in rows[:15] + [r for r in rows[15:] if r[2].startswith(ours)]:
        log(f"  {us / n_frames:9.2f} us/frame  {count / n_frames:5.2f} launches/frame  {key[:90]}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=BENCH_STEPS,
                        help="control steps of the known path's run with the kernels "
                             "(default: the bench's 19,200)")
    opts = parser.parse_args()
    t_start = time.perf_counter()

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

    from conan_slam_tpu_torch.filters.ekf import init_state
    from conan_slam_tpu_torch.ops import cuda
    from conan_slam_tpu_torch.sim.world import config2_world

    log(f"nvcc: {run([cuda._nvcc(), '--version']).splitlines()[-1]}")
    device = torch.device("cuda", 0)
    # The precision contract: fp32 products, TF32 off (also for the
    # library calls timed beside the kernels).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # --- phase 2: build ---
    path, secs, out = cuda.build(("-Xptxas", "-v"))
    log(f"build: {path.name} in {secs:.1f} s")
    ptxas = ptxas_record(out)
    for name, rec in ptxas.items():
        log(f"  ptxas {name}: {rec}")
    cuda.library()

    # --- phase 3: every kernel against its plain version ---
    t0 = time.perf_counter()
    stats = kernel_checks(device)
    gstats = gated_kernel_checks(device)
    pstats = pair_checks(device)
    log(f"kernel checks: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    prstats = probe_checks(device)
    probes, pbcounts, pbreplayed = probe_path(device)
    log(f"T9 probes (phase 3d): {time.perf_counter() - t0:.1f} s")

    # --- phase 4: the main paths ---
    t0 = time.perf_counter()
    results, counts, scounts = main_path(device, opts.steps)
    gated, gcounts, gscounts = gated_path(device)
    paired, pcounts = pair_path(device)
    chunked = chunked_path(device)
    log(f"main paths: {time.perf_counter() - t0:.1f} s")

    from conan_slam_tpu_torch.config import SlamConfig

    world, state0 = bench_world(device)
    known_cfg = SlamConfig(max_landmarks=N_LANDMARKS, max_obs=64, enable_augment=False)
    profile_frames(device, PROFILE_FRAMES, "known association (H9)", world, known_cfg, state0)
    profile_frames(device, PROFILE_FRAMES, "known association, split schedule", world, known_cfg,
                   state0, schedule="split")
    for schedule, label in (("auto", "H10"), ("split", "split schedule")):
        profile_frames(device, PROFILE_FRAMES, f"gated, config 2 ({label})", config2_world(device),
                       gated_cfg(500), init_state(500, 500, device=device), schedule=schedule)
    profile_frames(device, 2 * PROFILE_FRAMES, "known association, frame pairs", world,
                   known_cfg.replace(frame_pair=True), state0)
    for schedule, label in (("auto", "H10"), ("split", "split schedule")):
        profile_frames(device, BIG_PROFILE_FRAMES, f"gated, 10k landmarks ({label})",
                       big_world(device), gated_cfg(BIG_LANDMARKS), None, schedule=schedule)

    # --- phase 5: report ---
    allstats = {**stats, **gstats, **prstats}
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    extras = ("device_ms", "fixed_ms", "library_device_ms", "wrapper_ms", "bound_square_ms", "tile",
              "grid", "plan", "device_ms_by_s", "device_ms_by_mp", "phases_us", "device_ms_coop",
              "device_ms_by_nbp", "device_ms_turns", "split_ms", "device_ms_10k",
              "device_ms_turns_10k", "bound_ms_10k", "bound_by_10k", "tile_10k", "phases_us_10k",
              "variants_device_ms", "variants_fixed_ms", "tb_per_s", "library_device_ms",
              "library_tb_per_s", "tb_per_s_past_l2", "library_tb_per_s_past_l2",
              "known_device_ms", "device_ms_by_tile", "no_p_device_ms_by_tile", "no_p_plain_ms",
              "no_p_library_ms", "no_p_library_device_ms", "stack3")
    table = {"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
         "launches": (counts[k.name] + scounts[k.name] + gcounts[k.name] + gscounts[k.name]
                      + pcounts[k.name] + pbcounts[k.name]),
         "launches_by_path": {"known": counts[k.name], "known_split": scounts[k.name],
                              "gated": gcounts[k.name], "gated_split": gscounts[k.name],
                              "pair": pcounts[k.name], "probes": pbcounts[k.name],
                              "probes_replayed": pbreplayed.get(k.name, 0)},
         **{key: allstats[k.name][key] for key in keys},
         **{key: allstats[k.name][key] for key in extras if key in allstats[k.name]},
         "ptxas": {n: r for n, r in ptxas.items() if n.startswith(f"{k.name}_kernel")}}
        for k in sorted(cuda.KERNELS.values(), key=lambda k: ORDER.index(k.name))
    ]}
    summary = {
        "steps_per_s": results["kernels"]["steps_per_s"],
        "plain_steps_per_s": results["plain"]["steps_per_s"],
        "ate_m": results["kernels"]["ate"], "asym_p": results["kernels"]["asym"],
        "frame_ms": stats["frame_step"]["ms"], "frame_plain_ms": stats["frame_step"]["plain_ms"],
        "split_frame_ms": stats["split frame"]["ms"],
        "split_frame_plain_ms": stats["split frame"]["plain_ms"],
        "known_turns_steps_per_s": dict(zip(("h9_1", "split_1", "split_2", "h9_2"),
                                            results["turns"])),
        "h9_vs_split_dx_est_m": results["dx_split"],
        "gated_steps_per_s": gated["steps_per_s"],
        "gated_plain_steps_per_s": gated["plain_steps_per_s"],
        "gated_ate_m": gated["ate"], "gated_mapped": gated["mapped"],
        "gated_turns_steps_per_s": dict(zip(("h10_1", "split_1", "split_2", "h10_2"),
                                            gated["turns"])),
        "gated_split_ate_m": gated["split_ate"], "gated_split_mapped": gated["split_mapped"],
        "h10_vs_split_dx_est_m": gated["dx_split"],
        "h10_vs_split_map_steps_differ": gated["map_steps_differ"],
        "gated_frame_ms": gstats["obs_step"]["ms"],
        "gated_frame_plain_ms": gstats["obs_step"]["plain_ms"],
        "gated_split_frame_ms": gstats["frame_update_obs"]["ms"],
        "gated_split_frame_plain_ms": gstats["frame_update_obs"]["plain_ms"],
        "big_steps_per_s": gated["big_steps_per_s"],
        "big_split_steps_per_s": gated["big_split_steps_per_s"],
        "pair_vs_frame_steps_per_s": dict(zip(("frame_1", "pair_1", "pair_2", "frame_2"),
                                              paired["steps_per_s"])),
        "pair_ate_m": paired["ate"], "pair_asym_p": paired["asym"],
        "pair_plain_steps_per_s": paired["plain_steps_per_s"],
        "pair_ms": pstats["frame_step_pair"]["ms"],
        "pair_plain_ms": pstats["frame_step_pair"]["plain_ms"],
        "two_frames_ms": pstats["frame_step_pair"]["two_frames_ms"],
        "chunked_steps_per_s": chunked["steps_per_s"], "chunked_ate_m": chunked["ate"],
        "checkpoint_bytes": chunked["checkpoint_bytes"], "checkpoint_save_s": chunked["save_s"],
        "checkpoint_restore_s": chunked["restore_s"],
        "probes_us": {
            "sweep": {k: {"graph": v["us"], "eager": v["eager_us"]}
                      for k, v in probes.get("probe_sweep", {}).get("variants", {}).items()},
            "rankpass": {k: {"graph": v["us"], "eager": v["eager_us"], "library": v["library_us"]}
                         for k, v in probes.get("probe_rankpass", {}).get("variants", {}).items()},
            "copy_tb_per_s": probes.get("probe_rankpass", {}).get("variants", {}).get(
                "copy", {}).get("tb_per_s"),
            "framestep_us_per_frame": {
                k: {"graph": v["us"], "eager": v["eager_us"]}
                for k, v in probes.get("bench_framestep", {}).get("modes", {}).items()},
        },
    }
    log(json.dumps(summary))
    log(f"smoke: {time.perf_counter() - t_start:.1f} s")
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
