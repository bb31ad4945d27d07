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
          NZ = 64) and at a ragged D: H9 (the default route: a cooperative
          frame kernel, then the P pass launched behind it) and the split
          schedule's H1-H4, each against its plain version; H9 over MP
          32/128/224, S 1/6/16, heading on and off and D 2304/2051/13
          against the split kernels (within the fp32 rounding of the sums
          they order differently) and its plain version (two calls
          bit-equal, asym(P) exactly 0), its device time against MP and S,
          its phases (%globaltimer) beside H2, H1, H3 and H4 run alone on
          the same frame, each variant's registers and local-memory bytes
          beside H1's and H4's, its plan and bound;
          and the routes past H1's registers: the frame and the pair at
          MP 240 on the split schedule with H1's cooperative sweep (H1 also
          at MP 480), the gated frame at MP 160-224 (H10) and 240/480 (the
          split with H7 in bands), the known frame at S = 17/33/64 (H9 and
          the split), the plain route with no launch where neither package
          has a kernel, and a raise with no launch where only the
          reference has one;
       b. the gated frame (H5-H8, H15, H1, H4, H10 and the whole
          frame_update_obs on both routes) at BASELINE config 2's shape
          (D = 1024, NZ = 64, K = 510) on a mid-run frame, at a ragged D
          (1003) and at the 10k-landmark shape (D = 20,224), with a
          cross-check against the known-association frame on the same rows
          and the frame's mean against a float64 witness.  H15 (the factors
          and the association in one launch) against its plain version (H5's,
          the host fold, H6's and the mask rule): its factors bit for bit
          H5's entry, its scores within the NIS tolerance, found, new and the
          best slot equal except near a gate or a tie, two launches in a row
          bit-equal; its device time, phases (%globaltimer) beside H5's
          entry's, registers beside H5's and H6's entries', and the parent's
          two-launch route (H5, the fold, H6, the mask rule) in turns, at
          config 2 and at the 10k shape.  H10 (the default
          route: a cooperative frame kernel, then the P pass launched
          behind it) against its plain version and against the split
          kernels (within the fp32 rounding of the sums they order
          differently), two calls bit-equal, asym(P) exactly 0; its device
          time (the span of its two kernels) against the split's in turns
          (H10, split, split, H10) at config 2 and at the 10k shape, against
          MP and NBP, its phases (%globaltimer) beside H1 and H4 run alone
          on the same frame, its sweep beside H1 back to back and right
          after H4's pass over the 10k P, each variant's registers and
          local-memory bytes, its plan and bound;
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
          the plain versions.  Asserts H9's two kernels launched once per
          frame each and H1-H4 never on the H9 runs (H1-H4 once per frame
          on the split runs), and the reference's accuracy gate on each:
          ATE < 0.05 m, asym(P) < 1e-4.
       b. BASELINE config 2 (500 landmarks of random_world(PRNGKey(7), 500)
          on the default tour, empty map, gated association and
          augmentation; 25,002 steps = 4,167 frames) through H10 in turns
          with the split schedule (H10, split, split, H10): asserts the
          reference's gated_full gate (ATE < 0.5 m, 270 <= mapped <= 340)
          on each run, and that H15 launched once per frame, H10's two
          kernels once each, and no other kernel (H15, H7, H8, H1 and H4 on
          the split runs; H5's and H6's own entries never);
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
       e. the on-device simulation loop, runner.loop.run_ekf_slam (steering,
          truth, the sensor and its compaction on the card beside the
          filter): (a) the valet course (30 landmarks, K 32: D 67, NZ 30;
          known association with augmentation; 25,002 steps) on the JAX
          run's own seed-42 draws (conan_slam_tpu_torch/sim/data/
          valet_seed42.npz), held to its end at step 19,555, 25 mapped and
          an ATE within 5e-3 m of its 0.38967 m, with the largest
          |x_est - reference| and the first step where x_true drifts past
          1e-3 m; (b) the same gated; H9, H15 and H10 at frame 200 of that
          course (D 67, NZ 30) against their plain versions and float64
          witnesses; (c) BASELINE config 2 through run_ekf_slam in turns
          with run_ekf_slam_precomputed (precomputed, sim, sim,
          precomputed): the first sim run on the JAX run's own PRNGKey(0)
          draws (config2_key0.npz) and the precomputed runs held to
          gated_full, the second sim run on a torch.Generator's draws
          (seed 0) reported; (d) every route (fused; fast_frame=False;
          fused_obs=False; and with switch_batch_update=False), known and
          gated, 1,200 steps each with the filter at the true noise,
          against their plain versions on the card and the NIS band
          1.2 < mean < 3.0; frames of (a) and (c)
          under torch.cuda.set_sync_debug_mode("error"). Asserts H9 (known),
          H15 and H10 (gated) once per frame on the fused runs and H6's
          entry once per frame on the gated non-fused routes.
       f. FastSLAM 2.0, runner.loop.run_pf_slam (plain PyTorch: the JAX PF
          has no Pallas kernel): (a) the JAX runs' own draws at N = 16 and
          100 (conan_slam_tpu_torch/sim/data/pf_key1.npz, 1,200 steps),
          held to their truth within 1e-3 m and their map size at every
          step, the largest |x_est - reference| and the first step past
          1e-3 m reported; the first 100 frames of each against the plain
          version on the CPU from the card's own carry (x_est 2e-3 m, Neff
          rtol 5e-2, a resampling flip explained by the two weights'
          difference and the frame held on the card's ancestors; past a
          bound, a float64 witness decides: the card no further from it
          than twice the plain version, and never past twice the bound);
          (b) tests/test_pf.py's noise-free
          gate (N = 20, 2,000 steps: ATE < 1 m, mapped > 0) and the whole
          valet course at N = 100 on a torch.Generator's draws, held to its
          end at step 19,555 with 25 mapped, finite, Neff in (0, N]; (c)
          bench_pf.py's sizes, N = 100 to 100,000 (the smallest and the
          largest twice, in turns): steps/s, particle-steps/s, ATE, peak
          allocated bytes, and a
          torch.profiler trace at N = 10,000 split by the filter's steps;
          (d) frames under the sync debug mode; (e) no hand-written kernel
          launched (launches_by_path["pf"]).
     Then a torch.profiler trace of 100 frames of each path (the known
     path and the gated path each through its one-launch frame (H9,
     H10) and through the split schedule, 100 pairs of the pair path, 20 frames of
     the 10k-landmark shape on both routes, and 100 frames of
     run_ekf_slam on the valet course and on config 2) gives each kernel's
     device time per frame, the PyTorch ops dispatched per frame and the device's
     busy share; the gated traces also split the ops and the PyTorch
     kernels' device time by the frame loop's steps (its pre-update, the
     update, augmentation).
  5. The kernel table and the card as JSON lines, then the last line
     {"ok": true, "device": {...}}.

Any failed check exits non-zero before the last line is printed.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import importlib
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
# The device kernels of each wrapper that launches more than one: H9's and
# H10's frame kernel and their P pass.  A wrapper's ptxas records and device
# time sum over its kernels.
DEVICE_KERNELS = {"frame_step": ("frame_step_kernel", "frame_pass_kernel"),
                  "obs_step": ("obs_step_kernel", "obs_pass_kernel")}
H9_KERNELS = "|".join(DEVICE_KERNELS["frame_step"])
H10_KERNELS = "|".join(DEVICE_KERNELS["obs_step"])
SPLIT_KERNELS = ("sweep_inverse", "frame_chain", "frame_panels", "rank_update")
# The gated frame: H15 (the factors and the association in one launch), then
# H10 by default or the split schedule.
GATED_KERNELS = ("factor_gate", "obs_step")
GATED_SPLIT_KERNELS = ("factor_gate", "obs_chain", "sweep_inverse", "obs_panels", "rank_update")
ORDER = ("sweep_inverse", "frame_chain", "frame_panels", "rank_update", "factor_strip",
         "gating_scores", "factor_gate", "obs_chain", "obs_panels", "frame_step", "obs_step",
         "sweep_probe", "stream_copy", "probe_dots", "probe_observe", "rank_update_tile")
# The kernels of the T9 probes (phase 3d): H11-H14 and H4's probe entry.
PROBE_KERNELS = ("sweep_probe", "stream_copy", "probe_dots", "probe_observe", "rank_update_tile")
# The kernels the probe path drives besides them (bench_framestep's modes).
PROBE_PATH_KERNELS = PROBE_KERNELS + ("sweep_inverse", "rank_update", "frame_step", "obs_step",
                                      "factor_strip", "frame_chain", "frame_panels")
PROBE_FS_MODES = ("sweeponly", "sweep", "chol", "noop", "ppass", "stepkernel", "stepkernel_big",
                  "fullkernel", "factkernel")
CHUNK_STEPS = 4800      # the chunked driver's chunk: 800 frames = 400 pairs
# Phase 4e, the on-device simulation loop (runner.loop.run_ekf_slam).
SIM_STEPS = 25_000      # the valet course and config 2: 4,167 frames = 25,002 steps
SIM_ROUTE_STEPS = 1200  # each non-fused route, kernels and plain versions
SIM_SYNC_STEPS = 60     # frames of (a) and (c) run under the sync debug mode
VALET_FRAME = 200       # the valet frame the kernels are held at on their own (phase 4e)
# The JAX package's run_ekf_slam(default_world(), SlamConfig(), PRNGKey(42),
# 25_000): its draws and trajectories (tests/valet_reference.py).
VALET_DATA = os.path.join("conan_slam_tpu_torch", "sim", "data", "valet_seed42.npz")
VALET_DONE_AT, VALET_MAPPED = 19_555, 25
# BASELINE config 2's gated run of the JAX run_ekf_slam from PRNGKey(0): its
# control draws and each frame's draws of the returns near the field of
# view (tests/valet_reference.py).  Phase 4e's gated_full run takes these:
# gated_full is a gate on one realization (of the JAX run_ekf_slam's own
# PRNGKey(0) to (11), 3 ends at ATE 1.057 m and 9 at 1.452 m:
# tests/config2_seeds.py), and on these draws the reference passes it
# (ATE 0.185 m, 304 mapped).
CONFIG2_DATA = os.path.join("conan_slam_tpu_torch", "sim", "data", "config2_key0.npz")
# |ATE - the reference's| on the valet run: the port's plain version on the
# CPU against the same draws lands 4.4e-4 m (known) and 1.8e-4 m (gated)
# from it (tests run on an x86 CPU); the bound is ~10x that, half the
# 0.01 m the acceptance allows.
VALET_ATE_BOUND = 5e-3
ROUTE_DX_BOUND = 2e-3   # every route, kernels vs plain: the slice's pose bound
SIM_ROUTES = (("fused", {}), ("fast_frame=False", dict(fast_frame=False)),
              ("fused_obs=False", dict(fused_obs=False)),
              ("fused_obs=False, switch_batch_update=False",
               dict(fused_obs=False, switch_batch_update=False)))
# Phase 4f, FastSLAM 2.0 (runner.loop.run_pf_slam).  The JAX package's
# run_pf_slam(default_world(), SlamConfig(num_particles=N), PRNGKey(1), 1_200)
# at N = 16 and 100: its draws and outputs (tests/pf_reference.py).
PF_DATA = os.path.join("conan_slam_tpu_torch", "sim", "data", "pf_key1.npz")
PF_PARITY_N = (16, 100)
PF_STEPS = 1200         # bench_pf.py's run, and the parity runs
PF_SIZES = (100, 1_000, 10_000, 100_000)   # bench_pf.py's sweep (bench.py's N = 10,000 in it)
PF_COURSE_N = 100       # the whole course at the reference config (smoke_compile.py stage_pf)
PF_GATE_N, PF_GATE_STEPS = 20, 2000        # tests/test_pf.py's noise-free gate
PF_PROFILE_N, PF_PROFILE_FRAMES = 10_000, 50
PF_SYNC_FRAMES = 10
PF_CHECK_FRAMES = 100   # frames of each parity run held against the plain version (600 steps)
# tests/test_torch_run_pf.py's bounds, each frame from the same carry.  A
# frame past the x_est or Neff bound is decided by a float64 witness (the H10
# checks' rule: the card no further from it than twice the plain version), and
# never passes beyond PF_WITNESS_CEILING times the bound.
PF_X_TRUE_ATOL, PF_X_EST_ATOL, PF_NEFF_RTOL = 1e-4, 2e-3, 5e-2
PF_WITNESS_CEILING = 2.0
# The truth chain over a whole run: the PF's is the EKF's (_advance_truth),
# whose CUDA sinf/cosf round apart from XLA's and compound along the course;
# phase 4e's valet run drifts 2.44e-4 m from the reference over its 25,002
# steps on an H100 and draws its line at 1e-3 m, ~4x that.  The PF's runs
# are held at the same line.
PF_RUN_X_TRUE_ATOL = 1e-3
# The reference's ATE over 36 seeds of the whole course at N = 100 (PARITY.md,
# "PF robustness study"): median 3.37 m, p90 5.76 m.
PF_REFERENCE_ATE = (3.37, 5.76)
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


def device_ms(fn, iters: int = 20, traces: int = 3, kernel: str | None = None,
              per_call: int = 1) -> float:
    """Mean device milliseconds per call, without the host's work, from
    torch.profiler traces of ``iters`` calls (after two untraced ones):
    the sum, over the kernels and copies a call launches (each once), of
    their median durations, or only the kernel named ``kernel``; with
    ``per_call`` > 1 (the kernels ``kernel`` names, that a call launches
    in turn and that may overlap: H9's P pass is resident before its frame
    kernel ends), the median span of a call's kernels, from the first's
    start to the last's end.  A name seen fewer than iters / 2 times in a
    trace is a stray of another trace;
    ``kernel`` (a regular expression; alternatives with ``|``) matches a
    whole word of the demangled name (which may carry ``void``, a namespace
    and template arguments).
    The profiler can drop a trace's device events, which lowers its
    reading or leaves it empty, and one trace can read high (a clock dip),
    so up to 10 ``traces`` traces are taken until ``traces`` of them hold
    events (on the card up to half the traces of a call come back empty),
    and the median of those is kept; the empty ones are logged.  No
    reading at all fails the run."""
    import statistics

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    readings = []
    empty = 0
    for _ in range(10 * traces):
        if len(readings) == traces:
            break
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        durations: dict[str, list[float]] = {}
        spans = []
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                durations.setdefault(e.name, []).append(e.time_range.elapsed_us())
                if kernel is not None and re.search(rf"\b(?:{kernel})\b", e.name):
                    spans.append((e.time_range.start, e.time_range.end))
        if per_call > 1:
            spans.sort()
            calls = [spans[i:i + per_call] for i in range(0, len(spans) - per_call + 1, per_call)]
            reading = statistics.median(max(e for _, e in c) - c[0][0] for c in calls) if calls else 0.0
        else:
            reading = sum(statistics.median(d) for name, d in durations.items()
                          if len(d) >= iters / 2
                          and (kernel is None or re.search(rf"\b(?:{kernel})\b", name)))
        if reading > 0.0:
            readings.append(reading)
        else:
            empty += 1
    if empty:
        log(f"  device time: {empty} of {empty + len(readings)} profiler traces of {iters} calls "
            f"held no reading" + (f" of {kernel}" if kernel else ""))
    if not readings:
        require(False, "device time", f"no profiler trace of {iters} calls held device events"
                + (f" of {kernel}" if kernel else ""))
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


def per_frame(kernels, n_frames: int) -> dict:
    """The launch counts of ``n_frames`` frames that call each wrapper in
    ``kernels`` once: its kernels a call (H9: two) x the frames."""
    from conan_slam_tpu_torch.ops import cuda

    return {k: n_frames * cuda.KERNELS[k].launches_per_call for k in kernels}


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
    192 and 224 (D = 1024): H10's two kernels; at MP 240 and 480: the split
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
        want = per_frame(("obs_step",), 1) if mp <= 224 else obs_split
        log(f"gated MP {mp} (NZ {nz}, D 1024): obs_route {route!r}, launches {launched}")
        require(route == ("resident" if mp <= 224 else "split") and launched == want,
                f"gated MP {mp} route", "H10 (its two kernels) to MP 224, then H7 (bands), H1 "
                "(cooperative), H8, H4 once each")
        ref = fk.frame_update_obs(*uargs, plain=True)
        check(f"gated MP {mp} vs plain: x", got.x, ref.x, 1e-4, 1e-4,
              "the reference's megakernel-test tolerance")
        check(f"gated MP {mp} vs plain: P", got.p, ref.p, 1e-3, 1e-4,
              "the reference's megakernel-test tolerance")
        check(f"gated MP {mp} vs plain: nis", got.nis, ref.nis, 1e-3, 1e-5,
              "the reference's megakernel-test tolerance")
        kernel, calls = (H10_KERNELS, fk.OS_LAUNCHES) if mp <= 224 else ("obs_chain_kernel", 1)
        gated_us[mp] = (kernel, 1e3 * device_ms(lambda: fk.frame_update_obs(*uargs), kernel=kernel,
                                                per_call=calls))
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
        require(route == "resident"
                and launched == {"frame_step": fk.FS_LAUNCHES, **split, "rank_update": 1},
                f"S {s_steps} kernels",
                "H9's two kernels once each, and H2, H1, H3, H4 once on the split schedule")
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
        steps_us[s_steps] = tuple(1e3 * device_ms(fn, kernel=kernel, per_call=n) for fn, kernel, n in (
            (lambda: fk.frame_step(*fargs), H9_KERNELS, 2),
            (lambda: fk.frame_step(*fargs, schedule="split"), "frame_chain_kernel", 1),
            (lambda: frame_factors_fused(st, *fargs[4:9], *fargs[13:]), "factor_strip_kernel", 1)))
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


def h9_measure(device, args, tail, err: float, nblk: int, alone: dict, calls: dict) -> dict:
    """H9 at the known check frame: CUDA-event time of the wrapper, device
    time (profiler), the plain version's time, its plan and bound; its
    device time against MP (32, 128, 224 at S = 6) and S (1, 6, 16 at MP
    128) on synthetic frames at D = 2304; its phases beside the split's
    kernels run alone on the same frame (``alone``: H2, H1, H3 and H4's
    device ms, this call), and beside H1 and H4 (``calls``: a call of
    each on this frame's S, and G and M) each run after a 128 MB read or
    write has flushed the 50 MB L2, as a frame finds it after the last
    frame's P pass; and each H9 variant's registers and local-memory bytes
    a thread beside H1's and H4's."""
    import torch

    from conan_slam_tpu_torch.ops import frame_kernel as fk
    from conan_slam_tpu_torch.ops.rank_update import rank_update_attributes
    from conan_slam_tpu_torch.ops.spd_inverse import sweep_inverse_attributes

    fargs = (*args, *tail)
    d, nz = args[0].shape[0], args[9].shape[0]
    mp, rp = fk.frame_shapes(nz)
    plan = fk.frame_step_plan(d, mp, device, args[4].shape[0])
    out = fk.frame_step(*fargs)
    ins = [a for a in fargs if torch.is_tensor(a)]
    st = dict(max_abs_err=err, library_ms=None,
              ms=time_ms(lambda: fk.frame_step(*fargs), 50),
              device_ms=device_ms(lambda: fk.frame_step(*fargs), kernel=H9_KERNELS,
                                  per_call=fk.FS_LAUNCHES),
              plain_ms=time_ms(lambda: fk.frame_step(*fargs, plain=True), 10),
              plan=f"frame kernel: grid {plan.grid} x {plan.block} threads, {plan.smem:,} B "
                   f"shared, {plan.regs} registers; {plan.bands} chain bands, {plan.panels} "
                   f"panels, {plan.units} units of {plan.unit} columns; P pass: grid "
                   f"{plan.pass_grid} x {plan.pass_block} threads ({plan.pass_occ} an SM), "
                   f"{plan.pass_smem:,} B shared, {plan.pass_regs} registers, {plan.tiles} tiles "
                   f"of {fk.FS_TILE}",
              **bound(nbytes(*ins, *out), h9_work(d, mp, rp, nblk)))
    by_mp, by_s = {}, {}
    for nz_, s in ((16, 6), (64, 6), (112, 6), (64, 1), (64, 16)):
        a = synthetic_frame(device, 2304, nz_, s, True)
        t = device_ms(lambda: fk.frame_step(*a), kernel=H9_KERNELS, per_call=fk.FS_LAUNCHES)
        if s == 6:
            by_mp[fk.frame_shapes(nz_)[0]] = t
        if nz_ == 64:
            by_s[s] = t
    st.update(device_ms_by_mp=by_mp, device_ms_by_s=by_s, phases_us=h9_phases(fargs, plan))
    st["kernels_device_ms"] = {k: device_ms(lambda: fk.frame_step(*fargs), kernel=k)
                               for k in DEVICE_KERNELS["frame_step"]}
    log("  H9 device time against MP (S = 6): " + ", ".join(
        f"MP={m} {t * 1e3:.2f} us" for m, t in by_mp.items()) + "; against S (MP = 128): "
        + ", ".join(f"S={k} {t * 1e3:.2f} us" for k, t in sorted(by_s.items())))
    ph = st["phases_us"]
    flush = torch.empty((32 * 2**20,), dtype=torch.float32, device=device)
    for label, wipe in (("read", lambda: flush.sum()), ("write", lambda: flush.fill_(1.0))):
        for name, kern in (("H1", "sweep_inverse_kernel"), ("H4", "rank_update_kernel")):
            call = calls[name]
            alone[f"{name} after an L2 {label} flush"] = device_ms(
                lambda: (wipe(), call()), kernel=kern)
    st["alone_us"] = {k: v * 1e3 for k, v in alone.items()}
    log("  H1 and H4 alone after the L2 is flushed (device us): " + ", ".join(
        f"{k} {v * 1e3:.2f}" for k, v in alone.items() if "flush" in k))
    kd = st["kernels_device_ms"]
    log("  H9 phases beside the split's kernels alone on this frame (device us): chain "
        f"{ph['chain']:.2f} vs H2 {alone['H2'] * 1e3:.2f}; sweep {ph['sweep (block 0)']:.2f} "
        f"vs H1 {alone['H1'] * 1e3:.2f}; gains and mean {ph['gains and mean']:.2f} vs H3 {alone['H3'] * 1e3:.2f}; P pass "
        f"{ph['P pass']:.2f} vs H4 {alone['H4'] * 1e3:.2f}; device time: frame kernel "
        + " + ".join(f"{k} {v * 1e3:.2f}" for k, v in kd.items())
        + f" = {st['device_ms'] * 1e3:.2f} us")
    regs = {}
    for mp_ in range(32, fk.MAX_MP + 1, 32):
        pl = fk.frame_step_plan(d, mp_, device)
        regs[f"H9 frame kernel RX {mp_ // 32}"] = (pl.regs, pl.local)
        regs[f"H1 RX {mp_ // 32}"] = sweep_inverse_attributes(mp_, device)
    regs["H9 P pass"] = (plan.pass_regs, plan.pass_local)
    regs[f"H4 D {d}"] = rank_update_attributes(d, device)
    st["regs_local"] = regs
    log("  registers, local bytes a thread: " + ", ".join(
        f"{k} {r}, {b}" for k, (r, b) in regs.items()))
    return st


def stamp_phases(name: str, launch, shape: tuple, device, phase_times, launches: int = 20) -> dict:
    """A kernel's phases (H9, H10) from each block's %globaltimer at its
    phase boundaries: ``launch(stamps)`` runs it once with an int64
    ``stamps`` buffer of ``shape`` (ops.frame_kernel's _frame_step_h9 and
    _obs_step_h10), ``phase_times(stamps in us)`` reads one launch's phases;
    the median over ``launches`` launches.  The stamps add a block barrier
    at each phase's end."""
    import torch

    runs = []
    for _ in range(launches + 2):
        stamps = torch.zeros(shape, dtype=torch.int64, device=device)
        launch(stamps)
        runs.append(stamps)
    torch.cuda.synchronize()
    rows = [phase_times(stamps.cpu().double() / 1e3) for stamps in runs[2:]]
    phases = {k: float(torch.tensor([float(r[k]) for r in rows]).median()) for k in rows[0]}
    log(f"  {name} phases (median of {launches} launches, %globaltimer): " + ", ".join(
        f"{k} {v:.2f} us" for k, v in phases.items()))
    return phases


def resident_phase_times(t, g: int) -> dict:
    """The phases of a one-launch frame (H9, H10: the stamps of
    csrc/frame_step.cu and csrc/obs_step.cuh, one layout) from one launch's
    stamps ``t`` (grid + pass grid, 12) in us, its frame kernel's grid
    ``g``: in the frame kernel the chain, each barrier, block 0's sweep and
    its siv and NIS, the other blocks' pht units beside them, the gains and
    the mean (the first unit's S^-1 staged, its MG and its siv); the gap
    from the frame kernel's last block to the P pass's first (the
    programmatic launch); the P pass (its first block's start to its last
    block's end); the whole frame; and block 0's SM clock over the sweep
    (MHz, clock64 over %globaltimer)."""
    a, b = t[:g], t[g:]
    b = b[b[:, 0] > 0]          # the pass's blocks (a persistent plan leaves rows unused)
    last = a.max(dim=0).values
    ns = (t[0, 3] - t[0, 2]) * 1e3
    return {
        "chain": last[1] - a[:, 0].min(), "barrier 1": last[2] - last[1],
        "sweep (block 0)": a[0, 3] - a[0, 2],
        "pht units (other blocks)": a[1:, 3].max() - a[1:, 2].min(),
        "barrier 2": last[5] - a[:, 3].max(),
        "gains and mean": last[6] - last[5],
        "gains: S^-1 staged": (a[:, 9] - a[:, 5])[a[:, 9] > 0].max(),
        "gains: first unit's MG": (a[:, 10] - a[:, 9])[a[:, 9] > 0].max(),
        "gains: first unit's siv": (a[:, 11] - a[:, 9])[a[:, 9] > 0].max(),
        "siv and NIS (block 0, beside the gains)": a[0, 4] - a[0, 5],
        "launch gap": b[:, 0].min() - last[6], "P pass": b[:, 1].max() - b[:, 0].min(),
        "launch": b[:, 1].max() - a[:, 0].min(),
        "sweep SM clock MHz": (t[0, 8] - t[0, 7]) * 1e3 / ns * 1e3 if ns > 0 else 0.0}


def h9_phases(fargs, plan) -> dict:
    """H9's phases at frame_step's ``fargs`` (stamp_phases,
    resident_phase_times; its ``plan``, ops.frame_kernel.frame_step_plan)."""
    from conan_slam_tpu_torch.ops import frame_kernel as fk

    return stamp_phases("H9", lambda st: fk._frame_step_h9(*fargs, stamps=st),
                        (plan.grid + plan.pass_grid, fk.FS_STAMPS), fargs[0].device,
                        lambda t: resident_phase_times(t, plan.grid))


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
            alone = {"H2": stats["frame_chain"]["device_ms"],
                     "H1": stats["sweep_inverse"]["device_ms"],
                     "H3": stats["frame_panels"]["device_ms"],
                     "H4": stats["rank_update"]["device_ms"]}
            calls = {"H1": lambda: sweep_si(ch_p.s, fi.nblk),
                     "H4": lambda: rank_update_t(args[0], gmat, mmid)}
            # H1 on the S that H2's device code forms, which H9's chain
            # phase runs: the sweep's pivots and its decoupled block as H9's.
            h1_own = alone["H1 on H2's S"] = device_ms(lambda: sweep_si(ch_k.s, fi.nblk))
            log(f"  the frame's nblk {int(fi.nblk)}; H1 on the plain chain's S "
                f"{alone['H1'] * 1e3:.2f} us, on H2's {h1_own * 1e3:.2f} us")
            stats["frame_step"] = h9_measure(device, args, tail, e9, int(fi.nblk), alone, calls)
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


def h10_phases(uargs, plan, launches: int = 20) -> dict:
    """H10's phases at frame_update_obs's ``uargs`` (stamp_phases,
    resident_phase_times; its ``plan``, ops.frame_kernel.obs_step_plan)."""
    from conan_slam_tpu_torch.ops import frame_kernel as fk

    return stamp_phases("H10", lambda st: fk._obs_step_h10(*uargs, stamps=st),
                        (plan.grid + plan.pass_grid, fk.OS_STAMPS), uargs[0].device,
                        lambda t: resident_phase_times(t, plan.grid), launches)


def h10_alone_log(label: str, ph: dict, alone: dict, kd: dict, total: float) -> None:
    h1_own = alone["H1 on H7's S"]
    log(f"  H10 {label} phases beside the split's kernels alone on this frame (device us): "
        f"sweep {ph['sweep (block 0)']:.2f} vs H1 {alone['H1'] * 1e3:.2f} (on the frame's S; "
        f"{h1_own * 1e3:.2f} on the S of H7's device code, which H10 runs); "
        f"gains and mean {ph['gains and mean']:.2f}; P pass {ph['P pass']:.2f} vs H4 "
        f"{alone['H4'] * 1e3:.2f} (on the frame's G and MG); device time: "
        + " + ".join(f"{k} {v * 1e3:.2f}" for k, v in kd.items())
        + f" = {total * 1e3:.2f} us (the span of its two kernels)")


def h10_turns(label: str, uargs, iters: int = 20) -> list:
    """H10 against the split schedule on one gated frame, in turns (H10,
    split, split, H10): the device time of a call, H10's the span of its two
    kernels (its P pass is resident, waiting, before its frame kernel ends),
    the split's the sum of its kernels and copies."""
    from conan_slam_tpu_torch.ops import frame_kernel as fk

    h10 = lambda: fk.frame_update_obs(*uargs)                     # noqa: E731
    split = lambda: fk.frame_update_obs(*uargs, schedule="split")  # noqa: E731
    turns = [device_ms(h10, iters=iters, kernel=H10_KERNELS, per_call=fk.OS_LAUNCHES) if h
             else device_ms(split, iters=iters) for h in (True, False, False, True)]
    log(f"  H10 vs split at {label}, device time of a call in turns: " + ", ".join(
        f"{n} {t * 1e3:.2f} us" for n, t in zip(("H10", "split", "split", "H10"), turns))
        + f"; H10 / split {(turns[0] + turns[3]) / (turns[1] + turns[2]):.3f}")
    return turns


def h10_regs(device, d: int, nbp: int) -> dict:
    """Registers and local-memory bytes a thread of each H10 frame-kernel
    variant and of its P pass at both tile edges, beside H1's and H4's."""
    from conan_slam_tpu_torch.ops import frame_kernel as fk
    from conan_slam_tpu_torch.ops.rank_update import rank_update_attributes
    from conan_slam_tpu_torch.ops.spd_inverse import sweep_inverse_attributes

    regs = {}
    for mp_ in range(32, fk.MAX_MP + 1, 32):
        pl = fk.obs_step_plan(d, mp_, nbp, device)
        regs[f"H10 frame kernel RX {mp_ // 32}"] = (pl.regs, pl.local)
        regs[f"H1 RX {mp_ // 32}"] = sweep_inverse_attributes(mp_, device)
    for dd in (d, 20_224):
        pl = fk.obs_step_plan(dd, 128, nbp, device)
        regs[f"H10 P pass tile {pl.tile}"] = (pl.pass_regs, pl.pass_local)
        regs[f"H4 D {dd}"] = rank_update_attributes(dd, device)
    log("  registers, local bytes a thread: " + ", ".join(
        f"{k} {r}, {b}" for k, (r, b) in regs.items()))
    return regs


def h10_measure(device, uargs, err: float, nblk: int, alone: dict) -> dict:
    """H10 at config 2's check frame: CUDA-event time of the wrapper,
    device time (profiler: the span of its two kernels), the plain
    version's time, its plan, bound and phases, beside H1 and H4 run alone
    on the frame's S and on its G and MG (``alone``, device ms); its device
    time against MP (32, 128, 224 at NBP 24) and NBP (16, 24, 56 at MP 128)
    on synthetic frames at D = 1024; the split schedule's device time on
    the same frame, in turns (H10, split, split, H10); and each variant's
    registers and local-memory bytes."""
    import torch

    from conan_slam_tpu_torch.ops import frame_kernel as fk

    d, nz, nbp = uargs[0].shape[0], uargs[4].shape[0], uargs[8].shape[0]
    mp, rp = fk.frame_shapes(nz)
    plan = fk.obs_step_plan(d, mp, nbp, device)
    out = fk.frame_update_obs(*uargs)
    ins = [a for a in uargs if torch.is_tensor(a)]
    h10 = lambda: fk.frame_update_obs(*uargs)                     # noqa: E731
    split = lambda: fk.frame_update_obs(*uargs, schedule="split")  # noqa: E731
    turns = h10_turns("config 2", uargs)
    st = dict(max_abs_err=err, library_ms=None, ms=time_ms(h10, 50),
              device_ms=device_ms(h10, kernel=H10_KERNELS, per_call=fk.OS_LAUNCHES),
              plain_ms=time_ms(lambda: fk.frame_update_obs(*uargs, plain=True), 10),
              split_ms=time_ms(split, 50), device_ms_turns=turns,
              plan=f"frame kernel: grid {plan.grid} x {plan.block} threads, {plan.smem:,} B "
                   f"shared, {plan.regs} registers; {plan.bands} chain bands, {plan.units} "
                   f"units of {plan.unit} columns; P pass: grid {plan.pass_grid} x "
                   f"{plan.pass_block} threads ({plan.pass_occ} an SM), {plan.pass_smem:,} B "
                   f"shared, {plan.pass_regs} registers, {plan.tiles} tiles of {plan.tile}",
              **bound(nbytes(*ins, *out), h10_work(d, mp, rp, nbp, nblk)))
    by_mp, by_nbp = {}, {}
    for nz_, s, h in ((16, 6, True), (64, 6, True), (112, 6, True), (64, 6, False),
                      (64, 18, True)):
        a = synthetic_gated(device, 1024, nz_, s, h)
        t = device_ms(lambda: fk.frame_update_obs(*a), kernel=H10_KERNELS,
                      per_call=fk.OS_LAUNCHES)
        if (s, h) == (6, True):
            by_mp[fk.frame_shapes(nz_)[0]] = t
        if nz_ == 64:
            by_nbp[a[8].shape[0]] = t
    st.update(device_ms_by_mp=by_mp, device_ms_by_nbp=by_nbp, phases_us=h10_phases(uargs, plan),
              alone_us={k: v * 1e3 for k, v in alone.items()},
              kernels_device_ms={k: device_ms(h10, kernel=k) for k in DEVICE_KERNELS["obs_step"]})
    h10_alone_log("config 2", st["phases_us"], alone, st["kernels_device_ms"], st["device_ms"])
    log("  H10 device time against MP (NBP 24): " + ", ".join(
        f"MP={m} {t * 1e3:.2f} us" for m, t in by_mp.items()) + "; against NBP (MP 128): "
        + ", ".join(f"NBP={k} {t * 1e3:.2f} us" for k, t in sorted(by_nbp.items())))
    st["regs_local"] = h10_regs(device, d, nbp)
    return st


def h10_cold_sweep(device, p_big, g_big, mg_big) -> dict:
    """Block 0's sweep in H10 (its stamps) beside H1 alone on the same S, on
    a synthetic gated frame at D = 1024 with all 64 slots valid: back to
    back, and each right after H4's pass over the 10k shape's P, G and MG
    (``p_big``, ...: 1.64 GB through the L2), as a frame finds the card
    after a 10k frame's P pass; the median of 8 launches, in us."""
    import statistics

    import torch

    from conan_slam_tpu_torch.ops import frame_kernel as fk
    from conan_slam_tpu_torch.ops.rank_update import rank_update_vbt
    from conan_slam_tpu_torch.ops.spd_inverse import sweep_si

    a = synthetic_gated(device, 1024, 64)
    a = a[:6] + (torch.ones_like(a[6]),) + a[7:]
    p, x, slots, cap, zr, zb, mask, r, bmat, vtf = a
    oi = fk.obs_inputs(p, x, fk.frame_rows(slots, cap), zr, zb, mask, r, vtf)
    s = fk.obs_chain(oi.zin, oi.rsc, oi.xrows, oi.prc, oi.vrows, bmat, oi.mp)[0]
    plan = fk.obs_step_plan(1024, oi.mp, bmat.shape[0], device)
    out = {}
    for label, pre in (("back to back", lambda: None),
                       ("after H4's 10k pass", lambda: rank_update_vbt(p_big, g_big, mg_big))):
        h1 = device_ms(lambda: (pre(), sweep_si(s, oi.nblk)), iters=8, kernel="sweep_inverse_kernel")
        sweeps = []
        for _ in range(10):
            pre()
            st = torch.zeros((plan.grid + plan.pass_grid, fk.OS_STAMPS), dtype=torch.int64,
                             device=device)
            fk._obs_step_h10(*a, stamps=st)
            torch.cuda.synchronize()
            sweeps.append(float(st[0, 3] - st[0, 2]) / 1e3)
        out[label] = {"H10 sweep": statistics.median(sweeps[2:]), "H1": h1 * 1e3}
    log(f"  H10's sweep and H1 alone on one S (D 1024, nblk {int(oi.nblk)}), back to back and "
        "right after H4's pass over the 10k P: " + "; ".join(
            f"{k}: sweep {v['H10 sweep']:.2f}, H1 {v['H1']:.2f} us" for k, v in out.items()))
    return out


def gate_margins(st1, obs, noise, cfg, vtf, bmat, min_nis) -> dict:
    """The measurements whose association may rightly differ between two
    fp32 routes of the gating, from the dense scores of the frame's virtual
    covariance (``min_nis`` the plain version's): ``tie``, a runner-up nd
    within the NIS tolerance of the best; ``near_reject``, a slot's nis
    that close to gate_reject; ``near_augment``, a min nis that close to
    gate_augment."""
    import torch

    from conan_slam_tpu_torch.filters.ekf.associate import gated_scores_dense

    nis_tol = lambda v: 1e-3 + 1e-4 * v.abs()  # noqa: E731
    nis_d, nd_d = gated_scores_dense(st1, obs.z, noise.re, vtf.T, bmat)
    nd_g = torch.where(nis_d < cfg.gate_reject, nd_d, torch.inf)
    two = nd_g.topk(2, dim=1, largest=False).values
    gate_r, gate_a = torch.tensor(cfg.gate_reject), torch.tensor(cfg.gate_augment)
    return dict(tie=(two[:, 1] - two[:, 0]) <= nis_tol(two[:, 0]),
                near_reject=((nis_d - cfg.gate_reject).abs() <= nis_tol(gate_r)).any(dim=1),
                near_augment=(min_nis - cfg.gate_augment).abs() <= nis_tol(gate_a))


def gate_checks(name: str, got, ref, obs, cfg, near: dict) -> float:
    """A gating's ``(best_nd, best_j, min_nis)`` against its plain
    version's: the scores within the NIS tolerance; found, new and the best
    slot equal except where ``near`` (gate_margins) exempts a measurement.
    Returns the best nd's max abs error."""
    nd_k, j_k, mn_k = got
    nd_p, j_p, mn_p = ref
    found_k, found_p = nd_k < 1e38, nd_p < 1e38
    both = found_k & found_p
    err = check(f"{name} best nd", nd_k[both], nd_p[both], 1e-4, 1e-3,
                "same algebra; atan2f/remainder wrap and FMA contraction: ulps of "
                "km-scale predictions, ~1e-4 of a NIS")
    check(f"{name} min nis", mn_k, mn_p, 1e-4, 1e-3, "as best nd")
    valid, near_reject = obs.mask, near["near_reject"]
    require(bool(((found_k == found_p) | near_reject | ~valid).all()), f"{name} found",
            f"equal except within tolerance of gate_reject ({int((near_reject & valid).sum())} "
            "valid measurements that close)")
    new_k = valid & ~found_k & (mn_k > cfg.gate_augment)
    new_p = valid & ~found_p & (mn_p > cfg.gate_augment)
    require(bool(((new_k == new_p) | near["near_augment"] | near_reject | ~valid).all()),
            f"{name} new", f"equal except within tolerance of gate_augment "
            f"({int((near['near_augment'] & valid).sum())} valid measurements that close)")
    exact = both & ~near["tie"]
    require(bool((j_k[exact] == j_p[exact]).all()), f"{name} best slot",
            f"equal on {int(exact.sum())} measurements whose runner-up is further than "
            f"the tolerance ({int((both & near['tie']).sum())} near-ties left out)")
    return err


def h15_checks(label: str, fgargs, h5_out, obs, cfg, near: dict) -> float:
    """H15 at factor_gate's ``fgargs`` against its plain version: the
    factors bit for bit H5's entry (``h5_out``: the same strip blocks) and
    within H5's tolerances of the plain version; the scores and the
    association as gate_checks holds H6's; the association result its own
    scores' mask rule; two launches in a row bit-equal (the reduction's
    scratch resets itself)."""
    import torch

    from conan_slam_tpu_torch.ops.factor_kernel import _factor_gate_reference, factor_gate

    got, again = factor_gate(*fgargs), factor_gate(*fgargs)
    ref = _factor_gate_reference(*fgargs)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip((got.x, got.pose_trace, got.vtf, got.bmat),
                                                  (h5_out[0].x, *h5_out[1:])))
    require(same, f"H15 {label} factors", "bit for bit H5's entry (the same strip blocks)")
    check(f"H15 {label} pose trace", got.pose_trace, ref.pose_trace, 1e-6, 1e-4,
          "~5 km positions: a few fp32 ulps (4.9e-4 m), sinf/cosf vs torch")
    check(f"H15 {label} post-frame mean", got.x, ref.x, 1e-6, 1e-3, "~5 km means: fp32 ulps")
    err = gate_checks(f"H15 {label}", got[4:7], ref[4:7], obs, cfg, near)
    found = got.best_nd < 1e38
    rule = (torch.equal(got.known_mask, obs.mask & found)
            and torch.equal(got.slots, torch.where(found, got.best_j.to(torch.int64), 0))
            and torch.equal(got.new_mask, obs.mask & ~found & (got.min_nis > cfg.gate_augment)))
    require(rule, f"H15 {label} association result", "associate_gated's mask rule on its own "
            "scores (known, slots, new)")
    require(all(torch.equal(a, b) for a, b in zip(got, again)), f"H15 {label} two launches",
            "bit for bit (the reduction's scratch resets itself)")
    return err


def h5_phase_times(t) -> dict:
    """H5's entry's phases from one launch's stamps ``t`` (strip blocks,
    FG_STAMPS) in us: the recursion, the strip write, the launch's span."""
    return {"recursion (slowest block)": (t[:, 1] - t[:, 0]).max(),
            "strip write (slowest block)": (t[:, 2] - t[:, 1]).max(),
            "start skew": t[:, 0].max() - t[:, 0].min(),
            "launch span": t[:, 2].max() - t[:, 0].min()}


def h15_phase_times(t, n_strip: int) -> dict:
    """H15's phases from one launch's stamps ``t`` (strip blocks, then
    gating blocks; FG_STAMPS each; csrc/factor_gate.cu fg_stamp) in us: the
    recursion (its slowest block, the controls' packing and the fold
    included), the strip write, the gating blocks' slot table and scores,
    the last gating block's result, the blocks' start skew and the span."""
    s, g = t[:n_strip], t[n_strip:]
    r = int(g[:, 4].argmax())
    return {"recursion (slowest block)": (t[:, 1] - t[:, 0]).max(),
            "strip write (slowest strip block)": (s[:, 2] - s[:, 1]).max(),
            "slot table (slowest gating block)": (g[:, 2] - g[:, 1]).max(),
            "scores (slowest gating block)": (g[:, 3] - g[:, 2]).max(),
            "result (last gating block)": g[r, 4] - g[r, 3],
            "start skew": t[:, 0].max() - t[:, 0].min(),
            "launch span": max(s[:, 2].max(), g[r, 4]) - t[:, 0].min()}


def h15_phases(fgargs, launches: int = 20) -> tuple[dict, dict]:
    """H15's phases and H5's entry's on the same frame (stamp_phases)."""
    from conan_slam_tpu_torch.ops.factor_kernel import (
        FG_STAMPS,
        factor_gate,
        factor_gate_grid,
        frame_factors_fused,
    )

    state = fgargs[0]
    dev, d = state.x.device, state.x.shape[0]
    n_strip, n_gate, _ = factor_gate_grid(d, state.capacity, dev)
    h15 = stamp_phases("H15", lambda st: factor_gate(*fgargs, stamps=st),
                       (n_strip + n_gate, FG_STAMPS), dev, lambda t: h15_phase_times(t, n_strip),
                       launches)
    h5 = stamp_phases("H5's entry", lambda st: frame_factors_fused(*fgargs[:10], stamps=st),
                      (n_strip, FG_STAMPS), dev, h5_phase_times, launches)
    return h15, h5


def h15_turns(label: str, fgargs, obs, iters: int = 20) -> dict:
    """H15 against the two-launch route it replaced on one frame (H5's
    entry, the host fold, H6's entry and the mask rule: the frame loop's
    factors_then_associate), in turns (H15, two, two, H15): the device time of a
    call (every kernel and copy it launches) and its CUDA-event time."""
    from conan_slam_tpu_torch.filters.ekf.associate import factors_then_associate
    from conan_slam_tpu_torch.ops.factor_kernel import factor_gate

    two = lambda: factors_then_associate(*fgargs[:10], obs, *fgargs[12:])   # noqa: E731
    h15 = lambda: factor_gate(*fgargs)   # noqa: E731
    order = (h15, two, two, h15)
    dev = [device_ms(fn, iters=iters) for fn in order]
    ms = [time_ms(fn, 50) for fn in order]
    log(f"  H15 vs H5 + fold + H6 + mask rule at {label}, in turns: device "
        + ", ".join(f"{n} {t * 1e3:.2f} us" for n, t in zip(("H15", "two", "two", "H15"), dev))
        + "; wrapper " + ", ".join(f"{n} {t:.4f} ms" for n, t in
                                   zip(("H15", "two", "two", "H15"), ms)))
    return {"device_ms": dev, "wrapper_ms": ms}


def h15_measure(device, label: str, fgargs, obs, err: float, nb: int, n_act: int) -> dict:
    """H15 at config 2's check frame: CUDA-event time of the wrapper,
    device time (profiler), the plain version's time, its grid, bound and
    phases beside H5's entry's, registers and local bytes of H15 and of H5's
    and H6's entries, and the parent's two-launch route in turns."""
    from conan_slam_tpu_torch.ops.factor_kernel import (
        _factor_gate_reference,
        factor_gate,
        factor_gate_attributes,
        factor_gate_grid,
    )

    state, nz = fgargs[0], fgargs[10].shape[0]
    d, k = state.x.shape[0], state.capacity
    n_strip, n_gate, tile = factor_gate_grid(d, k, device)
    out = factor_gate(*fgargs)
    h15 = lambda: factor_gate(*fgargs)   # noqa: E731
    # Read once: the controls, Q, R, z, the mask, x0 and P0's row 2, and at
    # each active slot P0's pose rows and diagonal block (10 floats); written
    # once: every output.  Operations: one product a vtf entry (the map rows
    # are p2[n] c[0]) and an add in its three pose rows, one FMA a mean
    # entry, ~70 an active slot's S_j, ~15 an active pair.
    ins = nbytes(*fgargs[1:6], *fgargs[10:13]) + 4 * (2 * d + 10 * n_act)
    phases, h5_phases = h15_phases(fgargs)
    st = dict(max_abs_err=err, library_ms=None, ms=time_ms(h15, 50),
              device_ms=device_ms(h15, kernel="factor_gate_kernel"),
              plain_ms=time_ms(lambda: _factor_gate_reference(*fgargs), 10),
              plan=f"{n_strip} strip blocks and {n_gate} gating blocks of {tile} slots, "
                   "256 threads each",
              phases_us=phases, h5_phases_us=h5_phases,
              regs_local=factor_gate_attributes(device),
              turns=h15_turns(label, fgargs, obs),
              **bound(ins + nbytes(*out), 1.0 * nb * d + 3.0 * nb + 2.0 * d + 70.0 * n_act
                      + 15.0 * nz * n_act))
    log(f"  H15 at {label}: {st['device_ms'] * 1e3:.2f} us device ({st['plan']}); registers, "
        "local bytes a thread: " + ", ".join(f"{n} {r}, {b}" for n, (r, b) in
                                             st["regs_local"].items()))
    return st


def h15_measure_10k(label: str, fgargs, obs, st: dict, gargs) -> None:
    """H15 at the 10k shape into ``st`` (h15_measure's): its device time,
    phases and turns against the two-launch route, H6's entry alone."""
    from conan_slam_tpu_torch.ops.factor_kernel import factor_gate, factor_gate_grid
    from conan_slam_tpu_torch.ops.gating_kernel import gating_scores

    state = fgargs[0]
    n_strip, n_gate, tile = factor_gate_grid(state.x.shape[0], state.capacity, state.x.device)
    phases, h5_phases = h15_phases(fgargs, launches=10)
    st.update(device_ms_10k=device_ms(lambda: factor_gate(*fgargs), kernel="factor_gate_kernel"),
              phases_us_10k=phases, h5_phases_us_10k=h5_phases,
              h6_device_ms_10k=device_ms(lambda: gating_scores(*gargs),
                                         kernel="gating_scores_kernel"),
              turns_10k=h15_turns(label, fgargs, obs, iters=10),
              plan_10k=f"{n_strip} strip blocks and {n_gate} gating blocks of {tile} slots")
    log(f"  H15 at {label}: {st['device_ms_10k'] * 1e3:.2f} us device ({st['plan_10k']}), H6's "
        f"entry alone {st['h6_device_ms_10k'] * 1e3:.2f} us")


def gated_kernel_checks(device) -> dict:
    """Phase 3b: the gated frame's kernels against their plain versions.
    Each kernel is fed its plain upstream's outputs."""
    import torch

    from conan_slam_tpu_torch.ops import frame_kernel as fk
    from conan_slam_tpu_torch.ops.factor_kernel import (
        _frame_factors_reference,
        frame_factors_fused,
    )
    from conan_slam_tpu_torch.ops.gating_kernel import (
        _gating_scores_reference,
        _innovation_blocks,
        gating_scores,
    )
    from conan_slam_tpu_torch.ops.rank_update import (
        rank_update_t,
        rank_update_t_reference,
        rank_update_vbt,
    )
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

        # H6's entry on the virtual covariance P + vtf^T B vtf, folded on
        # the host as H6's route folds it (_innovation_blocks).
        blocks = [b.contiguous() for b in _innovation_blocks(st1, vtf.T, bmat)]
        gargs = (obs.z.contiguous(), st1.pose, st1.features, st1.active_mask, *blocks,
                 noise.re, cfg.gate_reject)
        nd_k, j_k, mn_k = gating_scores(*gargs)
        nd_p, j_p, mn_p = _gating_scores_reference(*gargs)
        found_p = nd_p < 1e38
        gate_near = gate_margins(st1, obs, noise, cfg, vtf, bmat, mn_p)
        e6 = gate_checks(f"H6 {label}", (nd_k, j_k, mn_k), (nd_p, j_p, mn_p), obs, cfg, gate_near)
        # H15: the factors and the association in one launch, against its
        # plain version (H5's, the fold, H6's and the mask rule).
        fgargs = (*fargs, obs.z, obs.mask, noise.re, cfg.gate_reject, cfg.gate_augment)
        e15 = h15_checks(label, fgargs, fk_k, obs, cfg, gate_near)
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
            # H6: each active slot's 2x2 innovation covariance and its
            # geometry (~70 operations), then ~15 an active measurement-slot
            # pair (inactive slots are skipped).
            n_act = int(st1.n_active)
            stats["gating_scores"] = dict(
                max_abs_err=e6, ms=time_ms(lambda: gating_scores(*gargs), 50),
                device_ms=device_ms(lambda: gating_scores(*gargs), kernel="gating_scores_kernel"),
                plain_ms=time_ms(lambda: _gating_scores_reference(*gargs), 10), library_ms=None,
                **bound(nbytes(*(a for a in gargs if torch.is_tensor(a)), nd_k, j_k, mn_k),
                        70.0 * n_act + 15.0 * nz * n_act))
            stats["factor_gate"] = h15_measure(device, label, fgargs, obs, e15, nb, n_act)
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
            alone = {"H1": stats["gated sweep_inverse"]["device_ms"],
                     "H1 on H7's S": device_ms(lambda: sweep_si(s_k, oi.nblk)),
                     "H4": stats["gated rank_update"]["device_ms"]}
            stats["obs_step"] = h10_measure(device, uargs, e10, int(oi.nblk), alone)
        if label.startswith("10k"):
            h15_measure_10k(label, fgargs, obs, stats["factor_gate"], gargs)
            # H10 against the split at the 10k-landmark shape, where the P
            # pass dominates: each call's device time in turns.
            h10 = lambda: fk.frame_update_obs(*uargs)                     # noqa: E731
            turns = h10_turns(label, uargs, iters=5)
            big = bound(nbytes(*(a for a in uargs if torch.is_tensor(a)), *full_k),
                        h10_work(d, oi.mp, oi.prows.shape[0], bmat.shape[0], int(oi.nblk)))
            plan = fk.obs_step_plan(d, oi.mp, bmat.shape[0], device)
            stats["obs_step"].update(
                device_ms_10k=device_ms(h10, iters=5, kernel=H10_KERNELS,
                                        per_call=fk.OS_LAUNCHES),
                device_ms_turns_10k=turns, bound_ms_10k=big["bound_ms"],
                bound_by_10k=big["bound_by"], tile_10k=plan.tile,
                phases_us_10k=h10_phases(uargs, plan, launches=5))
            mg = mmid @ gmat
            # H1 also right behind H4's pass over this P (1.64 GB through
            # the L2), as the frame kernel's sweep runs after the last
            # frame's P pass.
            alone = {"H1": device_ms(lambda: sweep_si(s_p, oi.nblk), iters=5),
                     "H1 on H7's S": device_ms(lambda: sweep_si(s_k, oi.nblk), iters=5),
                     "H4": device_ms(lambda: rank_update_vbt(st1.p, gmat, mg), iters=5),
                     "H1 after H4's pass": device_ms(
                         lambda: (rank_update_vbt(st1.p, gmat, mg), sweep_si(s_k, oi.nblk)),
                         iters=5, kernel="sweep_inverse_kernel")}
            kd = {k: device_ms(h10, iters=5, kernel=k) for k in DEVICE_KERNELS["obs_step"]}
            stats["obs_step"].update(alone_us_10k={k: v * 1e3 for k, v in alone.items()},
                                     kernels_device_ms_10k=kd)
            h10_alone_log("10k", stats["obs_step"]["phases_us_10k"], alone, kd,
                          stats["obs_step"]["device_ms_10k"])
            behind = alone["H1 after H4's pass"]
            log(f"  H1 on H7's S right behind H4's pass over this P: {behind * 1e3:.2f} us")
            stats["obs_step"]["cold_sweep_us"] = h10_cold_sweep(device, st1.p, gmat, mg)
            log(f"  H10 at {label}: {stats['obs_step']['device_ms_10k'] * 1e3:.2f} us (P-pass "
                f"tile {plan.tile}, units of {plan.unit} columns), bound "
                f"{big['bound_ms'] * 1e3:.2f} us ({big['bound_by']})")
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
    from conan_slam_tpu_torch.ops import frame_kernel as fk

    update = importlib.import_module("conan_slam_tpu_torch.filters.ekf.update")

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
        want = {**dict.fromkeys(res["counts"], 0), **per_frame(kernels, n_frames)}
        route = "H9's two kernels" if schedule == "auto" else "H1-H4"
        require(res["counts"] == want, f"known path launches ({schedule})",
                f"{route} once per frame ({n_frames}), no other kernel")
        require(res["ate"] < 0.05 and res["asym"] < 1e-4, f"accuracy gate ({schedule})",
                f"ATE {res['ate']:.4f} < 0.05 m, asym(P) {res['asym']:.2e} < 1e-4")
        if schedule == "auto":
            require(res["asym"] == 0.0, "exact symmetry through H9",
                    f"asym(P) {res['asym']:.1e} after {n_frames} frames (must be exactly 0: its "
                    "P pass mirrors its upper-triangle tiles, from an exactly symmetric P)")
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


def valet_reference(device):
    """The committed reference run: its draws on ``device`` and, on the
    host, its trajectories and ATE."""
    import torch

    from conan_slam_tpu_torch.runner.metrics import ate_rmse

    data = np.load(VALET_DATA)
    ref = {k: torch.as_tensor(data[k]) for k in data.files}
    ref["ate"] = float(ate_rmse(ref["x_true"], ref["x_est_known"], ~ref["done_known"]))
    return ref, ref["ctrl"].to(device), ref["obs"].to(device)


def config2_reference(device):
    """The committed config 2 draws as run_ekf_slam takes them, on
    ``device``: ``(ctrl (4167, 6, 2), obs (4167, 500, 2), the reference's
    ATE, its map size)``, each frame's returns outside the kept ids zero
    (they never reach the filter)."""
    import torch

    data = np.load(CONFIG2_DATA)
    ids = data["obs_ids"].astype(np.int64)
    obs = np.zeros((ids.shape[0], 500, 2), np.float32)
    rows, cols = np.nonzero(ids >= 0)
    obs[rows, ids[rows, cols]] = data["obs_vals"][rows, cols]
    return (torch.as_tensor(data["ctrl"]).to(device), torch.as_tensor(obs).to(device),
            float(data["ate"]), int(data["mapped"]))


def drive_sim(world, cfg, steps: int, ctrl, obs, plain: bool = False) -> dict:
    """One timed run_ekf_slam run of ``steps`` steps on the draws
    ``ctrl``/``obs``, after an untimed 60-step run, with the launch counts
    of the timed run alone."""
    import torch

    from conan_slam_tpu_torch.ops import cuda
    from conan_slam_tpu_torch.runner.loop import run_ekf_slam
    from conan_slam_tpu_torch.runner.metrics import ate_rmse

    def go(n):
        f = -(-n // cfg.observe_interval)
        return run_ekf_slam(world, cfg, None, n, plain=plain, ctrl_noise=ctrl[:f],
                            obs_noise=obs[:f])

    go(60)
    torch.cuda.synchronize()
    cuda.reset_launch_counts()
    t0 = time.perf_counter()
    carry, outs = go(steps)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n = outs.x_est.shape[0]
    done = outs.done.cpu()
    return dict(steps_per_s=n / secs, seconds=secs, counts=launches(), outs=outs, carry=carry,
                ate=float(ate_rmse(outs.x_true, outs.x_est, ~outs.done)),
                mapped=int(carry.state.n_active),
                done_at=int(done.to(torch.int8).argmax()) if bool(done.any()) else -1,
                finite=bool(torch.isfinite(carry.state.p).all()
                            and torch.isfinite(outs.x_est).all()))


def sync_free(label: str, world, cfg, ctrl, obs) -> None:
    """``SIM_SYNC_STEPS`` steps of run_ekf_slam on the draws ``ctrl``/``obs``
    under the sync debug mode, which raises at any operation that makes the
    host wait for the card."""
    import torch

    from conan_slam_tpu_torch.runner.loop import run_ekf_slam

    f = SIM_SYNC_STEPS // cfg.observe_interval
    torch.cuda.synchronize()
    err = ""
    torch.cuda.set_sync_debug_mode("error")
    try:
        run_ekf_slam(world, cfg, None, SIM_SYNC_STEPS, ctrl_noise=ctrl[:f], obs_noise=obs[:f])
    except RuntimeError as e:
        err = str(e).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    require(not err, f"no host sync ({label})",
            f"{SIM_SYNC_STEPS} steps of run_ekf_slam under set_sync_debug_mode('error')"
            + (f": {err}" if err else ""))


def as_double(a):
    """``a`` (a tensor, a NamedTuple of tensors or a number) with its
    floating-point tensors in float64."""
    import torch

    if isinstance(a, tuple):
        items = (as_double(t) for t in a)
        return type(a)(*items) if hasattr(a, "_fields") else tuple(items)
    return a.double() if torch.is_tensor(a) and a.is_floating_point() else a


def valet_frame(device, world, cfg, ctrl, obs):
    """Frame VALET_FRAME of the valet course on the reference's draws
    ``ctrl``/``obs``, at its own shape (D 67, NZ 30): the carry after the
    frames before it through run_ekf_slam with the plain versions, then the
    frame's sub-steps and measurement buffer as ekf_frame_step forms them.
    Returns ``(state, (vns, swans, phis, actives), buffer, noise)``; the
    plain versions leave P asymmetric by fp32 rounding."""
    import torch

    from conan_slam_tpu_torch.runner import loop

    f = VALET_FRAME
    carry, _ = loop.run_ekf_slam(world, cfg, None, f * cfg.observe_interval, plain=True,
                                 ctrl_noise=ctrl[:f], obs_noise=obs[:f])
    st, x_true, subs = carry.steer, carry.x_true, []
    for k in range(cfg.observe_interval):
        was_done = st.done
        st, x_true, vn, swan = loop._advance_truth(st, x_true, world, cfg, ctrl[f, k])
        subs.append((vn, swan, x_true[2], ~was_done))
    return (carry.state, tuple(torch.stack(a) for a in zip(*subs)),
            loop._sense(x_true, world, cfg, obs[f]), loop.make_noise(cfg, device=device))


def valet_kernel_checks(device, world, ctrl, obs) -> dict:
    """H9, H15 and H10 at a frame of the valet course (valet_frame, heading
    on) against their plain versions at phase 3's tolerances and H15's
    strip at the card tests' (rtol 1e-4, atol 1e-5), each beside its
    float64 witness, on the frame's P made symmetric, as the kernels' own
    runs keep it.  First, on the plain run's own asymmetric P, H15's strip
    against the plain version on P and on P with row 2 as its column 2
    (H15 reads the row, the plain version the column), and the float64
    witnesses of both.  Returns the witness distances."""
    import torch

    from conan_slam_tpu_torch.config import SlamConfig
    from conan_slam_tpu_torch.filters.ekf import associate_known
    from conan_slam_tpu_torch.ops import frame_kernel as fk
    from conan_slam_tpu_torch.ops.factor_kernel import (
        _factor_gate_reference,
        _frame_factors_reference,
        factor_gate,
        frame_factors_fused,
    )

    label = f"valet frame {VALET_FRAME}, D=67"
    dist = lambda a, b: float((a.double() - b.double()).abs().max())  # noqa: E731
    out = {}

    # Known association: H9.
    cfg = SlamConfig()
    state, sub, buf, noise = valet_frame(device, world, cfg, ctrl, obs)
    d, nz = state.x.shape[0], buf.z.shape[0]
    log(f"valet frame kernels at {label} (NZ={nz}, mapped={int(state.n_active)}, "
        f"{int(buf.mask.sum())} returns; P from the plain run, asymmetric by "
        f"{float((state.p - state.p.T).abs().max()):.2e}, symmetrized):")
    require(fk.frame_route(d, nz, device, cfg.observe_interval) == "resident",
            f"H9 route at {label}", "resident (H9)")
    assoc = associate_known(state, buf)
    args = (0.5 * (state.p + state.p.T), state.x, assoc.slots, state.capacity, *sub, noise.qe,
            buf.z[:, 0], buf.z[:, 1], assoc.known_mask, noise.re)
    tail = (cfg.wheel_base, cfg.dt_controls, cfg.sigma_heading, cfg.switch_heading_known)
    split = fk.frame_step(*args, *tail, schedule="split")
    oracle = fk._plain_frame(args[0], args[1], fk.frame_rows(args[2], args[3]), *args[4:], tail)
    h9_checks(label, args, tail, split, oracle)
    wit = known_witness((*args, *tail))
    got, plain = fk.frame_step(*args, *tail), fk.frame_step(*args, *tail, plain=True)
    out["h9"] = dict(x_kernel=dist(got.x, wit.x), x_plain=dist(plain.x, wit.x),
                     p_kernel=dist(got.p, wit.p), p_plain=dist(plain.p, wit.p))
    log("  float64 witness at {}: |x - x64| plain {x_plain:.3e}, H9 {x_kernel:.3e}; "
        "|P - P64| plain {p_plain:.3e}, H9 {p_kernel:.3e}".format(label, **out["h9"]))

    # Gated association: H15, then H10.
    cfg = SlamConfig(switch_association_known=False)
    state, sub, buf, noise = valet_frame(device, world, cfg, ctrl, obs)
    ftail = (noise.qe, cfg.wheel_base, cfg.dt_controls, cfg.sigma_heading,
             cfg.switch_heading_known)
    gtail = (buf.z, buf.mask, noise.re, cfg.gate_reject, cfg.gate_augment)
    p_row = state.p.clone()
    p_row[:, 2] = state.p[2]
    on_row = state._replace(p=p_row)
    strip = factor_gate(state, *sub, *ftail, *gtail).vtf
    col, row = (_frame_factors_reference(st, *sub, *ftail)[2] for st in (state, on_row))
    w_col, w_row = (_frame_factors_reference(as_double(st), *as_double(sub), *as_double(ftail))[2]
                    for st in (state, on_row))
    out["h15_asym"] = dict(
        asym=float((state.p - state.p.T).abs().max()), kernel_plain=dist(strip, col),
        kernel_plain_row=dist(strip, row), witness_row_col=dist(w_row, w_col),
        kernel_witness_row=dist(strip, w_row), plain_witness_col=dist(col, w_col),
        scale=float(w_col.abs().max()))
    log("  H15's strip on the plain run's P (asymmetric by {asym:.2e}; |vtf| up to {scale:.2f}): "
        "|H15 - plain| {kernel_plain:.3e}, |H15 - plain on P with row 2 as column 2| "
        "{kernel_plain_row:.3e}; float64 witnesses: |w(row 2) - w(column 2)| "
        "{witness_row_col:.3e}, |H15 - w(row 2)| {kernel_witness_row:.3e}, "
        "|plain - w(column 2)| {plain_witness_col:.3e}".format(**out["h15_asym"]))
    check(f"H15 {label} vtf on the plain run's P vs the plain version on its row 2", strip, row,
          1e-4, 1e-5, "H15 reads P's row 2 (contiguous), the plain version its column 2")
    state = state._replace(p=0.5 * (state.p + state.p.T))
    fargs = (state, *sub, *ftail)
    fgargs = (*fargs, *gtail)
    got, ref = factor_gate(*fgargs), _factor_gate_reference(*fgargs)
    w64 = _frame_factors_reference(*as_double(fargs))[2]
    near = gate_margins(state._replace(x=ref.x), buf, noise, cfg, ref.vtf, ref.bmat, ref.min_nis)
    h15_checks(label, fgargs, frame_factors_fused(*fargs), buf, cfg, near)
    check(f"H15 {label} vtf", got.vtf, ref.vtf, 1e-4, 1e-5, "the card tests' strip tolerance")
    check(f"H15 {label} B", got.bmat, ref.bmat, 1e-5, 1e-6, "constants and a copy of P[2, 2]")
    for name, f in (("H15", got), ("plain", ref)):
        check(f"{name} {label} vtf vs float64 witness", f.vtf, w64, 1e-4, 1e-5,
              "the card tests' strip tolerance")
    out["h15"] = dict(kernel=dist(got.vtf, w64), plain=dist(ref.vtf, w64))
    uargs = (state.p, got.x, got.slots, state.capacity, buf.z[:, 0], buf.z[:, 1],
             got.known_mask, noise.re, got.bmat, got.vtf)
    require(fk.obs_route(d, nz, got.bmat.shape[0], device) == "resident",
            f"H10 route at {label}", "resident (H10)")
    split = fk.frame_update_obs(*uargs, schedule="split")
    plain = fk.frame_update_obs(*uargs, plain=True)
    wit = gated_witness(*uargs)
    e_plain = dist(plain.x, wit.x)
    h10_checks(label, uargs, split, plain, 2e-3 + 2.0 * e_plain)
    got = fk.frame_update_obs(*uargs)
    out["h10"] = dict(x_kernel=dist(got.x, wit.x), x_plain=e_plain,
                      p_kernel=dist(got.p, wit.p), p_plain=dist(plain.p, wit.p))
    log("  float64 witnesses at {}: |vtf - vtf64| plain {:.3e}, H15 {:.3e}; |x - x64| plain "
        "{x_plain:.3e}, H10 {x_kernel:.3e}; |P - P64| plain {p_plain:.3e}, H10 "
        "{p_kernel:.3e}".format(label, out["h15"]["plain"], out["h15"]["kernel"],
                                **out["h10"]))
    return out


def sim_path(device) -> tuple[dict, dict]:
    """Phase 4e: the on-device simulation loop (runner.loop.run_ekf_slam):
    (a) the valet course, known association with augmentation, on the
    reference's own seed-42 draws, against its committed run; (b) the same
    gated; H9, H15 and H10 at a frame of that course against their plain
    versions (valet_kernel_checks); (c) BASELINE config 2 through
    run_ekf_slam in turns with the precomputed driver, and once on a
    torch.Generator's draws; (d) every route against its plain versions;
    the sync debug mode over frames of (a) and (c).  Returns the results
    and the launch counts summed over the timed kernel runs."""
    import torch

    from conan_slam_tpu_torch.config import SlamConfig
    from conan_slam_tpu_torch.runner.loop import precompute_rollout, run_ekf_slam_precomputed
    from conan_slam_tpu_torch.runner.metrics import ate_rmse
    from conan_slam_tpu_torch.sim.world import config2_world, default_world

    t_phase = time.perf_counter()
    ref, ctrl, obs = valet_reference(device)
    world = default_world(device)
    n_frames = ctrl.shape[0]
    total: dict[str, int] = {}

    def add(counts):
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n

    log(f"sim path (run_ekf_slam): the valet course at K 32 (D 67, NZ 30), {n_frames * 6} steps "
        f"= {n_frames} frames on the reference's seed-42 draws; reference ATE {ref['ate']:.5f} m, "
        f"done at step {VALET_DONE_AT}, {VALET_MAPPED} mapped")
    res: dict = {}
    for name, known in (("known", True), ("gated", False)):
        r = drive_sim(world, SlamConfig(switch_association_known=known), SIM_STEPS, ctrl, obs)
        add(r["counts"])
        outs = r["outs"]
        n = outs.x_est.shape[0]
        valid = ~ref[f"done_{name}"][:n]
        dx_est = float((outs.x_est.cpu() - ref[f"x_est_{name}"][:n])[valid].abs().max())
        dx_true = (outs.x_true.cpu() - ref["x_true"][:n]).abs().amax(dim=1)
        over = (dx_true > 1e-3).nonzero()
        first = int(over[0, 0]) if over.numel() else None
        nf = n // 6
        want = ({"frame_step": 2 * nf} if known else {"factor_gate": nf, "obs_step": 2 * nf})
        log(f"  valet, {name} association: {r['seconds']:.3f} s = {r['steps_per_s']:,.1f} steps/s, "
            f"ATE {r['ate']:.5f} m (reference {ref['ate']:.5f} m), done at step {r['done_at']}, "
            f"mapped {r['mapped']}, max |x_est - reference| over ~done {dx_est:.3e} m, "
            f"max |x_true - reference| {float(dx_true.max()):.3e} m, first step with "
            f"|x_true - reference| > 1e-3 m: {first}, launches {r['counts']}")
        require(r["finite"] and r["done_at"] == VALET_DONE_AT and r["mapped"] == VALET_MAPPED,
                f"valet course ({name})", f"finite, done at step {r['done_at']} "
                f"(reference {VALET_DONE_AT}), mapped {r['mapped']} (reference {VALET_MAPPED})")
        require(abs(r["ate"] - ref["ate"]) <= VALET_ATE_BOUND, f"valet ATE ({name})",
                f"|{r['ate']:.5f} - {ref['ate']:.5f}| = {abs(r['ate'] - ref['ate']):.2e} m "
                f"<= {VALET_ATE_BOUND} m")
        require(r["counts"] == {**dict.fromkeys(r["counts"], 0), **want},
                f"valet launches ({name})", f"{want}, no other kernel")
        res[name] = dict(steps_per_s=r["steps_per_s"], ate=r["ate"], done_at=r["done_at"],
                         mapped=r["mapped"], dx_est=dx_est, dx_true=float(dx_true.max()),
                         first_dx_true_over_1mm=first)
    res["reference_ate"] = ref["ate"]
    sync_free("valet, known", world, SlamConfig(), ctrl, obs)
    res["valet_frame"] = valet_kernel_checks(device, world, ctrl, obs)

    # (c) Config 2 through run_ekf_slam (on the reference's PRNGKey(0) draws)
    # in turns with the precomputed driver (on phase 4b's generator draws).
    c2, c2cfg = config2_world(device), gated_cfg(500)
    c2ctrl, c2obs, c2ate, c2mapped = config2_reference(device)
    t0 = time.perf_counter()
    roll = precompute_rollout(c2, c2cfg, SIM_STEPS)
    rollout_s = time.perf_counter() - t0
    steps = roll[0][0].shape[0]

    def precomputed():
        run_ekf_slam_precomputed(c2, c2cfg, torch.Generator(device=device).manual_seed(0), 60,
                                 None, tuple(tuple(a[:k] for a in part) for part, k in
                                             zip(roll, (60, 10))))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, outs = run_ekf_slam_precomputed(
            c2, c2cfg, torch.Generator(device=device).manual_seed(0), steps, None, roll)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        return dict(steps_per_s=steps / secs, ate=float(ate_rmse(outs.x_true, outs.x_est,
                                                                 ~outs.done)),
                    mapped=int(state.n_active), finite=bool(torch.isfinite(state.p).all()))

    # The second sim turn runs on the port's own draws, from a torch.Generator
    # seeded 0 as run_ekf_slam draws them: reported, not held to gated_full
    # (one realization's gate).
    gen = torch.Generator(device=device).manual_seed(0)
    n_frames_c2 = c2ctrl.shape[0]
    gen_draws = (torch.randn((n_frames_c2, 6, 2), generator=gen, device=device),
                 torch.randn((n_frames_c2, 500, 2), generator=gen, device=device))
    turns = []
    for kind in ("precomputed", "sim", "sim, torch.Generator(0) draws", "precomputed"):
        if kind.startswith("sim"):
            r = drive_sim(c2, c2cfg, SIM_STEPS, *((c2ctrl, c2obs) if kind == "sim" else gen_draws))
            add(r["counts"])
            nf = r["outs"].x_est.shape[0] // 6
            want = {"factor_gate": nf, "obs_step": 2 * nf}
            require(r["counts"] == {**dict.fromkeys(r["counts"], 0), **want},
                    f"config 2 launches ({kind})", f"{want}, no other kernel")
        else:
            r = precomputed()
        log(f"  config 2 ({kind}): {r['steps_per_s']:,.1f} steps/s, ATE {r['ate']:.4f} m, "
            f"mapped {r['mapped']}" + (f" (the reference's run_ekf_slam on these draws: ATE "
                                       f"{c2ate:.4f} m, mapped {c2mapped})"
                                       if kind == "sim" else ""))
        if kind.startswith("sim, "):
            require(r["finite"], f"config 2 ({kind})", "finite; reported, not held to gated_full")
            res["config2_generator"] = dict(ate=r["ate"], mapped=r["mapped"],
                                            steps_per_s=r["steps_per_s"])
        else:
            require(r["finite"] and r["ate"] < 0.5 and 270 <= r["mapped"] <= 340,
                    f"config 2 gated_full ({kind})",
                    f"finite, ATE {r['ate']:.4f} < 0.5 m, 270 <= mapped {r['mapped']} <= 340")
        turns.append(r["steps_per_s"])
        if kind == "sim":
            res["config2"] = dict(ate=r["ate"], mapped=r["mapped"], reference_ate=c2ate,
                                  reference_mapped=c2mapped)
    log(f"  config 2 steps/s in turns: precomputed {turns[0]:,.1f}, sim {turns[1]:,.1f}, "
        f"sim (generator draws) {turns[2]:,.1f}, precomputed {turns[3]:,.1f} (the host rollout "
        f"the precomputed runs take as given: {rollout_s:.3f} s)")
    res["config2"].update(turns=turns, rollout_s=rollout_s)
    sync_free("config 2", c2, c2cfg, c2ctrl, c2obs)

    # (d) Every route at the valet shape, true noise in the filter, against
    # the same run of its plain versions.  A known non-fused route launches
    # no kernel (its association is the table), so its run is its own plain
    # version.
    f = SIM_ROUTE_STEPS // 6
    routes = {}
    for known in (True, False):
        for label, kw in SIM_ROUTES:
            cfg = SlamConfig(switch_inflate_noise=False, switch_association_known=known, **kw)
            if not kw:
                want = ({"frame_step": 2 * f} if known else {"factor_gate": f, "obs_step": 2 * f})
            else:
                want = {} if known else {"gating_scores": f}
            k = drive_sim(world, cfg, SIM_ROUTE_STEPS, ctrl, obs)
            p = drive_sim(world, cfg, SIM_ROUTE_STEPS, ctrl, obs, plain=True) if want else k
            add(k["counts"])
            name = f"{'known' if known else 'gated'}, {label}"
            require(k["counts"] == {**dict.fromkeys(k["counts"], 0), **want}
                    and not any(p["counts"].values()), f"route launches ({name})",
                    f"kernels: {want or 'none'}; plain: none")
            dx = float((k["outs"].x_est - p["outs"].x_est).abs().max())
            same_map = bool(torch.equal(k["outs"].n_active, p["outs"].n_active))
            nis = [float(o["outs"].consistency[o["outs"].consistency != 0].mean()) for o in (k, p)]
            require(k["finite"] and same_map and dx <= ROUTE_DX_BOUND, f"route vs plain ({name})",
                    f"max |dx_est| {dx:.3e} <= {ROUTE_DX_BOUND} m, map sizes equal: {same_map}")
            require(all(1.2 < v < 3.0 for v in nis), f"route NIS band ({name})",
                    f"mean NIS kernels {nis[0]:.3f}, plain {nis[1]:.3f} in (1.2, 3.0)")
            log(f"  {name}: {k['steps_per_s']:,.1f} steps/s (plain {p['steps_per_s']:,.1f}), "
                f"ATE {k['ate']:.4f} m, mapped {k['mapped']}, max |x_est - plain| {dx:.3e} m")
            routes[name] = dict(steps_per_s=k["steps_per_s"], plain_steps_per_s=p["steps_per_s"],
                                dx_plain=dx, nis=nis[0], ate=k["ate"])
    res["routes"] = routes
    for kname in ("frame_step", "factor_gate", "obs_step", "gating_scores"):
        require(total.get(kname, 0) > 1, f"sim path launches {kname}",
                f"{total.get(kname, 0)} launches")
    res["seconds"] = time.perf_counter() - t_phase
    log(f"sim path: {res['seconds']:.1f} s")
    return res, total


def moved(a, device):
    """``a`` (a tensor or a NamedTuple of them) on ``device``."""
    import torch

    if isinstance(a, tuple):
        return type(a)(*(moved(t, device) for t in a))
    return a.to(device) if torch.is_tensor(a) else a


def pf_file_draws(data, n: int, device):
    """``draws(i)`` for run_pf_slam from the committed N = ``n`` run's draws,
    on ``device``."""
    import torch

    from conan_slam_tpu_torch.filters.pf import ObservationDraws
    from conan_slam_tpu_torch.runner.loop import PFDraws

    t = {k: torch.as_tensor(data[k]).to(device) for k in ("ctrl", "obs")}
    t.update({k: torch.as_tensor(data[f"{k}_{n}"]).to(device) for k in ("prop", "res_u", "samp")})

    def draws(i: int) -> PFDraws:
        return PFDraws(ctrl=t["ctrl"][i], obs=t["obs"][i], step=ObservationDraws(
            prop=t["prop"][i], res_u=t["res_u"][i], samp=t["samp"][i], rough=None))

    return draws


def pf_frame_checks(device, label: str, cfg, draws, n_frames: int) -> dict:
    """Each of ``n_frames`` frames of run_pf_slam's course on the card against
    the plain version on the CPU from the same carry (the card's own) with
    the same draws, at tests/test_torch_run_pf.py's bounds: x_true 1e-4 m,
    x_est 2e-3 m, Neff after the frame rtol 5e-2, the map size and the
    course's end equal.  Where the two resample on other ancestors (or one
    does not), the flip is reported with its margin, which must lie within
    the two weights' difference, and the CPU frame is held again on the
    card's ancestors.  Where x_est or Neff misses its bound, the frame's
    float64 witness (the plain version in float64 on the card's ancestors)
    decides, by the H10 checks' rule: the card no further from it than twice the
    plain version, and never beyond PF_WITNESS_CEILING times the bound."""
    import torch

    from conan_slam_tpu_torch.filters import pf
    from conan_slam_tpu_torch.filters.pf.recording import recording, resampling_flip
    from conan_slam_tpu_torch.runner import loop
    from conan_slam_tpu_torch.sim.steering import init_steer_state
    from conan_slam_tpu_torch.sim.world import default_world

    cpu = torch.device("cpu")
    worlds = {d: default_world(device=d) for d in (device, cpu)}
    noises = {d: loop.make_noise(cfg, "pf", d) for d in (device, cpu)}
    carry = loop.PFSimCarry(
        steer=init_steer_state(cfg.number_loops, device),
        x_true=torch.zeros((3,), dtype=torch.float32, device=device),
        ens=pf.init_ensemble(cfg.num_particles, cfg.max_landmarks, worlds[device].num_landmarks,
                             device=device),
        step_in_frame=torch.zeros((), dtype=torch.int64, device=device))
    thr = cfg.num_effective
    worst, flips, fires, witnessed = dict(x_true=0.0, x_est=0.0, neff=0.0), [], 0, []
    on_cpu = dict(cfg=cfg, world=worlds[cpu], noise=noises[cpu])
    on_cpu64 = dict(cfg=cfg, world=as_double(worlds[cpu]), noise=as_double(noises[cpu]))

    def distances(a, b):
        return dict(x_est=float((a.x_est.double() - b.x_est.double()).abs().max()),
                    neff=float((a.consistency[-1].double() - b.consistency[-1].double()).abs()
                               / b.consistency[-1].double().abs()))

    for f in range(n_frames):
        d = draws(f)
        seen, seen_cpu = {}, {}
        host = moved(carry, cpu)
        carry, out = loop.pf_frame_step(carry, d, cfg=cfg, world=worlds[device],
                                        noise=noises[device], resample_fn=recording(seen))
        _, ref = loop.pf_frame_step(host, moved(d, cpu), resample_fn=recording(seen_cpu),
                                    **on_cpu)
        fire = seen["gate"] and seen["neff"] < thr
        fires += fire
        flip = resampling_flip(seen, seen_cpu, thr)
        force = (seen["idx"], fire)
        if flip:
            flips.append((f, flip))
            _, ref = loop.pf_frame_step(host, moved(d, cpu), resample_fn=recording({}, force),
                                        **on_cpu)
        out = moved(out, cpu)
        dd = dict(x_true=float((out.x_true - ref.x_true).abs().max()), **distances(out, ref))
        worst = {k: max(v, dd[k]) for k, v in worst.items()}
        same = bool(torch.equal(out.n_active, ref.n_active) and torch.equal(out.done, ref.done))
        bounds = dict(x_est=PF_X_EST_ATOL, neff=PF_NEFF_RTOL)
        missed = [k for k, bound in bounds.items() if dd[k] > bound]
        ok = same and dd["x_true"] <= PF_X_TRUE_ATOL
        if missed:
            _, wit = loop.pf_frame_step(as_double(host), as_double(moved(d, cpu)),
                                        resample_fn=recording({}, force), **on_cpu64)
            card, plain = distances(out, wit), distances(ref, wit)
            witnessed.append((f, {k: (card[k], plain[k]) for k in missed}))
            ok = ok and all(card[k] <= 2.0 * plain[k]
                            and dd[k] <= PF_WITNESS_CEILING * bounds[k] for k in missed)
        if not ok:
            require(False, f"PF frame vs plain ({label}, frame {f})",
                    f"{dd}, map size and course end equal: {same}"
                    + (f"; against the float64 witness (card, plain): {witnessed[-1][1]}"
                       if missed else ""))
            break
    slack = sorted((dd - m, f, w, m, dd) for f, fl in flips for w, m, dd in fl)
    log(f"  {label}: {n_frames} frames on the card against the plain version on the CPU from "
        f"the same carry: worst |x_true| {worst['x_true']:.3e} m, |x_est| {worst['x_est']:.3e} m "
        f"(<= {PF_X_EST_ATOL}), Neff rel {worst['neff']:.3e} (<= {PF_NEFF_RTOL}; past either, "
        f"the witness decides, up to {PF_WITNESS_CEILING:g}x); {fires} "
        f"resamples, {len(flips)} with a flip ({len(slack)} strata or decisions); the closest: "
        + ", ".join(f"frame {f} {w} missed by {m:.2e} (weights differ by {dd:.2e})"
                    for _, f, w, m, dd in slack[:3])
        + "".join(f"; frame {f} past the bound, against the float64 witness: "
                  + ", ".join(f"{k} card {c:.3e}, plain {p:.3e}" for k, (c, p) in w.items())
                  for f, w in witnessed))
    require(all(sl >= 0 for sl, *_ in slack), f"PF flips explained ({label})",
            "each flip's margin within the two weights' difference")
    return dict(worst=worst, flips=len(flips), resamples=fires, witnessed=witnessed)


def pf_run(world, cfg, n_steps: int, generator=None, draws=None) -> dict:
    """One timed run_pf_slam run with its launch counts, accuracy and peak
    allocated bytes (above what was allocated before it)."""
    import torch

    from conan_slam_tpu_torch.ops import cuda
    from conan_slam_tpu_torch.runner.loop import run_pf_slam
    from conan_slam_tpu_torch.runner.metrics import ate_rmse

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    cuda.reset_launch_counts()
    t0 = time.perf_counter()
    carry, outs = run_pf_slam(world, cfg, generator, n_steps, draws=draws)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launches()
    done = outs.done.cpu()
    neff = outs.consistency[outs.consistency != 0]
    n = cfg.num_particles
    return dict(steps_per_s=n_steps / secs, particle_steps_per_s=n * n_steps / secs,
                seconds=secs, counts=counts, outs=outs, carry=carry,
                peak_bytes=torch.cuda.max_memory_allocated() - held,
                ate=float(ate_rmse(outs.x_true, outs.x_est, ~outs.done)),
                mapped=int(carry.ens.n_active),
                done_at=int(done.to(torch.int8).argmax()) if bool(done.any()) else -1,
                finite=bool(torch.isfinite(outs.x_est).all()
                            and torch.isfinite(carry.ens.log_w).all()
                            and torch.isfinite(carry.ens.xf).all()),
                neff_ok=bool(((neff > 0) & (neff <= n * (1 + 1e-6))).all()))


def pf_path(device) -> tuple[dict, dict]:
    """Phase 4f: FastSLAM 2.0 through runner.loop.run_pf_slam on the card.
    (a) the committed JAX runs (pf_key1.npz, N = 16 and 100, 1,200 steps)
    on their own draws, and each of their frames against the plain version
    on the CPU from the card's carry; (b) tests/test_pf.py's noise-free
    gate, and the whole valet course at N = 100 on a torch.Generator's
    draws, held to its end at step 19,555 with 25 mapped; (c) bench_pf.py's
    sizes, N = 100 to 100,000, in turns, with a torch.profiler trace at
    N = 10,000; (d) frames under the sync debug mode; (e) no hand-written
    kernel launched.  Returns the results and the launch counts summed over
    the runs."""
    import torch

    from conan_slam_tpu_torch.config import SlamConfig
    from conan_slam_tpu_torch.filters import pf as pf_mod
    from conan_slam_tpu_torch.runner import loop
    from conan_slam_tpu_torch.sim.world import default_world

    t_phase = time.perf_counter()
    world = default_world(device)
    data = np.load(PF_DATA)
    total: dict[str, int] = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    res: dict = {"parity": {}}
    # (a) The reference's runs on their own draws.
    x_true = torch.as_tensor(data["x_true"][:PF_STEPS])
    for n in PF_PARITY_N:
        cfg = SlamConfig(num_particles=n)
        draws = pf_file_draws(data, n, device)
        r = pf_run(world, cfg, PF_STEPS, draws=draws)
        add(r["counts"])
        outs = r["outs"]
        x_ref = data[f"x_est_{n}"][:PF_STEPS]
        dx = (outs.x_est.cpu() - torch.as_tensor(x_ref)).abs().amax(1)
        dt = float((outs.x_true.cpu() - x_true).abs().max())
        past = torch.nonzero(dx > 1e-3)
        first = int(past[0, 0]) if past.numel() else None
        same_map = bool(torch.equal(outs.n_active.cpu(),
                                    torch.as_tensor(data[f"n_active_{n}"][:PF_STEPS]).long()))
        ref_ate = float(np.sqrt((((x_ref - data["x_true"][:PF_STEPS])[:, :2]) ** 2)
                                .sum(1).mean()))
        log(f"PF parity, N = {n}: {r['steps_per_s']:,.1f} steps/s, ATE {r['ate']:.4f} m "
            f"(reference {ref_ate:.4f} m), max |x_true - reference| {dt:.3e} m, map sizes equal "
            f"at every step: {same_map}, max |x_est - reference| {float(dx.max()):.3e} m, first "
            f"step past 1e-3 m: {first}")
        require(dt <= PF_RUN_X_TRUE_ATOL and same_map and r["finite"] and r["neff_ok"],
                f"PF parity (N = {n})", f"|x_true| {dt:.2e} <= {PF_RUN_X_TRUE_ATOL} m, map "
                f"sizes equal {same_map}, finite, Neff in (0, N]")
        frames = pf_frame_checks(device, f"N = {n}", cfg, draws, PF_CHECK_FRAMES)
        res["parity"][n] = dict(dx_est_max=float(dx.max()), first_dx_est_over_1mm=first,
                                dx_true=dt, ate=r["ate"], reference_ate=ref_ate, frames=frames)

    # (b) The reference's noise-free gate, and the whole course.
    cfg = SlamConfig(switch_control_noise=False, switch_sensor_noise=False,
                     switch_inflate_noise=False, num_particles=PF_GATE_N)
    r = pf_run(world, cfg, PF_GATE_STEPS, torch.Generator(device=device).manual_seed(0))
    add(r["counts"])
    log(f"PF noise-free gate, N = {PF_GATE_N}, {PF_GATE_STEPS} steps: ATE {r['ate']:.4f} m, "
        f"mapped {r['mapped']}")
    require(r["finite"] and r["ate"] < 1.0 and r["mapped"] > 0, "PF noise-free gate",
            f"ATE {r['ate']:.4f} < 1.0 m, mapped {r['mapped']} > 0")
    res["noise_free"] = dict(ate=r["ate"], mapped=r["mapped"])
    cfg = SlamConfig(num_particles=PF_COURSE_N)
    r = pf_run(world, cfg, SIM_STEPS, torch.Generator(device=device).manual_seed(0))
    add(r["counts"])
    log(f"PF valet course, N = {PF_COURSE_N}, {SIM_STEPS} steps on torch.Generator(0)'s draws: "
        f"{r['seconds']:.2f} s = {r['steps_per_s']:,.1f} steps/s, done at step {r['done_at']}, "
        f"mapped {r['mapped']}, ATE {r['ate']:.4f} m (the reference's over 36 seeds at N = 100: "
        f"median {PF_REFERENCE_ATE[0]} m, p90 {PF_REFERENCE_ATE[1]} m), launches "
        f"{({k: v for k, v in r['counts'].items() if v}) or 'none'}")
    require(r["finite"] and r["neff_ok"] and r["done_at"] == VALET_DONE_AT
            and r["mapped"] == VALET_MAPPED, "PF valet course",
            f"finite, Neff in (0, N], done at step {r['done_at']} ({VALET_DONE_AT}), mapped "
            f"{r['mapped']} ({VALET_MAPPED})")
    res["course"] = dict(ate=r["ate"], done_at=r["done_at"], mapped=r["mapped"],
                         steps_per_s=r["steps_per_s"], launches=r["counts"])

    # (c) bench_pf.py's sizes after an untimed warm-up run of each; the
    # smallest and the largest in turns (N = 100, 100,000, ..., 100,000, 100).
    for n in PF_SIZES:
        pf_run(world, SlamConfig(num_particles=n), 60, torch.Generator(device=device).manual_seed(0))
    sizes: dict = {n: [] for n in PF_SIZES}
    order = (PF_SIZES[0], PF_SIZES[-1]) + PF_SIZES[1:-1] + (PF_SIZES[-1], PF_SIZES[0])
    for i, n in enumerate(order):
        r = pf_run(world, SlamConfig(num_particles=n), PF_STEPS,
                   torch.Generator(device=device).manual_seed(1 + i))
        add(r["counts"])
        require(r["finite"] and r["neff_ok"], f"PF bench size N = {n}", "finite, Neff in (0, N]")
        sizes[n].append(r)
    res["sizes"] = {}
    for n, rs in sizes.items():
        log(f"PF N = {n:,}: steps/s " + ", ".join(f"{r['steps_per_s']:,.1f}" for r in rs)
            + "; particle-steps/s " + ", ".join(f"{r['particle_steps_per_s']:.4e}" for r in rs)
            + "; ATE " + ", ".join(f"{r['ate']:.4f}" for r in rs)
            + f" m; peak allocated by the run {max(r['peak_bytes'] for r in rs):,} bytes")
        res["sizes"][n] = dict(steps_per_s=[r["steps_per_s"] for r in rs],
                               particle_steps_per_s=[r["particle_steps_per_s"] for r in rs],
                               ate=[r["ate"] for r in rs],
                               peak_bytes=max(r["peak_bytes"] for r in rs))
    cfg = SlamConfig(num_particles=PF_PROFILE_N)
    gen = torch.Generator(device=device).manual_seed(SEED)
    ranges = tuple((pf_mod, a) for a in ("predict", "observe_heading", "sample_proposal",
                                         "feature_update", "resample", "add_new_features"))
    ranges += ((loop, "_advance_truth"), (loop, "_sense"))
    res["profile"] = profile_frames(
        device, PF_PROFILE_FRAMES, f"FastSLAM 2.0, N = {PF_PROFILE_N:,}", world, cfg, None,
        ranges=ranges,
        drive=lambda: loop.run_pf_slam(world, cfg, gen, PF_PROFILE_FRAMES * cfg.observe_interval))

    # (d) No host sync in the loop.
    for label, kw in (("default", {}), ("fast_frame=False", dict(fast_frame=False))):
        cfg = SlamConfig(num_particles=PF_COURSE_N, **kw)
        gen = torch.Generator(device=device).manual_seed(0)
        torch.cuda.synchronize()
        err = ""
        torch.cuda.set_sync_debug_mode("error")
        try:
            loop.run_pf_slam(world, cfg, gen, PF_SYNC_FRAMES * cfg.observe_interval)
        except RuntimeError as e:
            err = str(e).splitlines()[0]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        require(not err, f"no host sync (PF, {label})",
                f"{PF_SYNC_FRAMES} frames of run_pf_slam under set_sync_debug_mode('error')"
                + (f": {err}" if err else ""))

    # (e) The PF path runs no hand-written kernel.
    require(not any(total.values()), "PF path launches", f"{total}: none")
    res["seconds"] = time.perf_counter() - t_phase
    log(f"PF path (phase 4f): {res['seconds']:.1f} s")
    return res, total


@contextlib.contextmanager
def gated_schedule(schedule: str):
    """The frame loop's gated frames on ``schedule``: "auto" H15 then H10,
    "split" H15 then the split.  frame_update_obs's own test hook, bound
    where fused_frame_update looks frame_update_obs up."""
    from conan_slam_tpu_torch.ops import frame_kernel as fk

    update = importlib.import_module("conan_slam_tpu_torch.filters.ekf.update")

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
        label = "plain" if plain else {"auto": "H15 + H10", "split": "split schedule"}[schedule]
        log(f"  {label}: {steps} steps in {secs:.3f} s = "
            f"{steps / secs:,.1f} steps/s, ATE={res['ate']:.4f} m, mapped={res['mapped']}, "
            f"finite={res['finite']}, launches={counts}")
        return res

    # H10 in turns with the split schedule.
    order = ("auto", "split", "split", "auto")
    runs = [drive(False, n_steps, schedule) for schedule in order]
    for schedule, res in zip(order, runs):
        kernels, names = {"auto": (GATED_KERNELS, "H15, H10's two kernels"),
                          "split": (GATED_SPLIT_KERNELS, "H15, H7, H8, H1, H4")}[schedule]
        want = {**dict.fromkeys(res["counts"], 0), **per_frame(kernels, n_frames)}
        require(res["counts"] == want, f"gated path launches ({schedule})",
                f"{names} once per frame ({n_frames}), no other kernel")
        require(res["finite"] and res["ate"] < 0.5 and 270 <= res["mapped"] <= 340,
                f"gated_full gate ({schedule})",
                f"finite, ATE {res['ate']:.4f} < 0.5 m, 270 <= mapped {res['mapped']} <= 340")
    k, sp = runs[0], runs[1]
    dx_split = float((k["outs"].x_est - sp["outs"].x_est).abs().max())
    dmap_split = (k["outs"].n_active - sp["outs"].n_active).abs()
    log(f"  H10 vs split over {n_steps} steps: max |dx_est| = {dx_split:.3e} m, mapped "
        f"{k['mapped']} vs {sp['mapped']}, steps with a different map size: "
        f"{int((dmap_split > 0).sum())} (max |d mapped| {int(dmap_split.max())})")
    label = {"auto": "H15 + H10", "split": "H15 + split"}
    log("  steps/s in turns: " + ", ".join(
        f"{label[o]} {r['steps_per_s']:,.1f}" for o, r in zip(order, runs)))
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
        want = {**dict.fromkeys(counts, 0), **per_frame(kernels, bf)}
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


@contextlib.contextmanager
def traced_ranges(ranges):
    """Each ``(module, attribute)`` of ``ranges`` wrapped in a
    torch.profiler record_function range named by the attribute."""
    from torch.profiler import record_function

    saved = [(mod, attr, getattr(mod, attr)) for mod, attr in ranges]
    for mod, attr, fn in saved:
        def wrapped(*a, _fn=fn, _name=attr, **kw):
            with record_function(_name):
                return _fn(*a, **kw)
        setattr(mod, attr, wrapped)
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def range_totals(event) -> tuple[float, int, int]:
    """The device us, kernels and outermost PyTorch ops under a profiler
    event (the kernels its PyTorch ops launch; the ctypes launches of the
    port's kernels are not attributed to a range)."""
    us, kernels, ops = sum(k.duration for k in event.kernels), len(event.kernels), 0
    for child in event.cpu_children:
        u, k, o = range_totals(child)
        us, kernels = us + u, kernels + k
        ops += 1 if child.name.startswith("aten::") else o
    return us, kernels, ops


def profile_frames(device, n_frames: int, label: str, world, cfg, state0,
                   schedule: str = "auto", ranges=(), sim: bool = False, drive=None) -> dict:
    """A torch.profiler trace of ``n_frames`` frames of a main path (the
    precomputed driver; ``sim=True``: the on-device loop, run_ekf_slam;
    ``drive``: a call that runs the frames itself): device time per kernel
    per frame, the PyTorch ops dispatched per frame and the device's busy
    share; with ``ranges`` (traced_ranges), each range's device us, kernels
    and ops a frame."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from conan_slam_tpu_torch.runner.loop import (
        precompute_rollout,
        run_ekf_slam,
        run_ekf_slam_precomputed,
    )

    n_steps = n_frames * cfg.observe_interval
    gen = torch.Generator(device=device).manual_seed(SEED)
    if drive is None and sim:
        def drive():
            run_ekf_slam(world, cfg, gen, n_steps, state0)
    elif drive is None:
        roll = precompute_rollout(world, cfg, n_steps)

        def drive():
            run_ekf_slam_precomputed(world, cfg, gen, n_steps, state0, roll)
    with known_schedule(schedule), gated_schedule(schedule), traced_ranges(ranges):
        drive()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            drive()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    names = {attr for _, attr in ranges}
    rows = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA or e.key in names:
            continue
        us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
        rows.append((us, e.count, e.key))
    # Busy: the union of the device's kernel and copy intervals (H9's P pass
    # is resident, waiting, before its frame kernel ends: their sum would
    # count the overlap twice).
    # A range's own device-side annotation is no device work.
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.device_type == DeviceType.CUDA and e.name not in names):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)

    def outermost(e) -> bool:
        q = e.cpu_parent
        while q is not None:
            if q.name.startswith("aten::"):
                return False
            q = q.cpu_parent
        return True

    # Host work: the PyTorch ops the frame loop dispatches (outermost only).
    ops: dict[str, int] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name.startswith("aten::") and outermost(e):
            ops[e.name] = ops.get(e.name, 0) + 1
    in_ranges = {}
    for name in sorted(names):
        tot = [range_totals(e) for e in prof.events()
               if e.device_type == DeviceType.CPU and e.name == name]
        in_ranges[name] = {"device_us": sum(t[0] for t in tot) / n_frames,
                           "kernels": sum(t[1] for t in tot) / n_frames,
                           "ops": sum(t[2] for t in tot) / n_frames}
    log(f"profile, {label}, {n_frames} frames: wall {wall_us / n_frames:.1f} us/frame under the "
        f"profiler, device busy {busy / n_frames:.1f} us/frame "
        f"({100.0 * busy / wall_us:.1f}% of wall); {sum(ops.values()) / n_frames:.1f} PyTorch "
        "ops dispatched per frame, most frequent: " + ", ".join(
            f"{k} {v / n_frames:.1f}" for k, v in sorted(ops.items(), key=lambda kv: -kv[1])[:8]))
    for name, r in in_ranges.items():
        log(f"  range {name}: {r['device_us']:.2f} device us/frame in {r['kernels']:.2f} PyTorch "
            f"kernels/frame, {r['ops']:.2f} ops/frame")
    rows.sort(reverse=True)
    ours = tuple(f"{name}_kernel" for name in ORDER) + sum(DEVICE_KERNELS.values(), ())
    for us, count, key in rows[:15] + [r for r in rows[15:] if r[2].startswith(ours)]:
        log(f"  {us / n_frames:9.2f} us/frame  {count / n_frames:5.2f} launches/frame  {key[:90]}")
    return dict(wall_us=wall_us / n_frames, busy_us=busy / n_frames,
                ops=sum(ops.values()) / n_frames, ranges=in_ranges)


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
    sim, simcounts = sim_path(device)
    pfres, pfcounts = pf_path(device)
    log(f"main paths: {time.perf_counter() - t0:.1f} s")

    from conan_slam_tpu_torch.config import SlamConfig

    world, state0 = bench_world(device)
    known_cfg = SlamConfig(max_landmarks=N_LANDMARKS, max_obs=64, enable_augment=False)
    profile_frames(device, PROFILE_FRAMES, "known association (H9)", world, known_cfg, state0)
    profile_frames(device, PROFILE_FRAMES, "known association, split schedule", world, known_cfg,
                   state0, schedule="split")
    from conan_slam_tpu_torch.runner import loop

    gated_ranges = ((loop, "factor_and_associate_gated"), (loop, "fused_frame_update"),
                    (loop, "augment"))
    gprof = {}
    for schedule, label in (("auto", "H15 + H10"), ("split", "H15 + split schedule")):
        gprof[schedule] = profile_frames(
            device, PROFILE_FRAMES, f"gated, config 2 ({label})", config2_world(device),
            gated_cfg(500), init_state(500, 500, device=device), schedule=schedule,
            ranges=gated_ranges)
    profile_frames(device, 2 * PROFILE_FRAMES, "known association, frame pairs", world,
                   known_cfg.replace(frame_pair=True), state0)
    for schedule, label in (("auto", "H10"), ("split", "split schedule")):
        profile_frames(device, BIG_PROFILE_FRAMES, f"gated, 10k landmarks ({label})",
                       big_world(device), gated_cfg(BIG_LANDMARKS), None, schedule=schedule)
    from conan_slam_tpu_torch.sim.world import default_world

    sprof = {
        "valet": profile_frames(device, PROFILE_FRAMES, "sim loop, valet, known (H9)",
                                default_world(device), SlamConfig(), None, sim=True),
        "config2": profile_frames(device, PROFILE_FRAMES, "sim loop, config 2 (H15 + H10)",
                                  config2_world(device), gated_cfg(500), None, sim=True),
    }

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
              "no_p_library_ms", "no_p_library_device_ms", "stack3", "alone_us", "regs_local",
              "kernels_device_ms", "alone_us_10k", "kernels_device_ms_10k", "cold_sweep_us",
              "h5_phases_us", "turns", "h5_phases_us_10k", "h6_device_ms_10k", "turns_10k",
              "plan_10k")
    table = {"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
         "launches": (counts[k.name] + scounts[k.name] + gcounts[k.name] + gscounts[k.name]
                      + pcounts[k.name] + pbcounts[k.name] + simcounts.get(k.name, 0)
                      + pfcounts.get(k.name, 0)),
         "launches_by_path": {"known": counts[k.name], "known_split": scounts[k.name],
                              "gated": gcounts[k.name], "gated_split": gscounts[k.name],
                              "pair": pcounts[k.name], "probes": pbcounts[k.name],
                              "probes_replayed": pbreplayed.get(k.name, 0),
                              "sim": simcounts.get(k.name, 0), "pf": pfcounts.get(k.name, 0)},
         **{key: allstats[k.name][key] for key in keys},
         **{key: allstats[k.name][key] for key in extras if key in allstats[k.name]},
         "ptxas": {n: r for n, r in ptxas.items()
                   if n.startswith(DEVICE_KERNELS.get(k.name, (f"{k.name}_kernel",)))}}
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
        "gated_ops_per_frame": gprof["auto"]["ops"],
        "gated_busy_us_per_frame": gprof["auto"]["busy_us"],
        "gated_split_ops_per_frame": gprof["split"]["ops"],
        "gated_split_busy_us_per_frame": gprof["split"]["busy_us"],
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
        "sim": {**sim, "ops_per_frame": {k: v["ops"] for k, v in sprof.items()},
                "busy_us_per_frame": {k: v["busy_us"] for k, v in sprof.items()},
                "wall_us_per_frame_profiled": {k: v["wall_us"] for k, v in sprof.items()}},
        "pf": {"parity": {n: {k: v for k, v in p.items() if k != "frames"}
                          for n, p in pfres["parity"].items()},
               "parity_frames": {n: p["frames"] for n, p in pfres["parity"].items()},
               "noise_free": pfres["noise_free"], "course": pfres["course"],
               "sizes": pfres["sizes"], "ops_per_frame": pfres["profile"]["ops"],
               "busy_us_per_frame": pfres["profile"]["busy_us"],
               "wall_us_per_frame_profiled": pfres["profile"]["wall_us"],
               "ranges": pfres["profile"]["ranges"], "seconds": pfres["seconds"]},
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
