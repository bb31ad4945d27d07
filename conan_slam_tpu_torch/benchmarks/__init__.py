"""Port-side benches: the counterparts of the reference's scripts in
benchmarks/ (probe_sweep, probe_rankpass, probe_mosaic, bench_framestep,
bench_pf, bench_longloop, probe_closure, dcn_smoke, audit_collectives,
bench_gated, bench_kernels, seed_sweep, seed_sweep_gated, study_pf), with
the same variant and mode names, environment knobs, defaults, gates and
output lines; ``native_baseline`` is bench.py's native denominator, and
``redesign_turns`` times a redesigned kernel (H8, H11, H12, H13) in turns
against other builds of it.  Where
a reference script took a ``PRNGKey``, its port takes a
``torch.Generator`` seeded with the same number.

benchmarks/smoke_compile.py is not ported as a second smoke: the root
chip_smoke.py holds each of its stages' gates in a phase.  ``kernel`` ->
3b (the gated frame's kernels against their plain versions); ``ate`` -> 4a
(ATE < 0.05 m, asym(P) < 1e-4); ``gated`` and ``gated_full`` -> 4b (the
whole 25,002-step config 2 run: ATE < 0.5 m, 270 <= mapped <= 340);
``longloop`` -> 4g; ``pf`` -> 4f; ``program`` is a TPU compile check with
no eager counterpart.

Each module has ``main(argv=None, device="cuda")`` and runs as

    python -m conan_slam_tpu_torch.benchmarks.<name> [variants or modes...]

on the card; ``main(..., device="cpu")`` runs the plain versions at the
sizes the knobs give (the timings are then the host's, no device number).
Each first prints the card's name and power limit, as nvidia-smi gives
them, and returns its results as a dict.  Chained steps run through
``utils.profiling.scan_graph`` (one CUDA graph a block of steps), and a
time is kept only when the graph's carry equals the eager loop's bit for
bit (``require_replay``).
"""

from __future__ import annotations

import subprocess
import time

import torch


def card_line(device: torch.device) -> str:
    """The card's name and power limit (nvidia-smi), or the CPU."""
    if device.type != "cuda":
        return "device: cpu (no card: plain versions, host clock)"
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        smi = (res.stdout + res.stderr).strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        smi = f"unavailable ({e})"
    return f"nvidia-smi: {smi} ({torch.cuda.get_device_name(device)})"


def call_us(fn, device: torch.device, iters: int, warmup: int = 2) -> float:
    """Mean microseconds a call of ``fn`` takes, back to back: CUDA events
    on the card (dispatch included where it is longer than the work), the
    host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e6 / iters
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(stop) * 1e3 / iters


def clock(device: torch.device, block: int) -> str:
    """What a chained time was read with: a CUDA graph of ``block`` steps
    between CUDA events on the card, the eager loop's host clock on the
    CPU."""
    if device.type == "cuda":
        return f"card: CUDA graph of {block} steps, CUDA events"
    return "cpu: eager, host clock"


def require_replay(name: str, res) -> None:
    """Raise unless a ``scan_graph`` result's carry after the graph's
    replays equals, bit for bit, its carry after the same steps run eagerly:
    the graph must have done the eager steps' work."""
    for i, (got, eager) in enumerate(zip(res.carry, res.eager_carry)):
        if not torch.equal(got, eager):
            err = float((got.double() - eager.double()).abs().max())
            raise AssertionError(f"{name}: the graph's carry[{i}] is off the eager loop's by "
                                 f"{err:.3e}")
