"""A redesigned kernel in turns against other builds of it, on one card:
H8 ``obs_panels``, H11 ``sweep_probe``, H12 ``stream_copy``, H13
``probe_dots`` and H14 ``probe_observe``.

    python -m conan_slam_tpu_torch.benchmarks.redesign_turns LABEL=FILE[:FLAG,...] ...

Each ``LABEL=FILE`` is a version of ``csrc/obs_panels.cu``,
``csrc/sweep_probe.cu``, ``csrc/stream_copy.cu`` or ``csrc/probe_mosaic.cu``
(which, its file name says): an earlier commit's (``git archive REV
conan_slam_tpu_torch/csrc``), or the package's own with ``-D`` flags after
the colon (``new16=conan_slam_tpu_torch/csrc/stream_copy.cu:-DSC_CHUNK=16384,
-DSC_STAGES=6``).  Each is compiled with ``nvcc`` beside the package's
headers into a library of its own under ``build/turns/`` and called through
the same C entries as the package's kernels, which run as the label
``package``.  Only the kernels of the files that some LABEL=FILE names are
run (all of them when none is given); ``probe_mosaic.cu`` holds H13 and
H14, and naming it runs both.

H8 runs at config 2 (D 1,024, NZ 64: MP 128, RP 136, NBP 24), at the
10k-landmark shape (D 20,224, NZ 64) and at MP 240 and 480 (D 1,024), on
inputs from numpy seed 8; H12 on P's (D, D) at D 2,304 (42.5 MB in and out,
partly held by the 50 MB L2) and 9,216 (340 MB, past it), beside
``Tensor.copy_`` (label ``copy_``).  Every build's outputs are first held
to the plain version (H8 within chip_smoke.py's bounds, H12 bit for bit,
and two calls of each bit for bit equal).  Then each shape's contenders
run in ``ROUNDS`` rounds, in order and then in reverse (a, b, c, c, b, a):
a turn is one torch.profiler trace of ``ITERS`` calls and reads the median
device time of a call (its kernels' and copies' median durations summed).
A contender's time is the median of its turns.  Beside an H8 build's
time stands its plan (its csl_obs_panels_plan: width, panels, grid,
cluster, block, rows a chunk, shared memory, registers, local bytes and
the clusters the card holds at once); a build with ``-DOP_STAMPS`` also
gives its phases over one launch (median µs since a block's start).

H11 runs each variant at MP 64 / NBLK 20 and MP 128 / NBLK 40 on the
sweep probe's S made exactly symmetric with a unit diagonal, and at NBLK 0
(its load and store alone): (time - time at NBLK 0) / NBLK is its time a
pivot.  Every build is first held to H1 (``sweep_si``) on that S: sym(out)
bit for bit for unroll2 and unroll4, wide4 within 4 MP float32 epsilons of
the swept block's largest entry; two calls bit for bit.  Beside each
build's time stands its plan (csl_sweep_probe_plan: Q, cluster, ring, rows
a warp, rows a CTA, block, shared memory, registers, local bytes); a build
with ``-DSP_STAMPS`` also gives the chain's phases over one launch at MP
128 / NBLK 40: the median per step of publish to publish, of a publish to
the next producer's wait ending (the handover), and of that to its own
publish (the forming), in ns of %globaltimer and, within an SM, cycles.

H13 runs at the dots probe's shape (D 512, MP 128, RP 136) and at D 4,096,
on the probe's inputs (numpy seed 0), beside three ``torch.matmul`` calls
(label ``matmul3``, TF32 off); every build is first held to the plain
version within 1e-5 of max|ref| and two calls bit for bit.

H14 runs at the observe probe's shape (MP 128, RP 136, its inputs) on
both paths, beside the empty kernel at the package's launch (label
``floor``: csl_probe_observe_floor, the card's floor for a launch of that
grid and block).  Every build is first held bit for bit to every other
build (so to the parent's, where one is named) on both paths, to the plain
version within chip_smoke.py's bounds, and two calls bit for bit.  Beside
each build's time stands its plan (csl_probe_observe_plan: rows a CTA,
grid, block, shared memory, registers, local bytes); a build with
``-DPO_STAMPS`` also gives its phases over one launch (median µs since a
CTA's start: staged, observed, synced, its Hc row written, every store
issued) and the observe's own time (staged to observed).

Prints one line a shape and a last JSON line; writes the JSON to
``chiprun_out/redesign_turns.json`` when that directory exists.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from conan_slam_tpu_torch.benchmarks import card_line, probe_sweep
from conan_slam_tpu_torch.benchmarks.probe_mosaic import dots_inputs, observe_inputs
from conan_slam_tpu_torch.ops import cuda
from conan_slam_tpu_torch.ops import frame_kernel as fk
from conan_slam_tpu_torch.ops import probes as pr
from conan_slam_tpu_torch.ops.spd_inverse import sweep_si

ROUNDS = 3              # each contender runs 2 x ROUNDS turns
ITERS = 20              # calls a turn
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = 67e12     # fp32 outside the tensor cores
# H8's shapes: (label, D, NZ, NBP).
H8_SHAPES = (("config 2", 1024, 64, 24), ("10k", 20224, 64, 24), ("MP 240", 1024, 120, 24),
             ("MP 480", 1024, 240, 24))
H12_DIMS = (2304, 9216)
# H11's shapes (MP, NBLK) and H13's (D, MP, RP).
H11_SHAPES = ((64, 20), (128, 40))
H13_SHAPES = ((512, 128, 136), (4096, 128, 136))
H14_SHAPES = ((128, 136),)
# Each kernel's source file (its stem), C entry and argument types.
ENTRY = {"obs_panels": ("obs_panels", "csl_obs_panels", [cuda.P] * 9 + [cuda.I] * 4 + [cuda.P]),
         "sweep_probe": ("sweep_probe", "csl_sweep_probe",
                         [cuda.P, cuda.P] + [cuda.I] * 3 + [cuda.P]),
         "stream_copy": ("stream_copy", "csl_stream_copy", [cuda.P, cuda.P, cuda.L, cuda.P]),
         "probe_dots": ("probe_mosaic", "csl_probe_dots", [cuda.P] * 7 + [cuda.I] * 3 + [cuda.P]),
         "probe_observe": ("probe_mosaic", "csl_probe_observe",
                           [cuda.P] * 6 + [cuda.I] * 3 + [cuda.P])}
FILES = tuple(dict.fromkeys(f for f, _, _ in ENTRY.values()))


def build_variants(specs: list[str]) -> list[tuple[str, str, ctypes.CDLL]]:
    """Compile each ``LABEL=FILE[:FLAG,...]`` into ``build/turns/lib<file>_<label>.so``,
    one ``nvcc`` each, all started together; returns (label, the file's
    stem, the loaded library) for each."""
    jobs = []
    for spec in specs:
        label, _, rest = spec.partition("=")
        path, _, flags = rest.partition(":")
        kernel = Path(path).stem
        if kernel not in FILES:
            raise ValueError(f"{label}: {path} is none of " + ", ".join(f"{k}.cu" for k in FILES))
        out = cuda.BUILD_DIR / "turns" / f"lib{kernel}_{label}.so"
        out.parent.mkdir(parents=True, exist_ok=True)
        cmd = [cuda._nvcc(), *cuda.NVCC_FLAGS, "-I", str(cuda.CSRC), "-shared", "-o", str(out),
               path, *[f for f in flags.split(",") if f]]
        jobs.append((label, kernel, out, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    built = []
    for label, kernel, out, cmd, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{' '.join(cmd)}\n{log}")
        built.append((label, kernel, ctypes.CDLL(str(out))))
    return built


def entry(lib: ctypes.CDLL, kernel: str):
    """The C entry of ``kernel`` in ``lib``, raising on a launch error."""
    _, symbol, argtypes = ENTRY[kernel]
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int

    def call(*args):
        err = fn(*args, cuda.P(torch.cuda.current_stream().cuda_stream))
        if err != 0:
            raise RuntimeError(f"{kernel} ({symbol}) failed to launch: error {err}")
    return call


def lib_plan(lib: ctypes.CDLL, d: int, mp: int, rp: int, nbp: int):
    """The plan a build of H8 reports (its csl_obs_panels_plan, as
    ops.frame_kernel.obs_panels_attributes reads it), or None for a build
    without that entry."""
    fn = getattr(lib, "csl_obs_panels_plan", None)
    if fn is None:
        return None
    fn.argtypes = [cuda.I] * 4 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * fk.OP_PLAN)()
    return list(out) if fn(d, mp, rp, nbp, out) == 0 else None


STAMPS = 10            # a diagnostic H8 build's stamps a block (-DOP_STAMPS)


def lib_stamps(lib: ctypes.CDLL, grid: int, launch):
    """A diagnostic H8 build's phases (-DOP_STAMPS: csl_obs_panels_stamps)
    over one launch, or None for a build without them: the kernel's span,
    the spread of its blocks' starts, and the median over blocks of each
    stamp since its block's start (µs): siv formed, siv shared, panel 0
    formed, done, panel 1 formed, done, the last panel done, the exit."""
    fn = getattr(lib, "csl_obs_panels_stamps", None)
    if fn is None:
        return None
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    n = min(grid, 4096) * STAMPS
    out = (ctypes.c_ulonglong * n)()
    ctypes.memset(out, 0, ctypes.sizeof(out))
    launch()
    torch.cuda.synchronize()
    if fn(out, n) != 0:
        return None
    t = np.frombuffer(out, dtype=np.uint64).reshape(-1, STAMPS).astype(np.int64)
    start = t[:, 0]
    phases = {}
    for k, name in enumerate(("siv formed", "siv shared", "panel 0 formed", "panel 0 done",
                              "panel 1 formed", "panel 1 done", "last panel", "exit"), 1):
        have = t[:, k] > 0
        if have.any():
            phases[name] = float(np.median(t[have, k] - start[have])) / 1e3
    return dict(span_us=float(t[:, 8].max() - start.min()) / 1e3,
                start_spread_us=float(start.max() - start.min()) / 1e3,
                sms=int(len(np.unique(t[:, 9]))), median_us=phases)


def device_us(fn, iters: int = ITERS) -> float:
    """One turn: the median device time of a call (µs) over a torch.profiler
    trace of ``iters`` calls, summed over the kernels and copies a call
    launches; a trace that holds no device event is taken again."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(10):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        durations: dict[str, list[float]] = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                durations.setdefault(e.name, []).append(e.time_range.elapsed_us())
        total = sum(statistics.median(d) for d in durations.values() if len(d) >= iters / 2)
        if total > 0:
            return total
    raise RuntimeError("ten profiler traces held no device event")


def turns(contenders: dict) -> dict:
    """Each contender's turns (µs) in rounds of forward-then-reverse order."""
    names = list(contenders)
    got: dict[str, list[float]] = {n: [] for n in names}
    for _ in range(ROUNDS):
        for n in names + names[::-1]:
            got[n].append(device_us(contenders[n]))
    return {n: dict(us=statistics.median(t), turns=t) for n, t in got.items()}


def h8_inputs(d: int, nz: int, nbp: int, dev) -> tuple:
    """rowc, hvb, S^-1 (SPD, O(1)), prows, vtf and x at these shapes, from
    numpy seed 8, with compact Hc rows as the observe makes them."""
    mp, rp = fk.frame_shapes(nz)
    rng = np.random.default_rng(8)
    rowc = np.zeros((mp, 8), np.float32)
    rowc[:, :5] = rng.normal(size=(mp, 5))
    rowc[:, 7] = rng.normal(size=mp)
    a = rng.normal(size=(mp, mp)) / np.sqrt(mp)
    si = (a @ a.T + np.eye(mp)).astype(np.float32)
    arrays = (rowc, rng.normal(size=(mp, nbp)), si, rng.normal(size=(rp, d)),
              rng.normal(size=(nbp, d)) * 1e-2, rng.normal(size=d) * 10.0)
    return tuple(torch.as_tensor(np.asarray(v, np.float32), device=dev) for v in arrays)


def h8_call(call, args):
    rowc, hvb, si, prows, vtf, x = args
    mp, nbp = hvb.shape
    rp, d = prows.shape
    pht = torch.empty((mp, d), device=x.device)
    xn, nis = torch.empty_like(x), torch.empty((1,), device=x.device)
    ptrs = [cuda.ptr(t) for t in (rowc, hvb, si, prows, vtf, x, pht, xn, nis)]
    return (lambda: call(*ptrs, mp, rp, nbp, d)), (pht, xn, nis)


def h8_check(label: str, name: str, launch, outs, args) -> None:
    """chip_smoke.py's bounds against the plain version; two calls bit for
    bit equal."""
    launch()
    first = [t.clone() for t in outs]
    launch()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, outs)):
        raise AssertionError(f"H8 {name} at {label}: two calls differ")
    ref = fk._obs_panels_reference(*args)
    for what, got, want, rtol, atol in (
            ("pht", outs[0], ref[0], 1e-4, 1e-6 * float(ref[0].abs().max())),
            ("xn", outs[1], ref[1], 1e-6, 1e-3), ("nis", outs[2], ref[2], 1e-4, 1e-5)):
        err = (got.double() - want.double()).abs()
        if not bool((err <= atol + rtol * want.double().abs()).all()):
            raise AssertionError(f"H8 {name} at {label}: {what} off the plain version by "
                                 f"{float(err.max()):.3e}")


def lib_sweep_plan(lib: ctypes.CDLL, mp: int, variant: int):
    """The plan a build of H11 reports (csl_sweep_probe_plan: Q, cluster,
    ring, rows a warp, rows a CTA, block, shared memory, registers, local
    bytes, grid), or None for a build without that entry."""
    fn = getattr(lib, "csl_sweep_probe_plan", None)
    if fn is None:
        return None
    fn.argtypes = [cuda.I, cuda.I, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * pr.SP_PLAN)()
    return list(out) if fn(mp, variant, out) == 0 else None


SP_STEPS = 64          # a diagnostic H11 build's steps stamped (-DSP_STAMPS)


def lib_sweep_stamps(lib: ctypes.CDLL, launch, steps: int):
    """A diagnostic H11 build's chain over one launch of ``steps`` steps
    (-DSP_STAMPS: csl_sweep_probe_stamps), or None for a build without
    them: medians over the steps of publish to publish, of the handover
    (a publish to the next producer's wait ending) and of the forming (that
    wait's end to the next publish), in ns of %globaltimer, with the
    handover and forming in cycles where the two events share an SM (the
    forming always does: one warp), and the kernel's span."""
    fn = getattr(lib, "csl_sweep_probe_stamps", None)
    if fn is None:
        return None
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    n = (SP_STEPS + 8) * 4
    out = (ctypes.c_ulonglong * n)()
    launch()
    torch.cuda.synchronize()
    if fn(out, n) != 0:
        return None
    t = np.frombuffer(out, dtype=np.uint64).reshape(-1, 4).astype(np.int64)
    st, cta = t[:SP_STEPS], t[SP_STEPS:]
    k = np.arange(min(steps, SP_STEPS) - 1)
    pub_gt, pub_clk, got_gt, got_clk = st[k, 0], st[k, 1], st[k, 2], st[k, 3]
    nxt_gt, nxt_clk = st[k + 1, 0], st[k + 1, 1]
    started = cta[:, 0] > 0
    med = lambda a: float(np.median(a)) if len(a) else None    # noqa: E731
    return dict(
        chain_ns=med(nxt_gt - pub_gt), handover_ns=med(got_gt - pub_gt),
        forming_ns=med(nxt_gt - got_gt), forming_cycles=med(nxt_clk - got_clk),
        handover_cycles=med(got_clk - pub_clk) if int(started.sum()) == 1 else None,
        span_ns=float(cta[started, 1].max() - cta[started, 0].min()) if started.any() else None,
        ctas=int(started.sum()), sms=int(len(np.unique(cta[started, 2]))))


def sweep_matrix(mp: int) -> np.ndarray:
    """The sweep probe's S made exactly symmetric with an exactly unit
    diagonal: H1's scaling and symmetrizations are then the identity."""
    s = probe_sweep.probe_matrix(mp)
    s = 0.5 * (s + s.T)
    np.fill_diagonal(s, 1.0)
    return s


def h11_check(name: str, call, s: torch.Tensor, nblk: int, variant: int) -> None:
    """A build of H11 against H1 on the unit-diagonal S (sym(out) bit for
    bit for unroll2 / unroll4, wide4 within 4 MP eps of max|swept block|);
    two calls bit for bit."""
    mp = s.shape[0]
    outs = [torch.empty_like(s) for _ in range(2)]
    for o in outs:
        call(cuda.ptr(s), cuda.ptr(o), mp, nblk, variant)
    h1 = sweep_si(s, torch.tensor([nblk], dtype=torch.int32, device=s.device))
    torch.cuda.synchronize()
    what = f"H11 {name} {pr.SWEEP_VARIANTS[variant]} at MP {mp}, NBLK {nblk}"
    if not torch.equal(outs[0], outs[1]):
        raise AssertionError(f"{what}: two calls differ")
    got = outs[0]
    if variant < 2:
        if not torch.equal(0.5 * (got + got.T), h1):
            raise AssertionError(f"{what}: sym(out) is not H1 bit for bit")
    else:
        k = 2 * nblk
        tol = 4 * mp * torch.finfo(torch.float32).eps * float(h1[:k, :k].abs().max())
        err = float((got[:k, :k] - h1[:k, :k]).abs().max())
        if not err <= tol:
            raise AssertionError(f"{what}: off H1 by {err:.3e} > {tol:.3e}")


def h13_check(name: str, launch, outs, args) -> None:
    """A build of H13 against the plain version (1e-5 of max|ref|); two
    calls bit for bit."""
    launch()
    first = [t.clone() for t in outs]
    launch()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, outs)):
        raise AssertionError(f"H13 {name}: two calls differ")
    for what, got, want in zip(("phtt", "sipht", "sivpht"), outs, pr.probe_dots_reference(*args)):
        err = float((got - want).abs().max())
        if not err <= 1e-5 * float(want.abs().max()):
            raise AssertionError(f"H13 {name}: {what} off the plain version by {err:.3e}")


def run_h11(calls: dict, libs: dict, dev) -> dict:
    """H11's builds in turns at each shape and variant, at NBLK and at 0."""
    results = {}
    for mp, nblk in H11_SHAPES:
        s = torch.as_tensor(sweep_matrix(mp), device=dev)
        out = torch.empty_like(s)
        for v, variant in enumerate(pr.SWEEP_VARIANTS):
            for name, call in calls.items():
                h11_check(name, call, s, nblk, v)
            row = dict(mp=mp, nblk=nblk)
            for n, key in ((nblk, "at_nblk"), (0, "at_0")):
                row[key] = turns({name: (lambda c=call, n=n: c(cuda.ptr(s), cuda.ptr(out), mp, n, v))
                                  for name, call in calls.items()})
            steps = nblk // 2 + nblk % 2 if variant == "wide4" else nblk
            row["per_step_us"] = {n: (row["at_nblk"][n]["us"] - row["at_0"][n]["us"]) / steps
                                  for n in calls}
            row["per_pivot_us"] = {n: (row["at_nblk"][n]["us"] - row["at_0"][n]["us"]) / nblk
                                   for n in calls}
            row["plans"] = {n: lib_sweep_plan(lib, mp, v) for n, lib in libs.items()}
            for n, lib in libs.items():
                st = lib_sweep_stamps(lib, lambda c=calls[n]: c(cuda.ptr(s), cuda.ptr(out), mp,
                                                                nblk, v), steps)
                if st:
                    row.setdefault("stamps", {})[n] = st
                    print(f"  stamps of {n} {variant} at MP {mp}: {st}", flush=True)
            results[f"{variant} MP {mp}"] = row
            print(f"H11 {variant} at MP {mp}, NBLK {nblk}: " + ", ".join(
                f"{n} {row['at_nblk'][n]['us']:.2f} us ({row['at_0'][n]['us']:.2f} at NBLK 0: "
                f"{row['per_pivot_us'][n]:.3f} us a pivot)" for n in calls)
                + "; plans (Q, cluster, ring, rows a warp, rows a CTA, block, smem, regs, "
                "local, grid): " + ", ".join(f"{n} {p}" for n, p in row["plans"].items() if p),
                flush=True)
    return results


PD_STAMPS = 7          # a diagnostic H13 build's stamps a CTA (-DPD_STAMPS)


def lib_dots_stamps(lib: ctypes.CDLL, grid: int, launch):
    """A diagnostic H13 build's phases (-DPD_STAMPS: csl_probe_dots_stamps)
    over one launch, or None for a build without them: the kernel's span,
    the spread of its CTAs' starts, and the median over CTAs of each stamp
    since its CTA's start (µs)."""
    fn = getattr(lib, "csl_probe_dots_stamps", None)
    if fn is None:
        return None
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    n = min(grid, 4096) * PD_STAMPS
    out = (ctypes.c_ulonglong * n)()
    launch()
    torch.cuda.synchronize()
    if fn(out, n) != 0:
        return None
    t = np.frombuffer(out, dtype=np.uint64).reshape(-1, PD_STAMPS).astype(np.int64)
    start = t[:, 0]
    phases = {name: float(np.median(t[:, k] - start)) / 1e3
              for k, name in enumerate(("hc and prows staged", "phtt formed and pushed",
                                        "cluster synced", "sipht formed", "exit"), 1)}
    return dict(span_us=float(t[:, 5].max() - start.min()) / 1e3,
                start_spread_us=float(start.max() - start.min()) / 1e3,
                sms=int(len(np.unique(t[:, 6]))), median_us=phases)


def run_h13(calls: dict, libs: dict, dev) -> dict:
    """H13's builds in turns at each shape, beside torch.matmul x 3."""
    results = {}
    for d, mp, rp in H13_SHAPES:
        args = tuple(torch.as_tensor(a, device=dev) for a in dots_inputs(d, mp, rp))
        contenders = {}
        for name, call in calls.items():
            outs = (torch.empty((d, mp), device=dev), torch.empty((mp, d), device=dev),
                    torch.empty((1, d), device=dev))
            ptrs = [cuda.ptr(t) for t in (*args, *outs)]
            launch = (lambda c=call, p=ptrs: c(*p, d, mp, rp))
            h13_check(f"{name} at D {d}", launch, outs, args)
            contenders[name] = launch

        def matmul3():
            phtt = torch.matmul(args[0].T, args[1].T)
            return phtt, torch.matmul(args[2], phtt.T), torch.matmul(args[3], phtt.T)
        contenders["matmul3"] = matmul3
        flops = 2.0 * d * mp * rp + 2.0 * mp * mp * d + 2.0 * mp * d
        moved = 4.0 * (rp * d + mp * rp + mp * mp + mp + d * mp + mp * d + d)
        bound_us = max(flops / PEAK_FLOPS, moved / PEAK_BYTES_PER_S) * 1e6
        plan = pr.probe_dots_plan(d, mp, rp)
        row = dict(d=d, mp=mp, rp=rp, plan=plan._asdict(), bound_us=bound_us,
                   **turns(contenders))
        for n in contenders:
            row[n]["share_of_bound"] = bound_us / row[n]["us"]
        for n, lib in libs.items():
            st = lib_dots_stamps(lib, plan.grid, contenders[n])
            if st:
                row.setdefault("stamps", {})[n] = st
                print(f"  stamps of {n} at D {d}: {st}", flush=True)
        results[f"D {d}"] = row
        print(f"H13 at D {d}, MP {mp}, RP {rp} (bound {bound_us:.3f} us): " + ", ".join(
            f"{n} {row[n]['us']:.2f} us ({100 * row[n]['share_of_bound']:.2f}%)"
            for n in contenders), flush=True)
    return results


def lib_observe_plan(lib: ctypes.CDLL, mp: int, rp: int):
    """The plan a build of H14 reports (csl_probe_observe_plan: rows a CTA,
    grid, block, shared memory, registers, local bytes), or None for a
    build without that entry."""
    fn = getattr(lib, "csl_probe_observe_plan", None)
    if fn is None:
        return None
    fn.argtypes = [cuda.I, cuda.I, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * pr.PO_PLAN)()
    return list(out) if fn(mp, rp, out) == 0 else None


PO_STAMPS = 7          # a diagnostic H14 build's stamps a CTA (-DPO_STAMPS)


def lib_observe_stamps(lib: ctypes.CDLL, grid: int, launch):
    """A diagnostic H14 build's phases (-DPO_STAMPS: csl_probe_observe_stamps)
    over one launch, or None for a build without them: the kernel's span,
    the spread of its CTAs' starts, the median over CTAs of each stamp
    since its CTA's start (µs), and of the observe alone (staged to its
    thread 0's observe done)."""
    fn = getattr(lib, "csl_probe_observe_stamps", None)
    if fn is None:
        return None
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    n = min(grid, 4096) * PO_STAMPS
    out = (ctypes.c_ulonglong * n)()
    launch()
    torch.cuda.synchronize()
    if fn(out, n) != 0:
        return None
    t = np.frombuffer(out, dtype=np.uint64).reshape(-1, PO_STAMPS).astype(np.int64)
    start = t[:, 0]
    phases = {name: float(np.median(t[:, k] - start)) / 1e3
              for k, name in enumerate(("staged", "observed", "synced", "Hc row written",
                                        "stores issued"), 1)}
    return dict(span_us=float(t[:, 5].max() - start.min()) / 1e3,
                start_spread_us=float(start.max() - start.min()) / 1e3,
                observe_us=float(np.median(t[:, 2] - t[:, 1])) / 1e3,
                sms=int(len(np.unique(t[:, 6]))), median_us=phases)


def h14_check(name: str, path: str, launch, outs, args, mp: int, rp: int) -> None:
    """A build of H14 against the plain version within chip_smoke.py's
    bounds (Hc and R rtol 1e-5, atol 1e-6; v atol 1.6e-5); two calls bit
    for bit."""
    launch()
    first = [t.clone() for t in outs]
    launch()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, outs)):
        raise AssertionError(f"H14 {name} {path}: two calls differ")
    for what, got, want in zip(("hc", "rmat", "v"), outs, pr.probe_observe_reference(*args, mp, rp)):
        atol = 1.6e-5 if what == "v" else 1e-6
        err = (got.double() - want.double()).abs()
        if not bool((err <= atol + 1e-5 * want.double().abs()).all()):
            raise AssertionError(f"H14 {name} {path}: {what} off the plain version by "
                                 f"{float(err.max()):.3e}")


def run_h14(calls: dict, libs: dict, dev) -> dict:
    """H14's builds in turns on both paths, beside the empty kernel at the
    package's launch; every build first bit for bit every other."""
    (xrows, zin, rsc, mp, rp), _ = observe_inputs()
    assert (mp, rp) in H14_SHAPES
    args = tuple(torch.as_tensor(a, device=dev) for a in (xrows, zin, rsc))
    moved = 4.0 * (rp + 3 * (mp // 2) + 4 + mp * rp + mp * mp + mp)
    bound_us = max(moved / PEAK_BYTES_PER_S, 40.0 * (mp // 2) / PEAK_FLOPS) * 1e6
    plans = {n: lib_observe_plan(lib, mp, rp) for n, lib in libs.items()}
    results = {}
    for p, path in enumerate(pr.OBSERVE_PATHS):
        contenders, outs_of = {}, {}
        for name, call in calls.items():
            outs = (torch.empty((mp, rp), device=dev), torch.empty((mp, mp), device=dev),
                    torch.empty((mp,), device=dev))
            ptrs = [cuda.ptr(t) for t in (*args, *outs)]
            launch = (lambda c=call, q=ptrs: c(*q, mp, rp, p))
            h14_check(name, path, launch, outs, args, mp, rp)
            contenders[name], outs_of[name] = launch, outs
        first = next(iter(outs_of))
        for name, outs in outs_of.items():
            if not all(torch.equal(a, b) for a, b in zip(outs, outs_of[first])):
                raise AssertionError(f"H14 {path}: {name} is not {first} bit for bit")
        contenders["floor"] = lambda: pr.probe_observe_floor(*args, mp, rp)
        row = dict(mp=mp, rp=rp, plan=pr.probe_observe_plan(mp, rp)._asdict(), plans=plans,
                   bound_us=bound_us, bit_equal=list(outs_of), **turns(contenders))
        for n in contenders:
            row[n]["share_of_bound"] = bound_us / row[n]["us"]
            row[n]["above_floor_us"] = row[n]["us"] - row["floor"]["us"]
        for n, lib in libs.items():
            st = lib_observe_stamps(lib, (plans.get(n) or [0, 0])[1], contenders[n])
            if st:
                row.setdefault("stamps", {})[n] = st
                print(f"  stamps of {n} {path}: {st}", flush=True)
        results[path] = row
        print(f"H14 {path} at MP {mp}, RP {rp} (bound {bound_us:.3f} us; builds bit for bit "
              f"equal: {', '.join(outs_of)}): " + ", ".join(
                  f"{n} {row[n]['us']:.2f} us ({100 * row[n]['share_of_bound']:.2f}%)"
                  for n in contenders)
              + "; plans (rows, grid, block, smem, regs, local): "
              + ", ".join(f"{n} {v}" for n, v in plans.items() if v), flush=True)
    return results


def main(argv=None, device="cuda") -> dict:
    argv = sys.argv[1:] if argv is None else argv
    dev = torch.device(device)
    if dev.type != "cuda":
        raise SystemExit("redesign_turns times kernels on the card: it needs a CUDA device")
    print(card_line(dev), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda.library()
    libs = {f: {"package": cuda.library()} for f in FILES}
    for label, stem, lib in build_variants(list(argv)):
        libs[stem][label] = lib
    calls = {k: {n: entry(lib, k) for n, lib in libs[f].items()} for k, (f, _, _) in ENTRY.items()}
    named = {Path(spec.partition("=")[2].partition(":")[0]).stem for spec in argv}
    run = named or set(FILES)
    results: dict = {"card": card_line(dev)}
    if "sweep_probe" in run:
        results["sweep_probe"] = run_h11(calls["sweep_probe"], libs["sweep_probe"], dev)
    if "probe_mosaic" in run:
        results["probe_dots"] = run_h13(calls["probe_dots"], libs["probe_mosaic"], dev)
        results["probe_observe"] = run_h14(calls["probe_observe"], libs["probe_mosaic"], dev)
    if "obs_panels" in run:
        results["obs_panels"] = run_h8(calls, libs, dev)
    if "stream_copy" in run:
        results["stream_copy"] = run_h12(calls, dev)

    line = json.dumps(results)
    if os.path.isdir("chiprun_out"):
        with open(os.path.join("chiprun_out", "redesign_turns.json"), "w") as f:
            f.write(line)
    print(line, flush=True)
    return results


def run_h8(calls: dict, libs: dict, dev) -> dict:
    """H8's builds in turns at each shape."""
    results = {}
    for label, d, nz, nbp in H8_SHAPES:
        args = h8_inputs(d, nz, nbp, dev)
        contenders = {}
        for name, call in calls["obs_panels"].items():
            launch, outs = h8_call(call, args)
            h8_check(label, name, launch, outs, args)
            contenders[name] = launch
        mp, rp = fk.frame_shapes(nz)
        moved = sum(t.numel() * 4 for t in args) + (mp * d + d + 1) * 4
        plans = {n: lib_plan(lib, d, mp, rp, nbp) for n, lib in libs["obs_panels"].items()}
        row = dict(d=d, mp=mp, rp=rp, nbp=nbp, plan=fk.obs_panels_plan(d, mp, rp, nbp)._asdict(),
                   plans=plans, bound_us=moved / PEAK_BYTES_PER_S * 1e6, **turns(contenders))
        for n, lib in libs["obs_panels"].items():
            st = lib_stamps(lib, (row["plans"].get(n) or [0, 0, 0])[2], contenders[n])
            if st:
                row.setdefault("stamps", {})[n] = st
                print(f"  stamps of {n} at {label}: {st}", flush=True)
        results[label] = row
        print(f"H8 at {label} (D {d}, MP {mp}, NBP {nbp}; bound {row['bound_us']:.3f} us): "
              + ", ".join(f"{n} {row[n]['us']:.2f} us" for n in contenders)
              + "; plans (width, panels, grid, cluster, block, rows, smem, regs, local, "
              "clusters at once): " + ", ".join(f"{n} {v}" for n, v in row["plans"].items() if v),
              flush=True)
        del args, contenders
    return results


def run_h12(calls: dict, dev) -> dict:
    """H12's builds in turns at each D, beside Tensor.copy_."""
    results = {}
    for d in H12_DIMS:
        gen = torch.Generator(dev).manual_seed(d)
        x = torch.randn((d, d), device=dev, generator=gen)
        out = torch.empty_like(x)
        contenders = {}
        for name, call in calls["stream_copy"].items():
            # Each build its own output, so no build's result stands for another's.
            o = torch.empty_like(x)
            launch = (lambda c=call, o=o: c(cuda.ptr(x), cuda.ptr(o), x.numel()))
            launch()
            torch.cuda.synchronize()
            if not torch.equal(o, x):
                raise AssertionError(f"H12 {name} at D {d}: not bit for bit the input")
            contenders[name] = launch
        contenders["copy_"] = lambda: out.copy_(x)
        row = dict(d=d, bytes=2 * x.numel() * 4, **turns(contenders))
        for n in contenders:
            row[n]["tb_per_s"] = row["bytes"] / (row[n]["us"] * 1e-6) / 1e12
        results[f"D {d}"] = row
        print(f"H12 at D {d} ({row['bytes'] / 1e6:.1f} MB moved): " + ", ".join(
            f"{n} {row[n]['us']:.2f} us = {row[n]['tb_per_s']:.3f} TB/s" for n in contenders),
            flush=True)
        del x, out, contenders
    return results


if __name__ == "__main__":
    main()
