"""A redesigned kernel in turns against other builds of it, on one card:
H8 ``obs_panels`` and H12 ``stream_copy``.

    python -m conan_slam_tpu_torch.benchmarks.redesign_turns LABEL=FILE[:FLAG,...] ...

Each ``LABEL=FILE`` is a version of ``csrc/obs_panels.cu`` or
``csrc/stream_copy.cu`` (which of the two, its file name says): an earlier
commit's (``git archive REV conan_slam_tpu_torch/csrc``), or the package's
own with ``-D`` flags after the colon (``new16=conan_slam_tpu_torch/csrc/
stream_copy.cu:-DSC_CHUNK=16384,-DSC_STAGES=6``).  Each is compiled with
``nvcc`` beside the package's headers into a library of its own under
``build/turns/`` and called through the same C entry as the package's
kernel, which runs as the label ``package``.

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

from conan_slam_tpu_torch.benchmarks import card_line
from conan_slam_tpu_torch.ops import cuda
from conan_slam_tpu_torch.ops import frame_kernel as fk

ROUNDS = 3              # each contender runs 2 x ROUNDS turns
ITERS = 20              # calls a turn
PEAK_BYTES_PER_S = 3.35e12
# H8's shapes: (label, D, NZ, NBP).
H8_SHAPES = (("config 2", 1024, 64, 24), ("10k", 20224, 64, 24), ("MP 240", 1024, 120, 24),
             ("MP 480", 1024, 240, 24))
H12_DIMS = (2304, 9216)
ENTRY = {"obs_panels": ("csl_obs_panels", [cuda.P] * 9 + [cuda.I] * 4 + [cuda.P]),
         "stream_copy": ("csl_stream_copy", [cuda.P, cuda.P, cuda.L, cuda.P])}


def build_variant(label: str, spec: str) -> tuple[str, ctypes.CDLL]:
    """Compile ``FILE[:FLAG,...]`` into ``build/turns/lib<kernel>_<label>.so``;
    returns (the kernel it holds, the loaded library)."""
    path, _, flags = spec.partition(":")
    kernel = Path(path).stem
    if kernel not in ENTRY:
        raise ValueError(f"{label}: {path} is neither obs_panels.cu nor stream_copy.cu")
    out = cuda.BUILD_DIR / "turns" / f"lib{kernel}_{label}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [cuda._nvcc(), *cuda.NVCC_FLAGS, "-I", str(cuda.CSRC), "-shared", "-o", str(out), path,
           *[f for f in flags.split(",") if f]]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {label}:\n{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    return kernel, ctypes.CDLL(str(out))


def entry(lib: ctypes.CDLL, kernel: str):
    """The C entry of ``kernel`` in ``lib``, raising on a launch error."""
    symbol, argtypes = ENTRY[kernel]
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


def main(argv=None, device="cuda") -> dict:
    argv = sys.argv[1:] if argv is None else argv
    dev = torch.device(device)
    if dev.type != "cuda":
        raise SystemExit("redesign_turns times kernels on the card: it needs a CUDA device")
    print(card_line(dev), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda.library()
    libs = {k: {"package": cuda.library()} for k in ENTRY}
    for spec in argv:
        label, _, rest = spec.partition("=")
        kernel, lib = build_variant(label, rest)
        libs[kernel][label] = lib
    calls = {k: {n: entry(lib, k) for n, lib in v.items()} for k, v in libs.items()}
    results: dict = {"card": card_line(dev), "obs_panels": {}, "stream_copy": {}}

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
        results["obs_panels"][label] = row
        print(f"H8 at {label} (D {d}, MP {mp}, NBP {nbp}; bound {row['bound_us']:.3f} us): "
              + ", ".join(f"{n} {row[n]['us']:.2f} us" for n in contenders)
              + "; plans (width, panels, grid, cluster, block, rows, smem, regs, local, "
              "clusters at once): " + ", ".join(f"{n} {v}" for n, v in row["plans"].items() if v),
              flush=True)
        del args, contenders

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
        results["stream_copy"][f"D {d}"] = row
        print(f"H12 at D {d} ({row['bytes'] / 1e6:.1f} MB moved): " + ", ".join(
            f"{n} {row[n]['us']:.2f} us = {row[n]['tb_per_s']:.3f} TB/s" for n in contenders),
            flush=True)
        del x, out, contenders

    line = json.dumps(results)
    if os.path.isdir("chiprun_out"):
        with open(os.path.join("chiprun_out", "redesign_turns.json"), "w") as f:
            f.write(line)
    print(line, flush=True)
    return results


if __name__ == "__main__":
    main()
