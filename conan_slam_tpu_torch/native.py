"""ctypes bindings for the native host-side components (port of
conan_slam_tpu.native, with the same names and signatures).

``native/slam_baseline.cpp`` is the self-established CPU baseline
(BASELINE.md: the reference publishes no numbers): a clean-room C++
EKF-SLAM on the exact reference workload, the denominator of ``bench.py``'s
``vs_baseline``.  ``native/hostsim.cpp`` is the truth and observation
rollout in C++.  Both are the repo's one C++ program, which the two
packages share: this module builds its own copy of each library from those
sources and never writes where the reference's ``make`` builds.

How the libraries are built: ``g++`` (or ``$CXX``) with the reference
Makefile's flags (``-O3 -march=native -std=c++17 -fPIC -Wall``, so both
builds on one machine give the same bits) into
``conan_slam_tpu_torch/build/native/`` (listed in .gitignore), at first use
and again whenever a source is newer than its library, under the same file
lock as the CUDA kernels' build (``ops.cuda._locked``; processes that
build at once take turns, and whoever comes second finds the library
current).  The library is written under a temporary name and renamed into
place, so a loader sees the old library or the new one, never half of one.
A failed build or load raises with the compiler's output: there is no
fallback.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np

from conan_slam_tpu_torch.ops.cuda import BUILD_DIR as _KERNEL_BUILD_DIR
from conan_slam_tpu_torch.ops.cuda import _locked

NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
BUILD_DIR = _KERNEL_BUILD_DIR / "native"
CXXFLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall")

_libs: dict[str, ctypes.CDLL] = {}


def _stale(lib: Path, src: Path) -> bool:
    return not lib.exists() or src.stat().st_mtime > lib.stat().st_mtime


def cxx() -> str:
    """The C++ compiler: ``$CXX``, else ``g++`` (the Makefile's default)."""
    return os.environ.get("CXX") or "g++"


def build(name: str, *, native_dir: Path | None = None, build_dir: Path | None = None,
          compiler: str | None = None) -> tuple[Path, float, str]:
    """Build ``lib<name>.so`` from ``<native_dir>/<name>.cpp`` (default
    NATIVE_DIR) into ``build_dir`` (default BUILD_DIR) with ``compiler``
    (default ``cxx()``) if it is missing or older than its source, under
    the build directory's lock (a process that waited on it checks again).

    Returns ``(library path, seconds spent building, compiler output)``; the
    seconds are 0.0 when the library was current.  Raises RuntimeError with
    the compiler's output when the compiler fails or cannot be run.
    """
    src = (native_dir or NATIVE_DIR) / f"{name}.cpp"
    build_dir = build_dir or BUILD_DIR
    lib = build_dir / f"lib{name}.so"
    if not _stale(lib, src):
        return lib, 0.0, ""
    build_dir.mkdir(parents=True, exist_ok=True)
    with _locked(build_dir / ".lock"):
        if not _stale(lib, src):
            return lib, 0.0, ""
        t0 = time.perf_counter()
        tmp = build_dir / f".{lib.name}.{os.getpid()}.tmp"
        cmd = [compiler or cxx(), *CXXFLAGS, "-shared", "-o", str(tmp), str(src)]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"native build of {name} could not run {cmd[0]!r}: {e}") from e
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"native build of {name} failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        os.replace(tmp, lib)
        return lib, time.perf_counter() - t0, res.stdout + res.stderr


def _library(name: str) -> ctypes.CDLL:
    if name not in _libs:
        path, _, _ = build(name)
        _libs[name] = ctypes.CDLL(str(path))
    return _libs[name]


def _load() -> ctypes.CDLL:
    """The baseline library, built first if needed, its two entry points bound."""
    lib = _library("slam_baseline")
    f32p = ctypes.POINTER(ctypes.c_float)
    head = [
        f32p, ctypes.c_int,                                # landmarks
        f32p, ctypes.c_int,                                # waypoints
        ctypes.c_int, ctypes.c_uint64, ctypes.c_int,       # max_steps, seed, noise
        ctypes.c_int, ctypes.c_float,                      # prebuild_map, sigma0
        ctypes.c_int,                                      # opt (SIMD path)
    ]
    tail = [
        ctypes.POINTER(ctypes.c_double),                   # out seconds
        f32p,                                              # out ate
        f32p,                                              # out traj (nullable)
    ]
    lib.run_ekf_baseline_v2.restype = ctypes.c_int64
    lib.run_ekf_baseline_v2.argtypes = head + tail
    lib.run_ekf_baseline_v3.restype = ctypes.c_int64
    lib.run_ekf_baseline_v3.argtypes = head + [
        ctypes.c_int, ctypes.c_float, ctypes.c_float,      # gated, gate1, gate2
        ctypes.c_int,                                      # max_obs (0 = all)
    ] + tail
    return lib


def _load_hostsim() -> ctypes.CDLL:
    """The rollout library, built first if needed, its two entry points bound."""
    lib = _library("hostsim")
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.rollout_truth_native.restype = None
    lib.rollout_truth_native.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int,
        f32p, f32p, u8p, u8p,
    ]
    lib.rollout_observations_native.restype = None
    lib.rollout_observations_native.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int,
        f32p, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        f32p, i32p, u8p,
    ]
    return lib


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def rollout_truth_native(waypoints: np.ndarray, cfg, n_steps: int):
    """Native truth rollout; see sim.precompute.rollout_truth for semantics.

    Returns (x_true (T,3) f32, swa (T,) f32, active (T,) bool, done (T,) bool).
    """
    lib = _load_hostsim()
    wp = np.ascontiguousarray(waypoints, dtype=np.float32)
    x_true = np.empty((n_steps, 3), np.float32)
    swa = np.empty((n_steps,), np.float32)
    active = np.empty((n_steps,), np.uint8)
    done = np.empty((n_steps,), np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.rollout_truth_native(
        _f32p(wp), wp.shape[0], n_steps,
        np.float32(cfg.dt_controls), np.float32(cfg.velocity),
        np.float32(cfg.wheel_base),
        np.float32(cfg.rate_swa * cfg.dt_controls), np.float32(cfg.max_swa),
        np.float32(cfg.at_waypoint) ** 2, int(cfg.number_loops),
        _f32p(x_true), _f32p(swa), active.ctypes.data_as(u8p), done.ctypes.data_as(u8p),
    )
    return x_true, swa, active.astype(bool), done.astype(bool)


def rollout_observations_native(
    x_true: np.ndarray, landmarks: np.ndarray, max_range: float,
    nz: int, interval: int,
):
    """Native observation rollout; see sim.precompute.rollout_observations.

    Returns (z (F, NZ, 2) f32, ids (F, NZ) int32, mask (F, NZ) bool)."""
    lib = _load_hostsim()
    xt = np.ascontiguousarray(x_true, dtype=np.float32)
    lm = np.ascontiguousarray(landmarks, dtype=np.float32)
    n_steps = xt.shape[0]
    n_frames = n_steps // interval
    z = np.empty((n_frames, nz, 2), np.float32)
    ids = np.empty((n_frames, nz), np.int32)
    mask = np.empty((n_frames, nz), np.uint8)
    lib.rollout_observations_native(
        _f32p(xt), n_steps, interval,
        _f32p(lm), lm.shape[0], np.float32(max_range), nz,
        _f32p(z), ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return z, ids, mask.astype(bool)


class BaselineResult(NamedTuple):
    steps: int
    seconds: float
    steps_per_s: float
    ate_rmse: float
    trajectory: np.ndarray | None


def run_ekf_baseline(
    landmarks: np.ndarray,
    waypoints: np.ndarray,
    max_steps: int = 25_000,
    seed: int = 0,
    with_noise: bool = True,
    want_trajectory: bool = False,
    prebuild_map: bool = False,
    sigma0: float = 1.0,
    opt: bool = False,
    gated: bool = False,
    gate_reject: float = 50.0,
    gate_augment: float = 1000.0,
    max_obs: int = 0,
) -> BaselineResult:
    """Run the native C++ EKF-SLAM on the given world (row-major (N, 2)).

    ``prebuild_map`` starts from a fully-registered map (steady-state
    tracking benchmark) instead of an empty one.  ``opt`` selects the
    SIMD-scheduled update path (the single-core CPU bound) instead of the
    reference-style scalar loops.  ``gated`` switches association from the
    ground-truth id table to defect-fixed Mahalanobis-gated NN (reference
    EKF.cpp:235-326 with SURVEY defect 4 fixed) with the given gates;
    ``max_obs`` caps the per-frame measurement buffer (0 = all visible) to
    mirror the filter's fixed-size compact buffer.  The run releases the
    GIL (ctypes), so runs on other threads go on meanwhile.
    """
    lib = _load()
    lm = np.ascontiguousarray(landmarks, dtype=np.float32)
    wp = np.ascontiguousarray(waypoints, dtype=np.float32)
    secs = ctypes.c_double(0.0)
    ate = ctypes.c_float(0.0)
    traj = np.zeros((max_steps, 3), np.float32) if want_trajectory else None
    traj_ptr = _f32p(traj) if traj is not None else ctypes.POINTER(ctypes.c_float)()
    steps = lib.run_ekf_baseline_v3(
        _f32p(lm), lm.shape[0], _f32p(wp), wp.shape[0],
        max_steps, seed, int(with_noise), int(prebuild_map), sigma0,
        int(opt), int(gated), gate_reject, gate_augment, max_obs,
        ctypes.byref(secs), ctypes.byref(ate), traj_ptr,
    )
    secs_v = max(secs.value, 1e-9)
    return BaselineResult(
        steps=int(steps),
        seconds=secs_v,
        steps_per_s=steps / secs_v,
        ate_rmse=float(ate.value),
        trajectory=traj[:steps] if traj is not None else None,
    )
