"""The port's native loader (conan_slam_tpu_torch.native) against the
reference's (conan_slam_tpu.native): the same C++ sources built by g++ with
the same flags, so the same inputs give the same bits.  g++ is on the
image, so nothing here skips.  The port builds into its own directory
(conan_slam_tpu_torch/build/native/), never into native/build/, which the
reference's ``make`` owns."""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from conan_slam_tpu import native as ref_native
from conan_slam_tpu.config import SlamConfig as RefConfig
from conan_slam_tpu_torch import native
from conan_slam_tpu_torch.config import SlamConfig
from conan_slam_tpu_torch.ops import cuda
from conan_slam_tpu_torch.sim import precompute
from conan_slam_tpu_torch.sim.world import default_world

REPO = Path(__file__).resolve().parent.parent
STEPS = 400


@pytest.fixture(scope="module")
def world_np():
    w = default_world(device="cpu")
    return w.landmarks.numpy(), w.waypoints.numpy()


def test_port_builds_into_its_own_directory(tmp_path, monkeypatch, world_np):
    # The default directory is the port's gitignored build directory.
    assert native.BUILD_DIR == cuda.BUILD_DIR / "native"
    assert native.BUILD_DIR.is_relative_to(REPO / "conan_slam_tpu_torch" / "build")
    assert not native.BUILD_DIR.is_relative_to(REPO / "native")
    assert native.NATIVE_DIR == REPO / "native"
    # The libraries it loads lie there.
    native.rollout_truth_native(world_np[1], SlamConfig(), 10)
    native.run_ekf_baseline(*world_np, 12)
    for name in ("hostsim", "slam_baseline"):
        assert Path(native._libs[name]._name).parent == native.BUILD_DIR
    # Every path it hands the compiler to write lies under the build
    # directory: a compiler that records its arguments, then runs g++.
    log = tmp_path / "argv.txt"
    wrapper = tmp_path / "cxx"
    wrapper.write_text(f"#!/bin/sh\necho \"$@\" >> {log}\nexec g++ \"$@\"\n")
    wrapper.chmod(0o755)
    build = tmp_path / "build" / "native"
    monkeypatch.setattr(native, "BUILD_DIR", build)
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setenv("CXX", str(wrapper))
    x_true, *_ = native.rollout_truth_native(world_np[1], SlamConfig(), 50)
    native.run_ekf_baseline(*world_np, 12)
    calls = [line.split() for line in log.read_text().splitlines()]
    assert len(calls) == 2
    for argv in calls:
        out = Path(argv[argv.index("-o") + 1])
        assert out.parent == build and not out.is_relative_to(REPO / "native")
        assert tuple(argv[:len(native.CXXFLAGS)]) == native.CXXFLAGS
    assert sorted(p.name for p in build.iterdir()) == [".lock", "libhostsim.so",
                                                       "libslam_baseline.so"]
    np.testing.assert_array_equal(x_true, ref_native.rollout_truth_native(
        world_np[1], RefConfig(), 50)[0])


@pytest.mark.parametrize("kw", [dict(), dict(opt=True), dict(opt=True, gated=True, max_obs=64)],
                         ids=["scalar", "simd", "gated"])
def test_baseline_bit_equal_to_reference(world_np, kw):
    got = native.run_ekf_baseline(*world_np, STEPS, seed=3, want_trajectory=True, **kw)
    ref = ref_native.run_ekf_baseline(*world_np, STEPS, seed=3, want_trajectory=True, **kw)
    assert got.steps == ref.steps == STEPS
    assert got.ate_rmse == ref.ate_rmse and np.isfinite(got.ate_rmse)
    np.testing.assert_array_equal(got.trajectory, ref.trajectory)
    assert got.steps_per_s > 0


def test_baseline_v2_entry_is_bound(world_np):
    # run_ekf_baseline_v2 (no gating arguments) is v3 with the table
    # association, bit for bit.
    lib = native._load()
    lm = np.ascontiguousarray(world_np[0], np.float32)
    wp = np.ascontiguousarray(world_np[1], np.float32)
    traj = np.zeros((200, 3), np.float32)
    secs, ate = ctypes.c_double(0.0), ctypes.c_float(0.0)
    f32p = ctypes.POINTER(ctypes.c_float)
    steps = lib.run_ekf_baseline_v2(lm.ctypes.data_as(f32p), lm.shape[0],
                                    wp.ctypes.data_as(f32p), wp.shape[0], 200, 5, 1, 0, 1.0, 1,
                                    ctypes.byref(secs), ctypes.byref(ate),
                                    traj.ctypes.data_as(f32p))
    v3 = native.run_ekf_baseline(*world_np, 200, seed=5, opt=True, want_trajectory=True)
    assert steps == v3.steps == 200
    assert ate.value == v3.ate_rmse
    np.testing.assert_array_equal(traj, v3.trajectory)


def test_rollouts_bit_equal_to_reference(world_np):
    lm, wp = world_np
    cfg, rcfg = SlamConfig(), RefConfig()
    got = native.rollout_truth_native(wp, cfg, 3000)
    ref = ref_native.rollout_truth_native(wp, rcfg, 3000)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    obs = native.rollout_observations_native(got[0], lm, cfg.max_range, 30, cfg.observe_interval)
    robs = ref_native.rollout_observations_native(ref[0], lm, rcfg.max_range, 30,
                                                  rcfg.observe_interval)
    for a, b in zip(obs, robs):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_native_rollouts_agree_with_numpy(world_np):
    # tests/test_sim.py's bounds on the reference's native rollout.
    lm, wp = world_np
    cfg = SlamConfig()
    n = 6000
    rp = precompute.rollout_truth(wp, cfg, n)
    rn = precompute.rollout_truth(wp, cfg, n, use_native=True)
    np.testing.assert_allclose(rn.x_true, rp.x_true, atol=2e-3)
    np.testing.assert_allclose(rn.swa, rp.swa, atol=1e-4)
    np.testing.assert_array_equal(rn.done, rp.done)
    np.testing.assert_array_equal(rn.active, rp.active)
    interval = cfg.observe_interval
    op = precompute.rollout_observations(rp.x_true, lm, cfg.max_range, 30, interval)
    on = precompute.rollout_observations(rp.x_true, lm, cfg.max_range, 30, interval,
                                         use_native=True)
    np.testing.assert_array_equal(on.ids, op.ids)
    np.testing.assert_array_equal(on.mask, op.mask)
    np.testing.assert_allclose(on.z_true, op.z_true, atol=2e-3)


@pytest.mark.parametrize("which", ["truth", "observations"])
def test_use_native_raises_on_a_failed_build(tmp_path, monkeypatch, world_np, which):
    # g++ pointed at a missing binary: the call raises, it does not fall
    # back to the numpy rollout.
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    lm, wp = world_np
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        if which == "truth":
            precompute.rollout_truth(wp, SlamConfig(), 60, use_native=True)
        else:
            x_true = precompute.rollout_truth(wp, SlamConfig(), 60).x_true
            precompute.rollout_observations(x_true, lm, 2000.0, 30, 6, use_native=True)
    assert not (tmp_path / "native" / "libhostsim.so").exists()


def test_failed_compile_raises_with_compiler_output(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    (src / "broken.cpp").write_text("int f( {\n")
    with pytest.raises(RuntimeError, match="native build of broken failed"):
        native.build("broken", native_dir=src, build_dir=tmp_path / "out")
    assert [p.name for p in (tmp_path / "out").iterdir()] == [".lock"]


def test_two_processes_building_at_once_leave_one_good_library(tmp_path, world_np):
    build = tmp_path / "native"
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(REPO)!r})
        from pathlib import Path
        from conan_slam_tpu_torch import native
        path, secs, _ = native.build("hostsim", build_dir=Path({str(build)!r}))
        print(path, secs > 0.0)
    """)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1] for o in outs]
    built = sorted(o[0].split()[1] for o in outs)
    assert built == ["False", "True"], outs        # one built, the other found it current
    assert sorted(p.name for p in build.iterdir()) == [".lock", "libhostsim.so"]
    lib = ctypes.CDLL(str(build / "libhostsim.so"))
    assert lib.rollout_truth_native is not None
