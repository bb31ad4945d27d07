"""The port-side bench scripts of the bench tail (conan_slam_tpu_torch.
benchmarks: bench_gated, bench_kernels, seed_sweep, seed_sweep_gated,
study_pf, and bench_framestep's modes past the scan and driver modes) on
the CPU at a tiny size, each held to the workload the JAX script builds:
the same world arrays, configuration and rollout."""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conan_slam_tpu.config import SlamConfig as JSlamConfig
from conan_slam_tpu.filters.ekf import init_state_with_map as j_init_state_with_map
from conan_slam_tpu.ops.pallas_update import rank_update_t_reference as j_rank_update_reference
from conan_slam_tpu.runner.loop import precompute_rollout as j_precompute_rollout
from conan_slam_tpu.sim.world import default_world as j_default_world
from conan_slam_tpu.sim.world import random_world as j_random_world
from conan_slam_tpu_torch.benchmarks import (
    bench_framestep,
    bench_gated,
    bench_kernels,
    native_baseline,
    seed_sweep,
    seed_sweep_gated,
    study_pf,
)
from conan_slam_tpu_torch.benchmarks.world import (
    BENCH_STEPS,
    N_LANDMARKS,
    NATIVE_STEPS,
    SIGMA0,
    bench_world,
    gated_world,
)
from conan_slam_tpu_torch.config import SlamConfig
from conan_slam_tpu_torch.ops.rank_update import rank_update_t
from conan_slam_tpu_torch.runner import loop
from conan_slam_tpu_torch.runner.loop import precompute_rollout

REPO = Path(__file__).resolve().parent.parent


def _reference_script(name: str):
    """A root benchmarks/ script as a module (their imports of JAX are
    inside main())."""
    spec = importlib.util.spec_from_file_location(f"ref_{name}", REPO / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _same_config(port: SlamConfig, ref: JSlamConfig):
    for field in ("max_landmarks", "max_obs", "switch_association_known", "enable_augment",
                  "gate_reject", "gate_augment", "num_particles", "pf_resample_kind",
                  "pf_roughening", "observe_interval", "max_range"):
        assert getattr(port, field) == getattr(ref, field), field


def _same_rollout(port, ref):
    # The reference's precompute takes the native C++ rollout where it can
    # build it, the port numpy: tests/test_sim.py's bounds between the two.
    (px, pswa, pact, pdone), (pz, pids, pmask) = port
    (rx, rswa, ract, rdone), (rz, rids, rmask) = ref
    np.testing.assert_allclose(px.numpy(), np.asarray(rx), atol=2e-3)
    np.testing.assert_allclose(pswa.numpy(), np.asarray(rswa), atol=1e-4)
    for a, b in ((pact, ract), (pdone, rdone), (pids, rids), (pmask, rmask)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(pz.numpy(), np.asarray(rz), atol=2e-3)


@pytest.fixture
def tiny(monkeypatch):
    for k, v in {"SWEEP_STEPS": "240", "GATED_STEPS": "240", "SWEEP_WORKERS": "2"}.items():
        monkeypatch.setenv(k, v)


# -------------------------------------------------------- the workloads


def test_bench_gated_world_and_rollout_are_the_references():
    world = gated_world(500, "cpu")
    ref = j_random_world(jax.random.PRNGKey(7), 500)._replace(waypoints=j_default_world().waypoints)
    np.testing.assert_array_equal(world.landmarks.numpy(), np.asarray(ref.landmarks))
    np.testing.assert_array_equal(world.waypoints.numpy(), np.asarray(ref.waypoints))
    cfg = SlamConfig(max_landmarks=500, max_obs=64, switch_association_known=False)
    jcfg = JSlamConfig(max_landmarks=500, max_obs=64, switch_association_known=False)
    _same_config(cfg, jcfg)
    _same_rollout(precompute_rollout(world, cfg, 1200), j_precompute_rollout(ref, jcfg, 1200))


def test_gated_world_at_another_size_is_the_smoke_big_world():
    import chip_smoke

    got = gated_world(10_000, "cpu")
    lm = np.random.default_rng(53).uniform(-5000.0, 5000.0, size=(10_000, 2)).astype(np.float32)
    np.testing.assert_array_equal(got.landmarks.numpy(), lm)
    np.testing.assert_array_equal(chip_smoke.big_world("cpu").landmarks.numpy(), lm)
    np.testing.assert_array_equal(got.waypoints.numpy(), gated_world(500, "cpu").waypoints.numpy())


def test_seed_sweep_workload_is_bench_py():
    bench = importlib.import_module("bench")
    assert (N_LANDMARKS, BENCH_STEPS, NATIVE_STEPS, SIGMA0) == (
        bench.N_LANDMARKS, bench.BENCH_STEPS, bench.NATIVE_STEPS, bench.SIGMA0)
    lm_ref, wp_ref, jworld = bench.build_world()
    lm, world, state0 = bench_world(N_LANDMARKS, "cpu")
    np.testing.assert_array_equal(lm, lm_ref)
    np.testing.assert_array_equal(world.waypoints.numpy(), wp_ref)
    jstate = j_init_state_with_map(jworld.landmarks, sigma0=bench.SIGMA0)
    np.testing.assert_array_equal(state0.x.numpy(), np.asarray(jstate.x))
    np.testing.assert_array_equal(state0.p.numpy(), np.asarray(jstate.p))
    _same_config(SlamConfig(max_landmarks=N_LANDMARKS, max_obs=64),
                 JSlamConfig(max_landmarks=bench.N_LANDMARKS, max_obs=64))


def test_study_pf_configs_are_the_references():
    ref = _reference_script("study_pf")
    assert study_pf.CONFIGS == ref.CONFIGS
    for label, kind, rough, n in study_pf.CONFIGS:
        _same_config(SlamConfig(num_particles=n, pf_resample_kind=kind, pf_roughening=rough),
                     JSlamConfig(num_particles=n, pf_resample_kind=kind, pf_roughening=rough))


def test_bench_kernels_fold_is_the_references_update_and_downdate():
    # P + V B V^T - W1 W1^T as the reference's XLA version forms it, against
    # the port's fold through rank_update_t (its plain version on the CPU).
    assert (bench_kernels.ITERS, bench_kernels.DEFAULT) == (50, (1024, 2051, 4096, 8192))
    rng = np.random.default_rng(0)
    d, r, m = 203, bench_kernels.RANK, bench_kernels.DOWNDATE
    a = rng.normal(size=(d, d)).astype(np.float32)
    p = (a + a.T) / 2
    v = rng.normal(size=(d, r)).astype(np.float32) * 1e-3
    b = np.eye(r, dtype=np.float32)
    w1 = rng.normal(size=(d, m)).astype(np.float32) * 1e-3
    want = np.asarray(j_rank_update_reference(jnp.asarray(p), jnp.asarray(v.T), jnp.asarray(b))
                      - jnp.asarray(w1) @ jnp.asarray(w1).T)
    got = rank_update_t(torch.as_tensor(p), *bench_kernels.folded(
        torch.as_tensor(v), torch.as_tensor(b), torch.as_tensor(w1)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())


# ---------------------------------------------------- the scripts, tiny


def test_bench_gated_runs_on_cpu(monkeypatch, capsys):
    res = bench_gated.main(["240"], device="cpu")
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("device: cpu")
    assert any(ln.startswith("gated 500lm from scratch: ") and "mapped=" in ln for ln in out)
    assert np.isfinite(res["ate_m"]) and res["mapped"] > 0 and res["gated_full"] is None
    assert bench_gated.gated_full(0.2, 300, 500, 25_000) is True
    assert bench_gated.gated_full(0.6, 300, 500, 25_000) is False
    assert bench_gated.gated_full(0.2, 341, 500, 25_002) is False


def test_bench_gated_chunked_and_resumed(tmp_path, monkeypatch):
    # GATED_CHUNK goes through the port's chunked driver; GATED_CKPT_DIR
    # checkpoints its first run, which a second process-free call resumes.
    monkeypatch.setenv("GATED_CHUNK", "120")
    monkeypatch.setenv("GATED_CKPT_DIR", str(tmp_path))
    res = bench_gated.main(["240"], device="cpu")
    assert sorted(p.name for p in tmp_path.iterdir() if p.suffix == ".pt") == [
        "chunk_00000.pt", "chunk_00001.pt"]
    again = bench_gated.main(["240"], device="cpu")
    assert (again["ate_m"], again["mapped"]) == (res["ate_m"], res["mapped"])


def test_bench_kernels_runs_on_cpu(capsys):
    res = bench_kernels.main(["64", "203"], device="cpu")
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("device: cpu")
    for d in (64, 203):
        for name in ("h4", "plain", "addmm"):
            row = res[d][name]
            assert row["max_abs_err"] <= res[d]["bound"] and row["us"] > 0
            assert row["frames"] == bench_kernels.ITERS
            assert any(ln.startswith(f"D={d:5d} {name:6s}:") and "GB/s" in ln for ln in out)


@pytest.mark.parametrize("broken", [lambda p, vt, b: p.clone(),
                                    lambda p, vt, b: p + vt[:20].T @ (b[:20, :20] @ vt[:20])],
                         ids=["no-update", "no-downdate"])
def test_bench_kernels_gate_fails_a_kernel_that_drops_a_term(broken, monkeypatch):
    # The fold's update (~1e-5) stands above the gate (1e-6 of max |P'|):
    # a kernel that leaves P as it was, or drops the downdate, fails it.
    monkeypatch.setattr(bench_kernels, "rank_update_t", broken)
    with pytest.raises(AssertionError, match="h4: .* off the plain version"):
        bench_kernels.main(["203"], device="cpu")


@pytest.mark.parametrize("module,n_landmarks", [(seed_sweep, N_LANDMARKS),
                                                (seed_sweep_gated, 500)])
def test_seed_sweep_runs_on_cpu(module, n_landmarks, tiny, capsys):
    res = module.main(["2"], device="cpu")
    out = capsys.readouterr().out
    assert "| stack | median | mean | p90 | max |" in out and "P(port seed beats native" in out
    assert len(res["port"]) == len(res["native"]) == len(res["mapped"]) == 2
    assert all(np.isfinite(res["port"] + res["native"])) and res["steps"] == 240
    if module is seed_sweep:
        assert res["mapped"] == [n_landmarks] * 2
    else:
        assert all(0 < m <= n_landmarks for m in res["mapped"])
    assert 0.0 <= res["p_port_beats_native"] <= 1.0


def test_seed_sweep_native_threads_give_the_sequential_results(monkeypatch):
    # SWEEP_WORKERS runs the native seeds on threads: the same ATEs as one
    # at a time.
    from conan_slam_tpu_torch.native import run_ekf_baseline

    lm, world, _ = bench_world(64, "cpu")
    wp = world.waypoints.numpy()

    def run(s):
        return run_ekf_baseline(lm, wp, 120, seed=s, prebuild_map=True, opt=True).ate_rmse
    with seed_sweep.native_beside(3, 3, run) as results:
        got = results()
    assert got == [run(s) for s in range(3)]


def test_native_baseline_prints_bench_pys_lines(capsys):
    res = native_baseline.main(["60"])
    out = capsys.readouterr().out
    assert "native scalar: 60 steps in " in out and "native SIMD:   60 steps in " in out
    assert "host CPU: " in out
    assert res["denominator_steps_per_s"] == max(res["scalar"]["steps_per_s"],
                                                 res["simd"]["steps_per_s"])
    assert res["scalar"]["ate_m"] < 0.05 and res["simd"]["ate_m"] < 0.05


def test_study_pf_runs_on_cpu(capsys):
    res = study_pf.main(["1", "120"], device="cpu", configs=2)
    out = capsys.readouterr().out
    assert list(res) == [c[0] for c in study_pf.CONFIGS[:2]]
    assert "| configuration | median ATE [m] | p90 ATE [m] | max [m] | frac > 1 m |" in out
    assert all(np.isfinite(r["ates"]).all() for r in res.values())


# ------------------------------------------------ bench_framestep's modes

NEW_MODES = ("factors", "smallchain", "gather", "chainkernel", "chainonly", "gmrank", "glue",
             "body_noaug", "body_uncond", "gbody_aug", "gbody_noaug", "gating", "assoc",
             "megaprep", "prep_prc", "prep_pads", "prep_zin")


@pytest.mark.parametrize("mode", NEW_MODES)
def test_bench_framestep_mode_runs_on_cpu(mode, monkeypatch, capsys):
    monkeypatch.setenv("FS_LANDMARKS", "32")
    monkeypatch.setenv("FS_STEPS", "24")
    real = loop.fused_frame_step
    res = bench_framestep.main([mode], device="cpu")
    got = res["modes"][mode]
    assert got["frames"] == 4 and got["us"] > 0 and got["launches"] == {}
    line = next(ln for ln in capsys.readouterr().out.splitlines() if ln.startswith(f"{mode:14s}:"))
    assert "us/frame" in line
    assert loop.fused_frame_step is real        # glue puts the frame kernel back


def test_bench_framestep_glue_touches_only_the_mean(monkeypatch):
    # glue's body is the driver's frame with the frame kernel a touch: the
    # mean moves by ~1e-20 of the measurements, P stays as it was.
    monkeypatch.setenv("FS_LANDMARKS", "32")
    monkeypatch.setenv("FS_STEPS", "24")
    seen = {}
    real_scan = bench_framestep.scan_graph

    def spy(step, carry, n, block):
        res = real_scan(step, carry, n, block)
        seen["carry0"], seen["res"] = carry, res
        return res
    monkeypatch.setattr(bench_framestep, "scan_graph", spy)
    bench_framestep.main(["glue"], device="cpu")
    x0, p0 = seen["carry0"][:2]
    x, p = seen["res"].carry[:2]
    assert torch.equal(p, p0) and not torch.equal(x, x0)
    assert float((x - x0).abs().max()) < 1e-12 + 1e-6 * float(x0.abs().max())


@pytest.mark.parametrize("mode", ["body_aug", "full_u4"])
def test_bench_framestep_refuses_modes_with_no_counterpart(mode):
    with pytest.raises(ValueError, match=f"{mode}: .*(lax.cond|unroll)"):
        bench_framestep.main([mode], device="cpu")


def test_bench_tail_imports_no_jax():
    code = textwrap.dedent("""
        import sys
        import conan_slam_tpu_torch.native
        from conan_slam_tpu_torch.benchmarks import (
            bench_framestep, bench_gated, bench_kernels, native_baseline, seed_sweep,
            seed_sweep_gated, study_pf)
        bad = sorted(k for k in sys.modules
                     if k.split(".")[0] in ("jax", "jaxlib", "conan_slam_tpu", "bench"))
        assert not bad, bad
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
