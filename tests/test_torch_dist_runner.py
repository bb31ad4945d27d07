"""The sharded runtime as a whole (conan_slam_tpu_torch.parallel), on gloo
ranks on the CPU: the sharded simulation loop on the JAX run's seed-42
draws against that run and the port's own single-device loop, the dry
run, the collective audit's bytes against the reference's HLO audit, and
the multi-process smoke over a TCP rendezvous.

Tolerances, each with its reason:
  * x_est: atol 2e-3 m, the slice's bound (tests/test_torch_run_ekf.py):
    ~5 km positions, float32 ulps of 4.9e-4 m, rounded in two op orders
    frame after frame; x_true, the map size and the course's end equal
    (the same truth chain on the same draws);
  * the audit: bytes are counts, equal.
"""

import importlib.util
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conan_slam_tpu.parallel import dist_ekf as jdist_ekf
from conan_slam_tpu.parallel import dist_fastframe as jdist_ff
from conan_slam_tpu.parallel.mesh import STATE_AXIS
from conan_slam_tpu.parallel.mesh import make_mesh as jmake_mesh
from conan_slam_tpu_torch.config import SlamConfig
from conan_slam_tpu_torch.parallel import dist_ekf, dist_fastframe, launch, tasks
from conan_slam_tpu_torch.runner.loop import run_ekf_slam
from conan_slam_tpu_torch.sim.world import default_world

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VALET = os.path.join(REPO, "conan_slam_tpu_torch", "sim", "data", "valet_seed42.npz")
N_STEPS = 600


@pytest.fixture(scope="module")
def pools():
    made = {}

    def get(n):
        if n not in made or made[n].closed:
            made[n] = launch.RankPool(n, "cpu", timeout=300.0)
        return made[n]

    yield get
    for p in made.values():
        p.close()


@pytest.fixture(scope="module")
def valet():
    d = np.load(VALET)
    n_frames = N_STEPS // SlamConfig().observe_interval
    world = default_world(device="cpu")
    return {"world": tuple(t.numpy() for t in world), "ctrl": d["ctrl"][:n_frames],
            "obs": d["obs"][:n_frames], "x_est": d["x_est_known"][:N_STEPS],
            "n_active": d["n_active_known"][:N_STEPS], "done": d["done_known"][:N_STEPS],
            "x_true": d["x_true"][:N_STEPS]}


def _single(valet, cfg):
    return run_ekf_slam(default_world(device="cpu"), cfg, None, N_STEPS,
                        ctrl_noise=torch.as_tensor(valet["ctrl"]),
                        obs_noise=torch.as_tensor(valet["obs"]))


def _same_bits(results, key):
    ref = [np.ascontiguousarray(a).tobytes() for a in results[0][key]]
    for r in results[1:]:
        assert [np.ascontiguousarray(a).tobytes() for a in r[key]] == ref


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_run_tracks_the_reference_and_the_single_device_run(pools, valet, n):
    # 600 steps of the valet course on the JAX run's seed-42 draws: the
    # sharded loop against the JAX run_ekf_slam's x_est (the reference's
    # key schedule is the sharded runner's) and the port's own
    # single-device loop on the same draws; every output the same bits on
    # every rank.
    cfg = SlamConfig()
    res = pools(n).run(tasks.run_sharded, {"state": n}, valet["world"], cfg, N_STEPS, None,
                       valet["ctrl"], valet["obs"])
    _same_bits(res, "outs")
    outs = res[0]["outs"]
    _, single = _single(valet, cfg)
    np.testing.assert_allclose(outs.x_est, valet["x_est"], rtol=0, atol=2e-3)
    np.testing.assert_allclose(outs.x_est, single.x_est.numpy(), rtol=0, atol=2e-3)
    np.testing.assert_array_equal(outs.x_true, single.x_true.numpy())
    np.testing.assert_allclose(outs.x_true, valet["x_true"], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(outs.n_active, valet["n_active"])
    np.testing.assert_array_equal(outs.done, valet["done"])
    np.testing.assert_allclose(outs.consistency, single.consistency.numpy(), rtol=2e-2, atol=1e-3)
    assert int(res[0]["n_active"]) == int(valet["n_active"][-1]) > 0


def test_sharded_run_legacy_route_and_i16_wire(pools, valet):
    # fast_frame=False (per sub-step predict + heading, the batched update)
    # against the port's single-device loop on the same route.  The i16
    # gain wire has no reference bound: its P downdate takes the decoded
    # strip (element error up to 1.5e-5 of its row's scale) frame after
    # frame, and its mean drifts from the f32 wire's by ~2e-3 m over these
    # 600 steps; it is held to the same map and course end, and within
    # 1e-2 m of the f32 run, a fortieth of the course's ATE (0.39 m).
    legacy = SlamConfig(fast_frame=False)
    res = pools(2).run(tasks.run_sharded, {"state": 2}, valet["world"], legacy, N_STEPS, None,
                       valet["ctrl"], valet["obs"])
    _same_bits(res, "outs")
    _, single = _single(valet, legacy)
    np.testing.assert_allclose(res[0]["outs"].x_est, single.x_est.numpy(), rtol=0, atol=2e-3)
    np.testing.assert_array_equal(res[0]["outs"].n_active, single.n_active.numpy())
    i16 = pools(2).run(tasks.run_sharded, {"state": 2}, valet["world"],
                       SlamConfig(dist_gain_wire="i16"), N_STEPS, None, valet["ctrl"],
                       valet["obs"])
    _same_bits(i16, "outs")
    _, f32 = _single(valet, SlamConfig())
    drift = np.abs(i16[0]["outs"].x_est - f32.x_est.numpy()).max()
    print(f"i16 gain wire: x_est {drift:.3e} m from the f32 run over {N_STEPS} steps")
    assert np.isfinite(i16[0]["outs"].x_est).all() and drift < 1e-2
    np.testing.assert_array_equal(i16[0]["outs"].n_active, valet["n_active"])
    np.testing.assert_array_equal(i16[0]["outs"].done, valet["done"])


def test_dry_run_at_four_ranks(capsys):
    from conan_slam_tpu_torch.parallel import dryrun

    res = dryrun.dryrun_multichip(4, device="cpu")
    assert res["mesh"] == {"state": 2, "particles": 2}
    assert res["d_padded"] == 528 and res["particles"] == 16384
    assert "dryrun_multichip ok: mesh={'state': 2, 'particles': 2}" in capsys.readouterr().out


def test_dcn_smoke_over_tcp(capsys):
    from conan_slam_tpu_torch.benchmarks import dcn_smoke

    assert dcn_smoke.main(["--ranks", "2", "--device", "cpu"]) == 0
    assert '"ok": true' in capsys.readouterr().out


def _hlo_audit():
    spec = importlib.util.spec_from_file_location(
        "reference_audit", os.path.join(REPO, "benchmarks", "audit_collectives.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.audit_hlo


@pytest.mark.parametrize("n", [2, 4])
def test_audit_bytes_equal_the_reference_hlo(pools, n):
    # Each sharded function's collective bytes, as the port's mesh records
    # them (logical: an all-gather's or an all-reduce's output), against the
    # reference's HLO audit (benchmarks/audit_collectives.py audit_hlo) of
    # the same function compiled on a mesh of n devices, at the same shape
    # (K 30 padded to Dp 64, NZ 8): the collectives of its shard_map kernel
    # equal.  Outside its kernel the observation update's operator reads the
    # sharded mean replicated: the reference's partitioner gathers the
    # slices it reads (the pose, the features: fewer than Dp floats, in
    # small permutes and all-reduces, some of which XLA's combiner folds
    # into the kernel's all-reduce), where the port gathers the whole mean
    # once (4 Dp bytes); there the kernel's two collectives are held by
    # shape, (m, m) reduced and (m, Dp) gathered, and the rest to 4 Dp.
    audit_hlo = _hlo_audit()
    rng = np.random.default_rng(6)
    cap, nz = 30, 8
    d = 3 + 2 * cap
    a = rng.normal(size=(d, d)).astype(np.float32) * 0.05
    p0 = a @ a.T + np.eye(d, dtype=np.float32) * 0.1
    x0 = rng.uniform(-50, 50, size=(d,)).astype(np.float32)
    q = np.diag([0.18, 0.0006]).astype(np.float32)
    r = np.diag([0.08, 0.0024]).astype(np.float32)
    z = (rng.normal(size=(nz, 2)) * [10.0, 0.1] + [50.0, 0.0]).astype(np.float32)
    slots = np.arange(nz, dtype=np.int64)
    mask = np.ones((nz,), bool)
    s = 6
    frame = ((80.0 + rng.normal(size=s)).astype(np.float32),
             (rng.normal(size=s) * 0.03).astype(np.float32),
             (0.4 + np.cumsum(rng.normal(size=s) * 0.005)).astype(np.float32),
             np.ones((s,), bool), q, z, slots, mask, r, 73.0, 0.01, 0.000175, True)
    table = np.full((40,), -1, np.int64)
    h = rng.normal(size=(2 * nz, 64)).astype(np.float32)
    v = rng.normal(size=(2 * nz,)).astype(np.float32)
    rr = np.eye(2 * nz, dtype=np.float32) * 0.05
    cases = {
        "frame f32": (dist_fastframe.sharded_frame_update, frame, {},
                      jdist_ff.sharded_frame_update, {}),
        "frame i16": (dist_fastframe.sharded_frame_update, frame, {"gain_wire": "i16"},
                      jdist_ff.sharded_frame_update, {"gain_wire": "i16"}),
        "predict": (dist_ekf.sharded_predict, (80.0, 0.05, q, 73.0, 0.01), {},
                    jdist_ekf.sharded_predict, {}),
        "heading": (dist_ekf.sharded_observe_heading, (0.3, 0.001), {},
                    jdist_ekf.sharded_observe_heading, {}),
        "cholesky update": (dist_ekf.sharded_cholesky_update, (v, rr, h), {},
                            jdist_ekf.sharded_cholesky_update, {}),
        "observation update": (dist_ekf.sharded_observation_update, (z, slots, mask, r),
                               {"capacity": cap}, jdist_ekf.sharded_observation_update,
                               {"capacity": cap}),
        "augment": (dist_ekf.sharded_augment, (z, slots + 30, mask, r, np.asarray(0), table),
                    {}, jdist_ekf.sharded_augment, {}),
    }
    mesh = jmake_mesh({STATE_AXIS: n}, devices=jax.devices()[:n])
    xs, ps = jdist_ekf.shard_state(mesh, jnp.asarray(x0), jnp.asarray(p0))
    for name, (fn, args, kw, jfn, jkw) in cases.items():
        res = pools(n).run(tasks.state_steps, {"state": n}, x0, p0, [(fn, args, kw)])
        port = sum(c[4] for c in res[0]["collectives"])
        jargs = [jnp.asarray(a.astype(np.int32) if a.dtype == np.int64 else a)
                 if isinstance(a, np.ndarray) else a for a in args]
        hlo = jax.jit(lambda xs, ps: jfn(mesh, xs, ps, *jargs, **jkw)).lower(xs, ps).compile()
        lines = hlo.as_text().splitlines()
        kernel = sum(b for _, _, b in audit_hlo("\n".join(l for l in lines if "shard_map" in l)))
        outside = sum(b for _, _, b in audit_hlo("\n".join(l for l in lines
                                                             if "shard_map" not in l)))
        if name == "observation update":
            gather, psum, strip = res[0]["collectives"]
            assert gather[1] == "all_gather" and gather[4] == 4 * 64
            collective_lines = [l for l in lines if re.search(r"(all-reduce|all-gather)\(", l)]
            assert any("all-reduce(" in l and "f32[16,16]" in l for l in collective_lines)
            assert any("all-gather(" in l and "= f32[16,64]" in l for l in collective_lines)
            assert psum[4] == 16 * 16 * 4 and strip[4] == 16 * 64 * 4
            assert kernel + outside - psum[4] - strip[4] <= gather[4]
            continue
        assert outside == 0, name
        assert port == kernel, (name, res[0]["collectives"], audit_hlo(hlo.as_text()))
