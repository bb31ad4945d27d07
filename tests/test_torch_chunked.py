"""The chunked, checkpointed driver (runner.loop.
run_ekf_slam_precomputed_chunked) and utils.checkpoint against the JAX
reference and against themselves, and the constructors' default device.

Tolerances, each with its reason:
  * chunked against the reference's chunked driver, fed its per-chunk
    ``fold_in`` draws: those of tests/test_torch_slice.py (pose trace and
    final pose atol 2e-3 m, map means 2e-2 m, P 1e-4, NIS rtol 2e-2 / atol
    1e-3): float32 ulps of ~5 km positions in two packages' op orders.
    ATE atol 2.9e-3 m, the most the pose-trace bound lets an RMS of
    position errors move (sqrt(2) 2e-3); at this run's ATE of ~0.05 m the
    slice test's rtol 1e-2 would be tighter than the trace bound.
  * chunked against one-shot: another noise realisation, so only the same
    truth and |dATE| < 0.5 m (the reference's own test, tests/test_ekf.py).
  * a checkpoint round trip, and a killed and resumed run against an
    uninterrupted one: bit-equal (the same float32 values copied, the same
    deterministic CPU arithmetic after them).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conan_slam_tpu.config import SlamConfig as JSlamConfig
from conan_slam_tpu.filters.ekf import init_state_with_map as j_init_state_with_map
from conan_slam_tpu.runner import metrics as jmetrics
from conan_slam_tpu.runner.loop import run_ekf_slam_precomputed_chunked as j_run_chunked
from conan_slam_tpu.sim.world import default_world as j_default_world
from conan_slam_tpu_torch import device as device_mod
from conan_slam_tpu_torch.config import SlamConfig
from conan_slam_tpu_torch.filters.ekf import (
    init_state,
    init_state_with_map,
    state_from_numpy,
)
from conan_slam_tpu_torch.runner import loop
from conan_slam_tpu_torch.runner.metrics import ate_rmse
from conan_slam_tpu_torch.sim import world as world_mod
from conan_slam_tpu_torch.utils import checkpoint

torch.set_num_threads(2)

N_STEPS, CHUNK = 1200, 420       # chunks of 70, 70 and 60 frames: a ragged tail


def _known(frame_pair=True):
    world = world_mod.default_world(device="cpu")
    cfg = SlamConfig(max_landmarks=30, max_obs=16, enable_augment=False, frame_pair=frame_pair)
    return world, cfg, init_state_with_map(world.landmarks), loop.precompute_rollout(
        world, cfg, N_STEPS)


def _assert_equal(a, b):
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_checkpoint_round_trip(tmp_path):
    world, cfg, state0, roll = _known()
    part = (tuple(a[:60] for a in roll[0]), tuple(a[:10] for a in roll[1]))
    state, outs = loop.run_ekf_slam_precomputed(world, cfg, torch.Generator().manual_seed(1),
                                                60, state0, part)
    path = os.path.join(tmp_path, "ckpt.pt")
    checkpoint.save(path, {"state": state, "outs": outs})
    checkpoint.save(path, {"state": state, "outs": outs})          # overwrites
    template = {"state": init_state(30, 30, device="cpu"), "outs": loop._outs_like(60, "cpu")}
    template["state"] = template["state"]._replace(n_active=torch.zeros((), dtype=torch.int32))
    restored = checkpoint.restore(path, template)
    assert restored["state"].n_active.dtype == torch.int32          # the template's dtype
    assert int(restored["state"].n_active) == int(state.n_active)
    restored["state"] = restored["state"]._replace(n_active=state.n_active)
    _assert_equal(restored, {"state": state, "outs": outs})
    with pytest.raises(ValueError):
        checkpoint.restore(path, {"state": state, "outs": loop._outs_like(66, "cpu")})


def test_chunked_matches_reference():
    # Known association, frame pairs, a ragged tail chunk: each chunk runs
    # the pair (70, 70 and 60 frames), the reference's chunks two frames
    # at a time on the CPU.
    world, cfg, state0, roll = _known()
    jworld = j_default_world()
    jcfg = JSlamConfig(max_landmarks=30, max_obs=16, enable_augment=False, frame_pair=True)
    key = jax.random.PRNGKey(11)
    jroll = tuple(tuple(jnp.asarray(a.numpy()) for a in part) for part in roll)
    jstate, jouts = j_run_chunked(jworld, jcfg, key, N_STEPS, CHUNK,
                                  j_init_state_with_map(jworld.landmarks, sigma0=1.0), jroll)
    # The reference draws chunk c's noise from fold_in(key, c) inside
    # _run_precomp (runner/loop.py:292-294, 527).
    ctrl, obsn = [], []
    for c, s0 in enumerate(range(0, N_STEPS, CHUNK)):
        nf = (min(s0 + CHUNK, N_STEPS) - s0) // cfg.observe_interval
        k_ctrl, k_obs = jax.random.split(jax.random.fold_in(key, c))
        ctrl.append(np.array(jax.random.normal(k_ctrl, (nf, cfg.observe_interval, 2))))
        obsn.append(np.array(jax.random.normal(k_obs, (nf, 16, 2))))
    state, outs = loop.run_ekf_slam_precomputed_chunked(
        world, cfg, 11, N_STEPS, CHUNK, state0, roll,
        ctrl_noise=torch.as_tensor(np.concatenate(ctrl)),
        obs_noise=torch.as_tensor(np.concatenate(obsn)))
    np.testing.assert_array_equal(outs.x_true.numpy(), np.asarray(jouts.x_true))
    np.testing.assert_allclose(outs.x_est.numpy(), np.asarray(jouts.x_est), rtol=0, atol=2e-3)
    np.testing.assert_allclose(state.x.numpy()[:3], np.asarray(jstate.x)[:3], rtol=0, atol=2e-3)
    np.testing.assert_allclose(state.x.numpy(), np.asarray(jstate.x), rtol=0, atol=2e-2)
    np.testing.assert_allclose(state.p.numpy(), np.asarray(jstate.p), rtol=0, atol=1e-4)
    np.testing.assert_allclose(outs.consistency.numpy(), np.asarray(jouts.consistency),
                               rtol=2e-2, atol=1e-3)
    np.testing.assert_array_equal(outs.n_active.numpy(), np.asarray(jouts.n_active))
    np.testing.assert_allclose(float(ate_rmse(outs.x_true, outs.x_est, ~outs.done)),
                               float(jmetrics.ate_rmse(jouts.x_true, jouts.x_est, ~jouts.done)),
                               rtol=0, atol=2.9e-3)


def test_chunked_matches_one_shot():
    world, cfg, state0, roll = _known()
    _, one = loop.run_ekf_slam_precomputed(world, cfg, torch.Generator().manual_seed(5),
                                           N_STEPS, state0, roll)
    _, chunked = loop.run_ekf_slam_precomputed_chunked(world, cfg, 5, N_STEPS, CHUNK, state0,
                                                       roll)
    assert chunked.x_est.shape == one.x_est.shape
    assert torch.equal(chunked.x_true, one.x_true)
    a1 = float(ate_rmse(one.x_true, one.x_est, ~one.done))
    a2 = float(ate_rmse(chunked.x_true, chunked.x_est, ~chunked.done))
    assert np.isfinite(a2) and abs(a1 - a2) < 0.5, (a1, a2)


def test_chunked_refuses_a_short_rollout():
    world, cfg, state0, roll = _known()
    short_truth = (tuple(a[:600] for a in roll[0]), roll[1])
    short_obs = (roll[0], tuple(a[:60] for a in roll[1]))
    for part in (short_truth, short_obs):
        with pytest.raises(ValueError):
            loop.run_ekf_slam_precomputed_chunked(world, cfg, 0, N_STEPS, CHUNK, state0, part)


_DRIVER = loop.run_ekf_slam_precomputed


class _Killed(Exception):
    pass


def _counting_driver(monkeypatch, kill_at=None):
    """Count the chunks the chunked driver runs; raise ``_Killed`` inside
    chunk ``kill_at`` (a process killed mid-chunk, its earlier checkpoints
    left behind)."""
    runs = []

    def driver(*args, **kwargs):
        runs.append(args[3])
        if len(runs) - 1 == kill_at:
            raise _Killed
        return _DRIVER(*args, **kwargs)

    monkeypatch.setattr(loop, "run_ekf_slam_precomputed", driver)
    return runs


@pytest.mark.parametrize("frame_pair", [False, True])
def test_kill_and_resume_is_bit_identical(frame_pair, tmp_path, monkeypatch):
    world, cfg, state0, roll = _known(frame_pair)
    ref = loop.run_ekf_slam_precomputed_chunked(world, cfg, 7, N_STEPS, CHUNK, state0, roll)
    ckpt = os.path.join(tmp_path, "run")
    _counting_driver(monkeypatch, kill_at=2)
    with pytest.raises(_Killed):
        loop.run_ekf_slam_precomputed_chunked(world, cfg, 7, N_STEPS, CHUNK, state0, roll, ckpt)
    assert sorted(os.listdir(ckpt)) == ["chunk_00000.meta.json", "chunk_00000.pt",
                                        "chunk_00001.meta.json", "chunk_00001.pt"]
    runs = _counting_driver(monkeypatch)
    resumed = loop.run_ekf_slam_precomputed_chunked(world, cfg, 7, N_STEPS, CHUNK, state0,
                                                    roll, ckpt)
    assert runs == [N_STEPS - 2 * CHUNK]          # only the third chunk ran
    _assert_equal(resumed, ref)


@pytest.mark.parametrize("case", ["meta_without_run_id", "another_horizon"])
def test_checkpoints_of_another_run_are_not_resumed(case, tmp_path, monkeypatch):
    # A chunk is resumed only when its meta holds this run's id.  The
    # reference takes a meta without one as a match (runner/loop.py:506);
    # the port does not.  A run over another horizon has another id: its
    # chunks are not resumed even where their bounds agree.
    world, cfg, state0, roll = _known()
    ckpt = os.path.join(tmp_path, "run")
    n_steps = N_STEPS if case == "meta_without_run_id" else 2 * CHUNK
    first = loop.run_ekf_slam_precomputed_chunked(world, cfg, 7, n_steps, CHUNK, state0, roll,
                                                  ckpt)
    if case == "meta_without_run_id":
        for c in range(3):
            path = os.path.join(ckpt, f"chunk_{c:05d}.meta.json")
            with open(path) as f:
                meta = json.load(f)
            del meta["run_id"]
            with open(path, "w") as f:
                json.dump(meta, f)
    runs = _counting_driver(monkeypatch)
    again = loop.run_ekf_slam_precomputed_chunked(world, cfg, 7, N_STEPS, CHUNK, state0, roll,
                                                  ckpt)
    assert runs == [CHUNK, CHUNK, N_STEPS - 2 * CHUNK]
    if case == "meta_without_run_id":
        _assert_equal(again, first)


@pytest.mark.parametrize("make", [
    lambda: world_mod.default_world(),
    lambda: world_mod.config2_world(),
    lambda: world_mod.world_from_numpy(np.zeros((3, 2)), np.zeros((2, 2))),
    lambda: init_state(4, 4),
    lambda: init_state_with_map(np.zeros((4, 2), np.float32)),
    lambda: state_from_numpy(np.zeros(5), np.zeros((5, 5)), 1, np.zeros(1)),
    lambda: loop.make_noise(SlamConfig()),
    lambda: world_mod.random_world(torch.Generator().manual_seed(0), 4),
    lambda: loop.init_steer_state(1),
    lambda: loop.carry_from_numpy((0.0, 0, 1, False), np.zeros(3), (np.zeros(5), np.zeros((5, 5)),
                                                                   1, np.zeros(1)), 0),
], ids=["default_world", "config2_world", "world_from_numpy", "init_state",
        "init_state_with_map", "state_from_numpy", "make_noise", "random_world",
        "init_steer_state", "carry_from_numpy"])
def test_constructors_default_to_the_card(make, monkeypatch):
    # With no device named, a constructor puts its tensors on the card; on
    # a machine without one it raises and returns no CPU tensors.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert device_mod.default_device() == torch.device("cuda")
