"""The comparison fails what it has to: the control (the plain reference in
TF32 in the program's place) and the faults a run of these cells can have,
each driven through a whole run with the timed path broken underneath.
One card runs no exchange between chips, so that fault has no case here."""

import time

import pytest
import torch

from conan_slam_tpu_torch.runner import loop
from portbench import control, harness
from portbench.tests.tiny import tiny


def _run(program, config="ekf_known"):
    traffic = tiny(config)
    return harness.run("tiny", 31, 0.01, False, device=torch.device("cpu"), program=program,
                       traffic=traffic, cache_dir=None)


def _nums(config="ekf_known"):
    return harness.filter_numbers(harness.load("configs", config))


def unchanged(world, cfg, gen, n_steps, state, part, **kw):
    """A request that returns its state unchanged (after a millisecond, so
    that the window does not outrun the tiny cell's log)."""
    time.sleep(1e-3)
    x_est = state.x[:3].expand(n_steps, 3).clone()
    return state, loop.SimOutputs(x_true=part[0][0], x_est=x_est, done=part[0][3],
                                  n_active=state.n_active.expand(n_steps).clone(),
                                  consistency=torch.zeros(n_steps))


def half_batch(world, cfg, gen, n_steps, state, part, **kw):
    """Every other return left out of each frame's update."""
    (truth, (z, ids, mask)) = part
    mask = mask.clone()
    mask[:, 1::2] = False
    return loop.run_ekf_slam_precomputed(world, cfg, gen, n_steps, state, (truth, (z, ids, mask)),
                                         **kw)


def altered(world, cfg, gen, n_steps, state, part, **kw):
    """The answer altered where it is produced: the request's last pose
    5 cm off."""
    state, outs = loop.run_ekf_slam_precomputed(world, cfg, gen, n_steps, state, part, **kw)
    outs.x_est[-1, 0] += 0.05
    return state, outs


def test_sound_run_is_correct():
    assert _run(None)["correct"] is True


@pytest.mark.parametrize("fault", [unchanged, half_batch, altered], ids=lambda f: f.__name__)
def test_fault_is_caught(fault):
    assert _run(fault)["correct"] is False


def test_control_is_not_correct():
    res = _run(control.driver(_nums(), "tf32"))
    assert res["correct"] is False
    assert res["checks"]["cov_gap"]["value"] > res["checks"]["cov_gap"]["limit"]


def test_control_in_float64_is_correct():
    """The reference in the program's place at its own precision passes:
    the control fails by its precision alone."""
    assert _run(control.driver(_nums(), "float64"))["correct"] is True
