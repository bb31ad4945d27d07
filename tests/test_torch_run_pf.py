"""Port parity for the FastSLAM 2.0 drivers (runner.loop.run_pf_slam,
pf_frame_step, pf_sim_step) against the JAX package on the reference's own
draws (rebuilt from PRNGKey(1)'s key schedule, tests/pf_reference.py): 600
steps at N = 16 on the default world, on the default route,
``fast_frame=False``, ``proposal_relinearize=True`` and systematic
resampling with roughening 0.02.

A PF run in float32 is not reproducible to the millimetre over 600 steps,
not even by the JAX package against itself: its own eager run of the same
function on the same key leaves its jitted run by up to 0.144 m, first past
1e-3 m at step 29 (``python tests/pf_spread.py``).  The pose covariances the
proposal inverts are near singular (its closed-form Cholesky cancels), so
two op orders put the features of the first frame ~1e-2 m apart and the
log weights of one frame ~0.1 apart, and resampling then picks other
ancestors.  So each frame (or control step) is held to the reference from
the reference's own state, and the whole run where it is exact:

  * each unit from the reference's carry (``test_each_frame_...``): x_true
    atol 1e-4 m (the same truth chain in two libms; observed 4e-6); the
    map size and the course's end equal; x_est atol 2e-3 m, the slice's
    bound; Neff after the frame rtol 5e-2 (the log weights' float32
    conditioning: observed 3.0e-2, and the reference's eager run against its
    jitted one from the same state differs by as much, tests/pf_spread.py);
    the port's ancestor indices on the reference's own normalised weights
    and uniforms equal the reference's.  Where the port's own weights put
    a stratum on the other side of a cumulative-weight boundary (or Neff on
    the other side of the threshold), the flip is reported with its frame
    and its margin |u - cum|, required to lie within the two packages'
    weight difference there, and the frame is held at the same bounds with
    the reference's ancestors;
  * the whole run (``test_run_pf_slam_...``): x_true atol 1e-4 m, the map
    size at every step and the course's end equal, Neff in (0, N], at least
    one resample fired in both runs; the largest |x_est - reference| is
    reported, not held (the runs are different realizations after the first
    flip or ~1e-2 m of map drift).
"""

import jax
import numpy as np
import pytest
import torch

from conan_slam_tpu.config import SlamConfig as JSlamConfig
from conan_slam_tpu.runner.loop import run_pf_slam as j_run_pf_slam
from conan_slam_tpu.sim.world import default_world as j_default_world
from conan_slam_tpu_torch.config import SlamConfig
from conan_slam_tpu_torch.filters import pf
from conan_slam_tpu_torch.filters.pf.recording import recording, resampling_flip
from conan_slam_tpu_torch.runner import loop
from conan_slam_tpu_torch.sim.world import default_world
from pf_reference import (
    DATA,
    FIELDS,
    PARTICLES,
    file_draws,
    pf_draws,
    reference_units,
    torch_carry,
    torch_draws,
)

torch.set_num_threads(2)

N, N_STEPS = 16, 600
ROUTES = {"default": {}, "fast_frame=False": dict(fast_frame=False),
          "proposal_relinearize=True": dict(proposal_relinearize=True),
          "systematic, roughening": dict(pf_resample_kind="systematic", pf_roughening=0.02)}
X_TRUE_ATOL, X_EST_ATOL, NEFF_RTOL = 1e-4, 2e-3, 5e-2


@pytest.fixture(scope="module", params=list(ROUTES))
def route(request):
    """The route's config, the reference's units (each frame or step's
    carry before it, outputs and resampling) and its draws as the port
    takes them."""
    kw = dict(num_particles=N, **ROUTES[request.param])
    jcfg, cfg = JSlamConfig(**kw), SlamConfig(**kw)
    key = jax.random.PRNGKey(1)
    n_units = N_STEPS if not cfg.fast_frame else N_STEPS // cfg.observe_interval
    units = reference_units(key, jcfg, n_units)
    draws = torch_draws(pf_draws(key, jcfg, n_units, j_default_world().num_landmarks))
    return request.param, cfg, units, draws


def _flip(unit: int, seen: dict, res: dict, thr: float):
    """The resampling flip of ``unit`` (or None): the decision, or the
    ancestors, that the port's weights give against the reference's, each
    as ``(what, margin, difference)`` (``resampling_flip``)."""
    ref = dict(w=torch.as_tensor(res["w"]), neff=float(res["neff"]),
               idx=torch.as_tensor(res["idx"]).long(), gate=True)
    what = resampling_flip(seen, ref, thr)
    return (unit, what) if what else None


def test_each_frame_from_the_reference_state(route):
    name, cfg, units, draws = route
    world, noise = default_world(device="cpu"), loop.make_noise(cfg, "pf", "cpu")
    step = loop.pf_frame_step if cfg.fast_frame else loop.pf_sim_step
    thr, flips, worst = cfg.num_effective, [], dict(x_true=0.0, x_est=0.0, neff=0.0)
    for u, (before, ref, res) in enumerate(units):
        seen: dict = {}
        kw = dict(cfg=cfg, world=world, noise=noise)
        carry, out = step(torch_carry(before), draws(u), resample_fn=recording(seen), **kw)
        # The reference resamples where something is known, the port's gate.
        assert seen["gate"] == (res is not None), u
        if res is not None:
            pick = pf.systematic_indices if cfg.pf_resample_kind == "systematic" \
                else pf.stratified_indices
            np.testing.assert_array_equal(
                pick(seen["u"], torch.as_tensor(res["w"]), N).numpy(), res["idx"])
            flip = _flip(u, seen, res, thr)
            if flip is not None:
                flips.append(flip)
                assert all(m <= d for _, m, d in flip[1]), flip
                force = (torch.as_tensor(res["idx"]).long(), bool(res["neff"] < thr))
                carry, out = step(torch_carry(before), draws(u), resample_fn=recording({}, force),
                                  **kw)
        np.testing.assert_array_equal(out.done.numpy(), ref.done)
        np.testing.assert_array_equal(out.n_active.numpy(), ref.n_active)
        d = dict(x_true=np.abs(out.x_true.numpy() - ref.x_true).max(),
                 x_est=np.abs(out.x_est.numpy() - ref.x_est).max(),
                 neff=float(np.max(np.abs(out.consistency.numpy() - ref.consistency)
                                   / np.maximum(np.abs(ref.consistency), 1e-30))))
        worst = {k: max(v, d[k]) for k, v in worst.items()}
        assert d["x_true"] <= X_TRUE_ATOL and d["x_est"] <= X_EST_ATOL \
            and d["neff"] <= NEFF_RTOL, (name, u, d, flips)
    for unit, what in flips:
        print(f"{name}: unit {unit}: resampling flip: " + ", ".join(
            f"{w} missed by {m:.2e}, the packages' weights differ by {d:.2e}" for w, m, d in what))
    print(f"{name}: {len(units)} units, {len(flips)} flips, worst {worst}")


def test_run_pf_slam_on_the_reference_draws(route):
    name, cfg, units, draws = route
    fired = []

    def counting(ens, *a, **kw):
        seen: dict = {}
        out = recording(seen)(ens, *a, **kw)
        fired.append(seen["gate"] and seen["neff"] < cfg.num_effective)
        return out

    carry, outs = loop.run_pf_slam(default_world(device="cpu"), cfg, None, N_STEPS,
                                   draws=draws, resample_fn=counting)
    ref = {k: np.concatenate([np.reshape(getattr(o, k), (-1,) + getattr(outs, k).shape[1:])
                              for _, o, _ in units]) for k in outs._fields}
    assert outs.x_est.shape == (N_STEPS, 3)
    np.testing.assert_allclose(outs.x_true.numpy(), ref["x_true"], rtol=0, atol=X_TRUE_ATOL)
    np.testing.assert_array_equal(outs.done.numpy(), ref["done"])
    np.testing.assert_array_equal(outs.n_active.numpy(), ref["n_active"])
    assert bool(torch.isfinite(outs.x_est).all()) and bool(torch.isfinite(carry.ens.log_w).all())
    neff = outs.consistency[outs.consistency != 0]
    assert bool(((neff > 0) & (neff <= N * (1 + 1e-6))).all())
    assert any(fired), "no resample fired in the port's run"
    assert any(r is not None and r["neff"] < cfg.num_effective for _, _, r in units)
    dx = np.abs(outs.x_est.numpy() - ref["x_est"]).max(1)
    past = np.flatnonzero(dx > 1e-3)
    print(f"{name}: {sum(fired)} resamples; max |x_est - reference| {dx.max():.3e} m, first "
          f"step past 1e-3 m: {past[0] if past.size else None}")


def test_reference_file_holds_the_reference_runs():
    # pf_key1.npz against the JAX package: the draws rebuilt from the key
    # schedule bit for bit, and run_pf_slam's outputs at each N; the port
    # on the file's draws runs the N = 100 course with the reference's map
    # sizes and truth.
    data = np.load(DATA)
    key, world = jax.random.PRNGKey(1), j_default_world()
    for n in PARTICLES:
        jcfg = JSlamConfig(num_particles=n)
        n_steps = data["x_true"].shape[0]
        d = pf_draws(key, jcfg, n_steps // jcfg.observe_interval, world.num_landmarks)
        got = file_draws(data, n)
        assert set(got) == set(d) == set(FIELDS) - {"rough"}
        for k in d:
            np.testing.assert_array_equal(got[k], d[k])
        _, outs = j_run_pf_slam(world, jcfg, key, n_steps=n_steps)
        np.testing.assert_allclose(np.asarray(outs.x_true), data["x_true"], rtol=0, atol=1e-6)
        np.testing.assert_allclose(np.asarray(outs.x_est), data[f"x_est_{n}"], rtol=0, atol=1e-6)
        np.testing.assert_allclose(np.asarray(outs.consistency), data[f"neff_{n}"], rtol=1e-6)
        np.testing.assert_array_equal(np.asarray(outs.n_active), data[f"n_active_{n}"])
    _, outs = loop.run_pf_slam(default_world(device="cpu"), SlamConfig(num_particles=100), None,
                               data["x_true"].shape[0], draws=torch_draws(file_draws(data, 100)))
    np.testing.assert_allclose(outs.x_true.numpy(), data["x_true"], rtol=0, atol=X_TRUE_ATOL)
    np.testing.assert_array_equal(outs.n_active.numpy(), data["n_active_100"])
