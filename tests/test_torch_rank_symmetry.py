"""The precondition of kernel H4 (ops/rank_update.py): every caller's
update Vt^T VBt is symmetric, so the kernel forms its upper triangle and
mirrors it.

Each caller of the port -- ``frame_step``'s split schedule (M =
blockdiag(-S^-1, K4); H9 passes the same G and M G to the same tiles),
``frame_update_obs`` (M = blockdiag(B, -S^-1)) and ``frame_step_pair`` (M =
blockdiag(M_A, M_B), VBt given) -- runs on the CPU through its plain
versions on inputs made from a numpy seed at D = 256; the (P, Vt, VBt) it
hands to H4 is captured.  Then:
  * Vt^T VBt is symmetric to within float32 rounding: |X - X^T| <= 4 r eps
    (B + B^T), B = |Vt|^T |M| |Vt| in float64, which bounds the rounding of
    VBt = M Vt and of both r-term sums;
  * P + mirror(triu(Vt^T VBt)), what the kernel computes, agrees with the
    JAX package's rank_update_t run in interpret mode (as
    tests/test_pallas_ops.py runs it), within the tolerance of
    tests/test_torch_ops.py::test_rank_update_t_matches_reference_kernel
    (rtol 1e-4, atol 1e-2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conan_slam_tpu.ops.pallas_update import rank_update_t as j_rank_update_t
from conan_slam_tpu_torch.filters.ekf import init_state_with_map
from conan_slam_tpu_torch.filters.ekf.state import EKFState
from conan_slam_tpu_torch.ops import frame_kernel as tfk
from conan_slam_tpu_torch.ops.factor_kernel import _frame_factors_reference

torch.set_num_threads(2)

TAIL = (73.0, 0.01, 0.01 * np.pi / 180, True)
EPS32 = float(np.finfo(np.float32).eps)


def _frame(rng, x, nz, capacity):
    """One frame's gathered rows, controls and measurements of ``nz`` mapped
    landmarks seen from the mean ``x``, at the sensors' noise scale."""
    ids = rng.choice(capacity, size=nz, replace=False)
    fx, fy = x[3 + 2 * ids] - x[0], x[4 + 2 * ids] - x[1]
    mask = np.ones(nz, bool)
    mask[rng.integers(nz)] = False
    f32 = np.float32
    rows = np.concatenate([np.arange(3), (3 + 2 * ids[:, None] + np.arange(2)).reshape(-1)])
    ctrl = ((rng.normal(size=6) * 0.3).astype(f32), (rng.normal(size=6) * 0.02).astype(f32),
            (x[2] + rng.normal(size=6) * TAIL[2]).astype(f32), np.array([1, 1, 1, 1, 1, 0], bool))
    meas = ((np.hypot(fx, fy) + rng.normal(size=nz) * 0.1).astype(f32),
            (np.arctan2(fy, fx) - x[2] + rng.normal(size=nz) * 0.01).astype(f32), mask)
    t = torch.as_tensor
    return t(rows), tuple(map(t, ctrl)), tuple(map(t, meas))


def _state(seed, capacity=100):
    """A frame-start state at D = 256 (a pad to a multiple of 128) with a
    dense, exactly symmetric covariance."""
    rng = np.random.default_rng(seed)
    lm = rng.uniform(-50, 50, size=(capacity, 2)).astype(np.float32)
    st = init_state_with_map(torch.as_tensor(lm), sigma0=0.5, pad_multiple=128, device="cpu")
    a = torch.as_tensor(rng.normal(size=(st.x.shape[0], 8)).astype(np.float32) * 0.05)
    q = torch.diag(torch.tensor([0.3**2, (np.pi / 180) ** 2]))
    r = torch.diag(torch.tensor([0.1**2, 0.5 * np.pi / 180]))
    return rng, st.p + a @ a.T, st.x, q, r


def _run_frame_step(seed):
    # The split schedule hands (G, M) to H4; H9 runs the same tile pass on
    # the same G and M G, formed inside its launch.
    rng, p, x, q, r = _state(seed)
    rows, ctrl, meas = _frame(rng, x.numpy(), 10, 100)
    tfk.frame_step(p, x, (rows[3::2] - 3) // 2, 100, *ctrl, q, *meas, r, *TAIL, schedule="split")


def _run_frame_update_obs(seed):
    rng, p, x, q, r = _state(seed)
    rows, ctrl, meas = _frame(rng, x.numpy(), 10, 100)
    st = EKFState(x=x, p=p, n_active=torch.tensor(100), table=torch.zeros(1, dtype=torch.int64))
    st1, _, vtf, bmat = _frame_factors_reference(st, *ctrl, q, *TAIL)
    # The split hands (G, M) to H4; H10 runs the same tile pass on the same
    # G = [vtf; pht] and M G, formed inside its launch.
    tfk.frame_update_obs(st1.p, st1.x, (rows[3::2] - 3) // 2, 100, *meas, r, bmat, vtf,
                         schedule="split")


def _run_frame_step_pair(seed):
    rng, p, x, q, r = _state(seed)
    rows_a, ctrl_a, meas_a = _frame(rng, x.numpy(), 10, 100)
    fa = tfk.frame_step(p, x, (rows_a[3::2] - 3) // 2, 100, *ctrl_a, q, *meas_a, r, *TAIL,
                        plain=True)
    rows_b, ctrl_b, meas_b = _frame(rng, fa.x.numpy(), 10, 100)
    tfk.frame_step_pair(p, x, rows_a, ctrl_a, meas_a, rows_b, ctrl_b, meas_b, q, r, *TAIL)


CALLERS = {"frame_step": (_run_frame_step, 61), "frame_update_obs": (_run_frame_update_obs, 67),
           "frame_step_pair": (_run_frame_step_pair, 71)}


def _capture(caller, monkeypatch):
    """``(P, Vt, VBt, M)`` as the caller hands them to H4 (M the symmetric
    middle factor: VBt = M Vt)."""
    run, seed = CALLERS[caller]
    seen, mids = {}, []
    gm = tfk._frame_gm

    def frame_gm(*args):
        gmat, mmid = gm(*args)
        mids.append(mmid)
        return gmat, mmid

    def rank_update_t(p, vt, b):
        seen.update(p=p, vt=vt, vbt=b @ vt, m=b)
        return tfk.rank_update_t_reference(p, vt, b)

    def rank_update_vbt(p, vt, vbt):
        seen.update(p=p, vt=vt, vbt=vbt, m=torch.block_diag(*mids[-2:]))   # M_A, M_B
        return tfk.rank_update_vbt_reference(p, vt, vbt)

    monkeypatch.setattr(tfk, "_frame_gm", frame_gm)
    monkeypatch.setattr(tfk, "rank_update_t", rank_update_t)
    monkeypatch.setattr(tfk, "rank_update_vbt", rank_update_vbt)
    run(seed)
    assert set(seen) == {"p", "vt", "vbt", "m"}, f"{caller} did not reach H4"
    return seen["p"], seen["vt"], seen["vbt"], seen["m"]


@pytest.mark.parametrize("caller", sorted(CALLERS))
def test_rank_update_is_symmetric_for_every_caller(caller, monkeypatch):
    p, vt, vbt, m = _capture(caller, monkeypatch)
    r = vt.shape[0]
    x = (vt.T @ vbt).double()
    vt64 = vt.double().abs()
    b = vt64.T @ m.double().abs() @ vt64
    tol = 4 * r * EPS32 * (b + b.T)
    err = (x - x.T).abs()
    assert bool((err <= tol).all()), (
        f"{caller}: |X - X^T| reaches {float(err.max()):.3e}, beyond 4 r eps (B + B^T)")


@pytest.mark.parametrize("caller", sorted(CALLERS))
def test_mirrored_upper_triangle_matches_reference_kernel(caller, monkeypatch):
    p, vt, vbt, m = _capture(caller, monkeypatch)
    x = vt.T @ vbt
    got = (p + torch.triu(x) + torch.triu(x, 1).T).numpy()
    ref = np.asarray(j_rank_update_t(jnp.asarray(p.numpy()), jnp.asarray(vt.numpy()),
                                     jnp.asarray(m.numpy()), interpret=True))
    # The reference kernel test's bound (float32 sums of ~r + d terms).
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-2)
