"""The CUDA kernels against their plain PyTorch versions, on a card.

These tests need an NVIDIA GPU (sm_90a, nvcc on PATH or under CUDA_HOME):
the kernels have no CPU mode, so without a card they skip.  Run them with

    python -m pytest -m cuda tests/test_torch_cuda.py -q

No JAX here: the machine with the card need not have it.  Tolerances
follow the reference's frame test (pose 1e-5, x 1e-4, P rtol 1e-3 /
atol 1e-4, NIS rtol 1e-3); kernel and plain version differ only in fp32
summation order and FMA contraction.
"""

import numpy as np
import pytest
import torch

from conan_slam_tpu_torch.filters.ekf import init_state_with_map
from conan_slam_tpu_torch.ops import cuda, frame_kernel as fk
from conan_slam_tpu_torch.ops.rank_update import rank_update_t, rank_update_t_reference
from conan_slam_tpu_torch.ops.spd_inverse import (
    spd_inverse,
    spd_inverse_reference,
    sweep_si,
    sweep_si_reference,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _frame_args(dev, d, seed=79, nz=10):
    rng = np.random.default_rng(seed)
    cap = (d - 3) // 2
    lm = rng.uniform(-50, 50, size=(cap, 2)).astype(np.float32)
    st = init_state_with_map(torch.as_tensor(lm), sigma0=0.5, pad_multiple=128 if d % 128 == 0 else 0)
    assert st.x.shape[0] == d
    a = rng.normal(size=(d, 8)).astype(np.float32) * 0.05
    ids = rng.choice(cap, size=nz, replace=False)
    z = np.stack([np.hypot(lm[ids, 0], lm[ids, 1]) + rng.normal(size=nz) * 0.1,
                  np.arctan2(lm[ids, 1], lm[ids, 0]) + rng.normal(size=nz) * 0.01], -1)
    mask = np.ones(nz, bool)
    mask[-2] = False
    t = lambda v: torch.as_tensor(np.asarray(v)).to(dev)  # noqa: E731
    return (
        (st.p + torch.as_tensor(a @ a.T)).to(dev), st.x.to(dev),
        t(np.concatenate([np.arange(3), (3 + 2 * ids[:, None] + np.arange(2)).reshape(-1)])),
        t((83.33 + rng.normal(size=6) * 0.3).astype(np.float32)),
        t((rng.normal(size=6) * 0.2).astype(np.float32)),
        t((rng.normal(size=6) * 0.5).astype(np.float32)),
        t(np.array([1, 1, 1, 1, 1, 0], bool)),
        t(np.diag([0.3**2, (np.pi / 180) ** 2]).astype(np.float32)),
        t(z[:, 0].astype(np.float32)), t(z[:, 1].astype(np.float32)), t(mask),
        t(np.diag([0.1**2, 0.5 * np.pi / 180]).astype(np.float32)),
        73.0, 0.01, 0.01 * np.pi / 180, True,
    )


@pytest.mark.parametrize("d", [256, 203])
def test_frame_kernels_match_plain_versions(dev, d):
    args = _frame_args(dev, d)
    cuda.reset_launch_counts()
    got = fk.frame_step(*args)
    ref = fk.frame_step(*args, plain=True)
    torch.cuda.synchronize()
    assert {k.name: k.launches for k in cuda.KERNELS.values()} == {
        "sweep_inverse": 1, "frame_chain": 1, "frame_panels": 1, "rank_update": 1}
    torch.testing.assert_close(got.pose_trace, ref.pose_trace, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got.x, ref.x, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got.p, ref.p, rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(got.nis, ref.nis, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("nblk", [7, 40, 64])
def test_sweep_inverse_kernel_matches_plain(dev, nblk):
    g = torch.Generator(device=dev).manual_seed(nblk)
    a = torch.randn((128, 128), generator=g, device=dev)
    s = a @ a.T / 128 + torch.eye(128, device=dev)
    nb = torch.tensor([nblk], dtype=torch.int32, device=dev)
    got = sweep_si(s, nb)
    torch.cuda.synchronize()
    # Same sweep; fp32 contraction differs: a few ulps of |S^-1| ~ 1.
    torch.testing.assert_close(got, sweep_si_reference(s, nb), rtol=1e-4, atol=1e-5)
    assert torch.equal(got, got.T)


def test_spd_inverse_kernel_odd_size_and_guard(dev):
    g = torch.Generator(device=dev).manual_seed(3)
    a = torch.randn((61, 61), generator=g, device=dev)
    s = a @ a.T / 61 + torch.eye(61, device=dev)
    torch.testing.assert_close(spd_inverse(s), spd_inverse_reference(s), rtol=1e-3, atol=1e-4)
    bad = torch.full((8, 8), float("nan"), device=dev)
    assert torch.equal(spd_inverse(bad), torch.zeros_like(bad))


@pytest.mark.parametrize("d", [256, 203])
def test_rank_update_kernel_matches_plain(dev, d):
    g = torch.Generator(device=dev).manual_seed(d)
    p = torch.randn((d, d), generator=g, device=dev)
    vt = torch.randn((40, d), generator=g, device=dev)
    b = torch.randn((40, 40), generator=g, device=dev)
    # fp32 sums of 40 O(1) products, in another order than cuBLAS.
    torch.testing.assert_close(rank_update_t(p, vt, b), rank_update_t_reference(p, vt, b),
                               rtol=1e-4, atol=1e-4)


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    p = torch.randn((64, 64), device=dev)
    vt = torch.randn((8, 64), device=dev)
    b = torch.randn((8, 8), device=dev)
    with pytest.raises(ValueError):
        rank_update_t(p.double(), vt.double(), b.double())
    with pytest.raises(ValueError):
        rank_update_t(p.T, vt, b)                       # not contiguous
    with pytest.raises(ValueError):
        sweep_si(p, torch.tensor([4], device=dev))      # nblk must be int32
