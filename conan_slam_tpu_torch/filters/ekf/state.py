"""Static-capacity EKF-SLAM state (port of conan_slam_tpu.filters.ekf.state).

The joint state is pre-allocated at capacity ``K`` map slots (D = 3 + 2K,
optionally rounded up by ``pad_multiple`` exactly as the reference does, so
a state carried across from the JAX package keeps its shape), with an
active-slot count and a landmark-id -> slot table (-1 = unknown).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from conan_slam_tpu_torch.device import default_device


class EKFState(NamedTuple):
    x: torch.Tensor         # (D,) joint mean: pose (x, y, phi) then map slots
    p: torch.Tensor         # (D, D) joint covariance
    n_active: torch.Tensor  # () int64 number of active map slots
    table: torch.Tensor     # (num_landmark_ids,) int64 id -> slot, -1 unknown

    @property
    def capacity(self) -> int:
        return (self.x.shape[0] - 3) // 2

    @property
    def pose(self) -> torch.Tensor:
        return self.x[:3]

    @property
    def features(self) -> torch.Tensor:
        """Map slot positions as a (K, 2) view of the mean."""
        k = self.capacity
        return self.x[3 : 3 + 2 * k].view(k, 2)

    @property
    def active_mask(self) -> torch.Tensor:
        """(K,) bool mask of the active slots."""
        return torch.arange(self.capacity, device=self.x.device) < self.n_active


def _padded_dim(capacity: int, pad_multiple: int) -> int:
    d = 3 + 2 * capacity
    if pad_multiple and d > pad_multiple:
        d = ((d + pad_multiple - 1) // pad_multiple) * pad_multiple
    return d


def init_state(capacity: int, num_landmark_ids: int, dtype=torch.float32,
               pad_multiple: int = 256, device=None) -> EKFState:
    """Zero pose, zero covariance, empty map (reference test/main.cpp:106-108),
    on ``device`` (default: the card)."""
    device = default_device() if device is None else device
    d = _padded_dim(capacity, pad_multiple)
    return EKFState(
        x=torch.zeros((d,), dtype=dtype, device=device),
        p=torch.zeros((d, d), dtype=dtype, device=device),
        n_active=torch.zeros((), dtype=torch.int64, device=device),
        table=torch.full((num_landmark_ids,), -1, dtype=torch.int64, device=device),
    )


def init_state_with_map(landmarks, capacity: int | None = None,
                        sigma0: float = 1.0, dtype=torch.float32,
                        pad_multiple: int = 256, device=None) -> EKFState:
    """Steady-state start: the first ``capacity`` landmarks pre-registered,
    each with an independent ``sigma0^2 I`` block.  The device defaults to
    the landmarks' where they are a tensor, else to the card."""
    if device is None:
        device = landmarks.device if torch.is_tensor(landmarks) else default_device()
    landmarks = torch.as_tensor(landmarks, dtype=dtype, device=device)
    n_ids = landmarks.shape[0]
    k = capacity if capacity is not None else n_ids
    n_map = min(n_ids, k)
    state = init_state(k, n_ids, dtype, pad_multiple=pad_multiple, device=device)
    x = state.x.clone()
    x[3 : 3 + 2 * n_map] = landmarks[:n_map].reshape(-1)
    diag = torch.zeros_like(x)
    diag[3 : 3 + 2 * n_map] = sigma0**2
    table = state.table.clone()
    table[:n_map] = torch.arange(n_map, device=device)
    return EKFState(
        x=x, p=torch.diag(diag),
        n_active=torch.full((), n_map, dtype=torch.int64, device=device),
        table=table,
    )


def state_from_numpy(x, p, n_active, table, device=None) -> EKFState:
    """A state from numpy arrays (e.g. a JAX state's ``np.asarray`` fields),
    on ``device`` (default: the card)."""
    device = default_device() if device is None else device
    return EKFState(
        x=torch.tensor(np.asarray(x, np.float32), device=device),
        p=torch.tensor(np.asarray(p, np.float32), device=device),
        n_active=torch.tensor(np.asarray(n_active, np.int64), device=device),
        table=torch.tensor(np.asarray(table, np.int64), device=device),
    )


def state_to_numpy(state: EKFState):
    """``(x, p, n_active, table)`` as numpy arrays in the JAX package's dtypes."""
    return (
        state.x.detach().cpu().numpy(),
        state.p.detach().cpu().numpy(),
        np.int32(state.n_active.item()),
        state.table.detach().cpu().numpy().astype(np.int32),
    )
