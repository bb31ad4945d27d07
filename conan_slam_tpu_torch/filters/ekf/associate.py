"""Known-table data association (port of
conan_slam_tpu.filters.ekf.associate.associate_known; reference
EKF::dataAssociateTable, EKF.cpp:169-182)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from conan_slam_tpu_torch.filters.common import CompactObs
from conan_slam_tpu_torch.filters.ekf.state import EKFState


class AssociationResult(NamedTuple):
    known_mask: torch.Tensor  # (NZ,) bool: measurement matched to an active slot
    slots: torch.Tensor       # (NZ,) int64 matched slot (valid where known_mask)
    new_mask: torch.Tensor    # (NZ,) bool: measurement should found a new feature


def associate_known(state: EKFState, obs: CompactObs) -> AssociationResult:
    """Ground-truth association via the id -> slot table."""
    slots = state.table[torch.clamp(obs.ids, min=0)]
    known = obs.mask & (slots >= 0)
    new = obs.mask & (slots < 0)
    return AssociationResult(
        known_mask=known, slots=torch.clamp(slots, min=0), new_mask=new
    )
