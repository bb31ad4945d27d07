"""Shared filter-side observation container (port of
conan_slam_tpu.filters.common)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class CompactObs(NamedTuple):
    z: torch.Tensor     # (NZ, 2) (range, bearing) measurement buffer
    ids: torch.Tensor   # (NZ,) int landmark id of each slot (undefined if masked)
    mask: torch.Tensor  # (NZ,) bool slot validity
