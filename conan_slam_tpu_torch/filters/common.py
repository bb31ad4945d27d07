"""Shared filter-side observation container and its on-device compaction
(port of conan_slam_tpu.filters.common).

The sensor returns every landmark with a visibility mask; ``compact``
packs the visible ones into a fixed buffer of ``size`` slots, so every
downstream shape stays static.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, NamedTuple

import torch

if TYPE_CHECKING:   # sim.sensor_sim imports nothing of filters; this keeps it so
    from conan_slam_tpu_torch.sim.sensor_sim import Observation


class CompactObs(NamedTuple):
    z: torch.Tensor     # (NZ, 2) (range, bearing) measurement buffer
    ids: torch.Tensor   # (NZ,) int landmark id of each slot (-1 where masked)
    mask: torch.Tensor  # (NZ,) bool slot validity


def compact(obs: Observation, size: int) -> CompactObs:
    """Pack the visible returns into ``size`` slots, ascending landmark id
    (the reference's visible-landmark order, slam.h:637-657, which fixes
    the slot order of new features); overflow past ``size`` is dropped and
    empty slots hold id -1 and z 0.

    No ``torch.nonzero`` (it waits for the device to learn its length):
    each visible return's rank is a cumulative sum, and the kept ones are
    scattered to their rank; the rest land in a spare slot past the end.
    """
    visible = obs.visible
    n = visible.shape[0]
    rank = torch.cumsum(visible.to(torch.int64), 0) - 1
    keep = visible & (rank < size)
    idx = torch.full((size + 1,), -1, dtype=torch.int64, device=visible.device)
    idx[torch.where(keep, rank, size)] = torch.arange(n, device=visible.device)
    idx = idx[:size]
    mask = idx >= 0
    z = obs.z[torch.clamp(idx, min=0)]
    return CompactObs(z=torch.where(mask[:, None], z, 0.0), ids=idx, mask=mask)
