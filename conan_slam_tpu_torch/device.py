"""Where the port's constructors put their tensors when the caller names no
device: the CUDA card.  There is no quiet fallback to the CPU; a caller
that wants the CPU (the plain versions, as the tests run them) says so."""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """The CUDA card; raises ``RuntimeError`` where PyTorch sees none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the plain versions on the CPU"
        )
    return torch.device("cuda")
