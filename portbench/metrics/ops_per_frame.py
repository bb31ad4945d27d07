"""PyTorch operators the replay driver dispatched a frame in the traced
stretch (outermost ``aten::`` calls inside its range)."""

UNIT = "ops/frame"


def read(dig):
    return dig.ops / dig.frames if dig.ops else None
