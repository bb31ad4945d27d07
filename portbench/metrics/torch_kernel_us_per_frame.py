"""Device microseconds a frame in every other kernel, copy and set: the
ones PyTorch launches for the driver, the association and the
augmentation."""

from portbench.tracing import union_us

UNIT = "us/frame"


def read(dig):
    theirs = [iv for iv in dig.intervals if not dig.is_port(iv[2])]
    return union_us(theirs) / dig.frames if theirs else None
