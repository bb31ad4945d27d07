"""Device microseconds a frame in the port's own CUDA kernels (the names in
kernels/*.json; the union of their intervals, so a pass that waits resident
beside its frame kernel counts once)."""

from portbench.tracing import union_us

UNIT = "us/frame"


def read(dig):
    mine = [iv for iv in dig.intervals if dig.is_port(iv[2])]
    return union_us(mine) / dig.frames if mine else None
