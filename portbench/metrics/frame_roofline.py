"""The frame's least time on the card (roofline/bounds.py: P in and out
once and the update's operations, from the cell's shapes) over the device's
busy microseconds a frame."""

UNIT = "%"


def read(dig):
    if not dig.intervals or dig.busy_us <= 0:
        return None
    return 100.0 * dig.frame_bound_us / (dig.busy_us / dig.frames)
