"""Share of the traced stretch's wall time in which no kernel, copy or set
ran on the card (the union of the device's intervals)."""

UNIT = "%"


def read(dig):
    if not dig.intervals:
        return None
    return 100.0 * (1.0 - dig.busy_us / dig.wall_us)
