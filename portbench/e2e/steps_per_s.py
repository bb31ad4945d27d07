"""Control steps filtered in the window over the window's wall time."""

UNIT = "steps/s"


def read(win):
    return win.steps / win.wall_s
