"""Set-up: the world, the rollout, the noise draws, the start state, the
kernel library's load (its build on a checkout's first run) and two warm
requests."""

UNIT = "s"


def read(win):
    return win.setup_s
