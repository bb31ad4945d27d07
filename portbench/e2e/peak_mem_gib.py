"""The card's peak allocated memory over the window, less what the harness
keeps there (made in set-up, fixed for a cell): the whole log, of which
each request is handed a slice, and three states for the comparison.  In
GiB."""

UNIT = "GiB"


def read(win):
    return (win.peak_bytes - win.harness_bytes) / 2**30
