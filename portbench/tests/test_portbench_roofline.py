"""The frozen bound arithmetic gives back PERF.md section 6's bounds from
shapes alone."""

import pytest

from portbench.roofline.bounds import frame_bound_us


@pytest.mark.parametrize("path, d, want", [("known", 2304, 12.68), ("gated", 20224, 977.4)])
def test_section6_bounds(path, d, want):
    us, by = frame_bound_us(path, d, 64, 6, True)
    assert by == "bytes"
    assert round(us, 2 if want < 100 else 1) == want
