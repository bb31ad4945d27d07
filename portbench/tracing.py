"""What the per-layer readers read: a digest of the torch.profiler trace of
a stretch of the window.

* ``ops``: the PyTorch operators the driver dispatched, counted as the
  port's smoke run counts them (outermost ``aten::`` events only), inside
  the driver's call (``run_ekf_slam_precomputed``'s own range), so the
  harness's slicing and host copies are left out;
* ``intervals``: every device event (kernels, copies, sets) as (start,
  end, name), in microseconds;
* ``ranges``: the spans the harness records around the driver's calls
  into each layer (``harness.spans``), for naming what the host did while
  the device idled.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

DRIVER = "run_ekf_slam_precomputed"


@dataclass
class Digest:
    frames: int
    wall_us: float
    ops: int
    intervals: list          # (start_us, end_us, name)
    ranges: list             # (start_us, end_us, name)
    port: list               # the port's kernel names
    frame_bound_us: float
    busy_us: float = 0.0
    port_re: re.Pattern | None = None

    def is_port(self, name: str) -> bool:
        """Whether a device event is one of the port's kernels (a listed
        name as a whole word of the demangled name)."""
        if self.port_re is None:
            self.port_re = re.compile(r"\b(" + "|".join(map(re.escape, self.port)) + r")\b")
        return bool(self.port) and self.port_re.search(name) is not None


def union_us(intervals) -> float:
    """Microseconds covered by the union of (start, end, ...) intervals."""
    busy, end = 0.0, float("-inf")
    for a, b, *_ in sorted(intervals):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy


def digest(prof, frames: int, wall_us: float, kernels, frame_bound_us: float,
           span_names) -> Digest:
    """The digest of ``prof`` over a stretch of ``frames`` frames and
    ``wall_us``; ``span_names`` are the harness's ranges."""
    from torch.autograd import DeviceType

    span_names = set(span_names)
    events = prof.events()
    intervals, ranges = [], []
    for e in events:
        if e.name in span_names:
            if e.device_type == DeviceType.CPU:
                ranges.append((e.time_range.start, e.time_range.end, e.name))
        elif e.device_type == DeviceType.CUDA:
            intervals.append((e.time_range.start, e.time_range.end, e.name))

    def in_driver(e) -> bool:
        q, inside = e.cpu_parent, False
        while q is not None:
            if q.name.startswith("aten::"):
                return False
            inside = inside or q.name == DRIVER
            q = q.cpu_parent
        return inside

    ops = sum(1 for e in events if e.device_type == DeviceType.CPU
              and e.name.startswith("aten::") and in_driver(e))
    dig = Digest(frames=frames, wall_us=wall_us, ops=ops, intervals=intervals, ranges=ranges,
                 port=list(kernels), frame_bound_us=frame_bound_us)
    dig.busy_us = union_us(intervals)
    return dig


def breakdown(dig: Digest, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps by the
    innermost harness span the host was in at the gap's middle, each as
    [name, seconds]."""
    by_op: dict[str, float] = {}
    for a, b, name in dig.intervals:
        by_op[name[:120]] = by_op.get(name[:120], 0.0) + (b - a) / 1e6
    idle, end = [], None
    for a, b, _ in sorted(dig.intervals):
        if end is not None and a > end:
            idle.append((0.5 * (a + end), (a - end) / 1e6))
        end = b if end is None else max(end, b)
    # One sweep: the spans nest, so the innermost open at a time is the
    # open one that started last.
    ranges, nxt, open_, gaps = sorted(dig.ranges), 0, [], {}
    for mid, secs in idle:
        while nxt < len(ranges) and ranges[nxt][0] <= mid:
            open_.append(ranges[nxt])
            nxt += 1
        open_ = [r for r in open_ if r[1] >= mid]
        label = open_[-1][2] if open_ else "outside the driver"
        gaps[label] = gaps.get(label, 0.0) + secs
    rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]  # noqa: E731
    return {"device_ops": rank(by_op), "idle_gaps": rank(gaps)}
