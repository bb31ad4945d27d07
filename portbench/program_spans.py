"""The port's own spans and counters over a traced stretch, and what they
read beside the device trace.

The port's tracer (``conan_slam_tpu_torch.utils.profiling``) records, on
the clock of torch.profiler's kineto events, a ``request`` span a call of
the replay driver, its ``request.setup``, a ``frame`` span a frame (or pair)
with its children, and a ``launch`` span each call of one of the port's
CUDA entries; it counts ``requests``, ``frames`` and ``alloc_bytes``.
``digest`` puts them on the trace's microseconds beside a ``tracing.Digest``
of the same stretch and matches each device event to its launch: the CUDA
runtime call with its correlation id, which the trace holds for PyTorch's
events and, on the H100 with torch 2.11, for the port's ctypes launches
too; else, for a kernel of the port, the ``launch`` span it came from (an
entry's n-th kernel to its n-th launch; the span opens ~45 us before the
runtime call inside the C entry).

Each idle gap of the card is then closed by a device event that was
either launched before the gap opened (*queued*: launch latency between
events already enqueued) or after it (*host-bound*: the card waited for
the host); a closing event with no launch found is *unattributed*.  The
stretch's leading gap is closed by its first event.  What is left of the
idle, the stretch's wall less its busy time less the gaps up to the last
event, is the trailing gap: it is labelled ``client`` and counted
host-bound by assumption, since no event closes it.  So host-bound,
queued and unattributed idle add up to ``device_idle_pct``.

``harness.run`` does not switch the tracer on (PERF.md, Open questions),
so no cell's result line carries these metrics yet; each reader below
takes the stretch's ``tracing.Digest`` and this module's ``Program``.
"""

from __future__ import annotations

import bisect
from collections import Counter
from dataclasses import dataclass, field

CLIENT = "client"        # a late launch outside any request span
LAUNCH = "launch"
RUNTIME = "cu"           # the CUDA runtime and driver calls: cudaLaunchKernel, cuLaunchKernel, ...


@dataclass
class Program:
    """The tracer's take over a stretch, on the trace's clock (us)."""

    spans: list              # (start_us, end_us, name, attrs), in start order
    counters: dict
    dropped: int = 0
    events: list = field(default_factory=list)   # (start_us, end_us, name, launch_us | None)


def digest(prof, dig, taken) -> Program:
    """The program's ``taken`` spans on ``prof``'s clock, and each of
    ``dig.intervals`` with its launch."""
    from torch.autograd import DeviceType

    results = prof.profiler.kineto_results
    t0 = results.trace_start_ns()
    spans = [((s.start_ns - t0) / 1e3, (s.end_ns - t0) / 1e3, s.name, s.attrs)
             for s in taken.spans]
    runtime = {e.correlation_id(): (e.start_ns() - t0) / 1e3 for e in results.events()
               if e.device_type() == DeviceType.CPU and e.name().startswith(RUNTIME)}
    wanted = Counter(dig.intervals)
    device = []                      # (start, end, name, correlation id)
    for e in prof.events():
        key = (e.time_range.start, e.time_range.end, e.name)
        if e.device_type == DeviceType.CUDA and wanted[key] > 0:
            wanted[key] -= 1
            device.append((*key, e.id))
    launch = [runtime.get(corr) for _, _, _, corr in device]
    # A kernel of the port with no runtime call in the trace: its launch
    # span, the n-th kernel (in the order they started) against the n-th
    # slot of the spans expanded to one a kernel; a count that disagrees
    # matches none.
    port = sorted((k for k, ev in enumerate(device) if dig.is_port(ev[2])),
                  key=lambda k: device[k][0])
    slots = [s[0] for s in spans if s[2] == LAUNCH for _ in range(s[3].get("launches", 1))]
    for k, slot in zip(port, slots if len(slots) == len(port) else [None] * len(port)):
        if launch[k] is None:
            launch[k] = slot
    events = sorted(((a, b, name, t) for (a, b, name, _), t in zip(device, launch)),
                    key=lambda ev: ev[:2])
    return Program(spans=spans, counters=dict(taken.counters), dropped=taken.dropped,
                   events=events)


@dataclass
class Idle:
    """The stretch's idle microseconds by what closed each gap; host-bound
    idle also by the innermost program span (``launch`` spans aside) the
    late launch was made in."""

    host_bound_us: float = 0.0
    queued_us: float = 0.0
    unattributed_us: float = 0.0
    trailing_us: float = 0.0         # the rest of the idle, in host_bound_us
    unattributed_events: int = 0
    by_span: dict = field(default_factory=dict)


def split_idle(dig, prog: Program) -> Idle:
    out = Idle()
    gaps, end = [], 0.0                   # (opened, closed, launch_us of the closer)
    evs = prog.events
    i = 0
    while i < len(evs):
        j = i
        while j < len(evs) and evs[j][0] == evs[i][0]:
            j += 1
        if evs[i][0] > end:
            launches = [e[3] for e in evs[i:j] if e[3] is not None]
            gaps.append((end, evs[i][0], min(launches) if launches else None))
        end = max(end, *(e[1] for e in evs[i:j]))
        i = j
    out.unattributed_events = sum(1 for e in evs if e[3] is None)
    late = []
    for opened, closed, launch in gaps:
        if launch is None:
            out.unattributed_us += closed - opened
        elif launch > opened:
            out.host_bound_us += closed - opened
            late.append((launch, closed - opened))
        else:
            out.queued_us += closed - opened
    out.trailing_us = max(0.0, dig.wall_us - dig.busy_us - sum(b - a for a, b, _ in gaps))
    out.host_bound_us += out.trailing_us
    by = {CLIENT: out.trailing_us} if out.trailing_us > 0 else {}
    for label, us in zip(_innermost(prog.spans, [t for t, _ in late]), (u for _, u in late)):
        by[label] = by.get(label, 0.0) + us
    out.by_span = by
    return out


def _innermost(spans, times) -> list:
    """The name of the innermost span (``launch`` aside) open at each of
    ``times``, or ``CLIENT`` outside every ``request``; spans nest, so the
    innermost open one is the open one that started last."""
    spans = [s for s in spans if s[2] != LAUNCH]
    starts = [s[0] for s in spans]
    out = []
    for t in times:
        k = bisect.bisect_right(starts, t)
        name = CLIENT
        while k > 0:
            k -= 1
            if spans[k][1] >= t:
                name = spans[k][2]
                break
            if spans[k][2] == "request":
                break
        out.append(name)
    return out


def _frames(prog: Program) -> int:
    return prog.counters.get("frames", 0)


def host_bound_idle_pct(dig, prog: Program):
    """The card's idle share of the stretch's wall in which it waited for
    the host: gaps whose closing event was launched after they opened."""
    if not dig.intervals or not prog.events:
        return None
    return 100.0 * split_idle(dig, prog).host_bound_us / dig.wall_us


def host_us_per_frame(dig, prog: Program):
    """Host microseconds the driver spends a frame: the ``frame`` spans'
    durations over the frames they hold."""
    durations = [b - a for a, b, name, _ in prog.spans if name == "frame"]
    return sum(durations) / _frames(prog) if durations and _frames(prog) else None


def request_setup_us(dig, prog: Program):
    """A request's own set-up on the host: the mean ``request.setup``."""
    durations = [b - a for a, b, name, _ in prog.spans if name == "request.setup"]
    return sum(durations) / len(durations) if durations else None


def alloc_mb_per_frame(dig, prog: Program):
    """MB (1e6 bytes) the CUDA caching allocator hands out a frame
    (``alloc_bytes`` over the frames; none on the CPU)."""
    if "alloc_bytes" not in prog.counters or not _frames(prog):
        return None
    return prog.counters["alloc_bytes"] / _frames(prog) / 1e6


def report(dig, prog: Program) -> str:
    """Lines for standard error: the idle by what closed its gaps, host-bound
    idle by program span, the unattributed events."""
    idle = split_idle(dig, prog)
    by = ", ".join(f"{k} {v / 1e3:.3f}" for k, v in sorted(idle.by_span.items(),
                                                           key=lambda kv: -kv[1]))
    total = dig.wall_us - dig.busy_us
    return (f"portbench: idle ms {total / 1e3:.3f}: host-bound {idle.host_bound_us / 1e3:.3f}, "
            f"queued {idle.queued_us / 1e3:.3f}, unattributed {idle.unattributed_us / 1e3:.3f}\n"
            f"portbench: host-bound idle ms by program span: {by}\n"
            f"portbench: device events {len(prog.events)}, unattributed "
            f"{idle.unattributed_events}; spans dropped {prog.dropped}")
