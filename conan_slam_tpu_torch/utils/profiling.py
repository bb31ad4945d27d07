"""The port's tracer, and the chained-scan harness the port-side benches
time frames with.

The tracer records spans and counters inside the program: the replay
driver (``runner.loop.run_ekf_slam_precomputed``) opens a ``request`` span
a call, ``request.setup``, and a ``frame`` span a frame with its children
``frame.inputs``, ``frame.associate``, ``frame.update``, ``frame.augment``
and ``frame.outputs``; every launch of a kernel of ``ops.cuda`` is a
``launch`` span.  It counts ``requests``, ``frames`` and, on a CUDA device,
``alloc_bytes`` (what the caching allocator handed out inside each frame).
``tracing()`` switches it on and ``take()`` hands over what it kept::

    with profiling.tracing():
        state, outs = run_ekf_slam_precomputed(...)
    taken = profiling.take()

Spans are stamped with ``time.time_ns()``, the clock of torch.profiler's
kineto events, so a span and a device trace share one clock.  Off, a span
or a count is one flag test: no clock read, no allocation, no device work.

``scan_graph`` is the counterpart of ``jax.jit(lax.scan(step, carry,
length=n))`` as the reference's benches use it: n dependent steps with the
host out of the loop.  On the card it captures ``block`` steps into one
CUDA graph and replays it; the steps' own kernels run as the driver would
launch them, only the host's dispatch is gone.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from types import MappingProxyType
from typing import Callable, NamedTuple

import torch

from conan_slam_tpu_torch.ops import cuda


# The most closed spans the tracer keeps between two ``take()``s; past it a
# closing span is dropped and counted.
CAPACITY = 1 << 16

# The attributes of a span opened without any (shared, never written).
NO_ATTRS = MappingProxyType({})


class Span:
    """One span: ``name``, ``start_ns`` and ``end_ns`` on ``time.time_ns()``'s
    clock, its ``id``, its ``parent``'s id (0 at a root), its ``request``
    (the id of the nearest ``request`` span around it, its own for a
    ``request``, 0 outside every one), and the ``attrs`` it was opened
    with.  A context manager while open."""

    __slots__ = ("_tracer", "name", "attrs", "id", "parent", "request", "start_ns", "end_ns")

    def __init__(self, tracer: "Tracer", name: str, attrs):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs

    def __enter__(self) -> "Span":
        tr = self._tracer
        stack = tr._open.spans
        self.id = next(tr._ids)
        top = stack[-1] if stack else None
        self.parent = top.id if top else 0
        self.request = self.id if self.name == "request" else top.request if top else 0
        stack.append(self)
        self.start_ns = _now()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = _now()
        tr = self._tracer
        tr._open.spans.pop()
        with tr._lock:
            if len(tr._spans) < CAPACITY:
                tr._spans.append(self)
            else:
                tr.dropped += 1
        return False


class _Off:
    """The span handed out while the tracer is off: does nothing."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()
_now = time.time_ns


class _OpenSpans(threading.local):
    """The spans open on one thread, innermost last."""

    def __init__(self):
        self.spans: list[Span] = []


class Taken(NamedTuple):
    """What the tracer kept since the last ``take()``: the closed ``spans``
    in the order they started, the ``counters``, each CUDA kernel's
    launches (``ops.cuda.CudaKernel.launches`` gained, by kernel name), and
    the spans ``dropped`` because the buffer was full."""

    spans: list
    counters: dict
    launches: dict
    dropped: int


class Tracer:
    """Spans and counters kept in memory, in a buffer of at most
    ``CAPACITY`` spans.  Spans nest on the thread that opens them; every
    thread's spans and counts go to the one buffer."""

    def __init__(self):
        self.on = False
        self.dropped = 0
        self.counters: dict[str, int] = {}
        self._spans: list[Span] = []
        self._open = _OpenSpans()
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._launched: dict[str, int] = {}

    @contextlib.contextmanager
    def tracing(self):
        """Switch the tracer on for the block, with an empty buffer; off
        again on leaving it.  What it kept stays for ``take()``."""
        if self.on:
            raise RuntimeError("the tracer is already on")
        self.take()
        self.on = True
        try:
            yield
        finally:
            self.on = False

    def span(self, name: str, attrs=NO_ATTRS):
        """A context manager that records a span ``name`` with the mapping
        ``attrs`` (a shared no-op while the tracer is off)."""
        if not self.on:
            return _OFF
        return Span(self, name, attrs)

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to the counter ``name`` (nothing while off)."""
        if not self.on:
            return
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def alloc(self, device: torch.device):
        """A context manager that adds to ``alloc_bytes`` the bytes the
        CUDA caching allocator hands out on ``device`` inside the block (a
        host call, no synchronisation); a no-op off or on the CPU."""
        if not self.on or device.type != "cuda":
            return _OFF
        return _Alloc(self, device)

    def take(self) -> Taken:
        """What was kept since the last ``take()``; clears it."""
        launched = {k.name: k.launches for k in cuda.KERNELS.values()}
        with self._lock:
            spans, self._spans = self._spans, []
            counters, dropped = self.counters, self.dropped
            self.counters, self.dropped = {}, 0
            last, self._launched = self._launched, launched
        spans.sort(key=lambda s: s.start_ns)
        launches = {k: n - last.get(k, 0) for k, n in launched.items() if n != last.get(k, 0)}
        return Taken(spans, counters, launches, dropped)


def _allocated(device: torch.device) -> int:
    return torch.cuda.memory_stats_as_nested_dict(device)["allocated_bytes"]["all"]["allocated"]


class _Alloc:
    __slots__ = ("_tracer", "_device", "_before")

    def __init__(self, tracer: Tracer, device: torch.device):
        self._tracer = tracer
        self._device = device

    def __enter__(self) -> None:
        self._before = _allocated(self._device)

    def __exit__(self, *exc) -> bool:
        self._tracer.count("alloc_bytes", _allocated(self._device) - self._before)
        return False


TRACER = Tracer()
tracing = TRACER.tracing
span = TRACER.span
count = TRACER.count
alloc = TRACER.alloc
take = TRACER.take


class Scan(NamedTuple):
    """What ``scan_graph`` measured.

    ``carry``: the carry after ``frames`` steps (on the card, of the graph's
    replays; on the CPU, of the eager loop).  ``eager_carry``: the same from
    the eager loop (on the CPU, ``carry`` itself).  ``us_per_frame``: the
    graph replays' device time a step (CUDA events around the replays); on
    the CPU the eager loop's host time, which is no device number.
    ``eager_us_per_frame``: the eager loop's time a step, with the host's
    dispatch (CUDA events on the card, the host clock on the CPU).
    ``launches``: each CUDA kernel's launches in the replayed run (its
    launches captured in one block x the replays); empty on the CPU.
    """

    carry: tuple
    eager_carry: tuple
    us_per_frame: float
    eager_us_per_frame: float
    frames: int
    replays: int
    launches: dict


def _counts() -> dict[str, int]:
    return {k.name: k.launches for k in cuda.KERNELS.values()}


# Eager steps before a capture: the first launches load libraries and set
# the kernels' shared-memory caps, which a capture must not see.
WARMUP_STEPS = 2


def scan_graph(step: Callable[[tuple], tuple], carry, n_frames: int, block: int) -> Scan:
    """Run ``n_frames`` dependent steps ``carry = step(carry)`` (a tuple of
    tensors in, one of the same shapes out) and time them.

    On the card: WARMUP_STEPS eager steps (first launches, library loads)
    on the stream the capture then uses, then ``block`` steps captured into one ``torch.cuda.CUDAGraph`` whose
    carry sits in static buffers (the graph ends by copying the block's
    last carry into them, so each replay starts where the last one ended),
    replayed ``n_frames // block`` times between two CUDA events; beside it
    the same number of steps run eagerly between two events.  A capture
    that fails raises: there is no fallback to the eager loop.  On the CPU
    the steps run eagerly, timed by the host clock.  The caller's carry is
    never written: a step may update its carry in place.
    """
    carry = tuple(carry)
    if block < 1 or n_frames < block:
        raise ValueError(f"scan_graph: need 1 <= block <= n_frames, got {block}, {n_frames}")
    replays = n_frames // block
    frames = replays * block
    dev = carry[0].device
    if dev.type != "cuda":
        c = tuple(t.clone() for t in carry)
        t0 = time.perf_counter()
        for _ in range(frames):
            c = tuple(step(c))
        us = (time.perf_counter() - t0) * 1e6 / frames
        return Scan(c, c, us, us, frames, replays, {})

    # Warm up on the stream the graph is captured on: a kernel that keeps
    # scratch a stream (H15's gating) makes it there before the capture.
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    c = tuple(t.clone() for t in carry)
    with torch.cuda.stream(stream):
        for _ in range(WARMUP_STEPS):
            c = tuple(step(c))
    torch.cuda.synchronize(dev)

    static = tuple(t.clone() for t in carry)
    graph = torch.cuda.CUDAGraph()
    before = _counts()
    try:
        with torch.cuda.graph(graph, stream=stream):
            c = static
            for _ in range(block):
                c = tuple(step(c))
            for dst, src in zip(static, c):
                if src.data_ptr() != dst.data_ptr():
                    dst.copy_(src)
    except RuntimeError as e:
        raise RuntimeError(f"scan_graph: capturing {block} steps into a CUDA graph failed: "
                           f"{e}") from e
    after = _counts()
    launches = {k: (after[k] - before.get(k, 0)) * replays for k in after
                if after[k] != before.get(k, 0)}

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(dev)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize(dev)
    us = start.elapsed_time(stop) * 1e3 / frames

    c = tuple(t.clone() for t in carry)
    torch.cuda.synchronize(dev)
    start.record()
    for _ in range(frames):
        c = tuple(step(c))
    stop.record()
    torch.cuda.synchronize(dev)
    eager_us = start.elapsed_time(stop) * 1e3 / frames
    out = tuple(t.clone() for t in static)
    del graph
    return Scan(out, c, us, eager_us, frames, replays, launches)
