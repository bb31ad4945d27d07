"""Profiling and step-timing hooks (port of conan_slam_tpu.utils.profiling),
and the chained-scan harness the port-side benches time frames with.

``scan_graph`` is the counterpart of ``jax.jit(lax.scan(step, carry,
length=n))`` as the reference's benches use it: n dependent steps with the
host out of the loop.  On the card it captures ``block`` steps into one
CUDA graph and replays it; the steps' own kernels run as the driver would
launch them, only the host's dispatch is gone.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, NamedTuple

import torch

from conan_slam_tpu_torch.ops import cuda


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace of the host and, where there is one,
    the card (the counterpart of ``xla_trace``); written to
    ``log_dir/trace.json`` (a Chrome trace).  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class Timer:
    """Wall-clock timer with a device fence.

    PyTorch returns before the card finishes, so ``measure`` yields a list
    into which the caller puts the outputs of the timed work; on leaving it
    synchronizes each CUDA output's device (nothing for CPU outputs) before
    it reads the clock.
    """

    def __init__(self):
        self.times: list[float] = []

    @contextlib.contextmanager
    def measure(self):
        t0 = time.perf_counter()
        fence: list = []
        yield fence
        devices = {t.device for t in _leaves(fence) if t.device.type == "cuda"}
        for dev in devices:
            torch.cuda.synchronize(dev)
        self.times.append(time.perf_counter() - t0)

    @property
    def best(self) -> float:
        return min(self.times)

    def steps_per_s(self, steps: int) -> float:
        return steps / self.best


def _leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for item in tree for t in _leaves(item)]
    if isinstance(tree, dict):
        return [t for item in tree.values() for t in _leaves(item)]
    return []


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

    On the card: WARMUP_STEPS eager steps (first launches, library loads),
    then ``block`` steps captured into one ``torch.cuda.CUDAGraph`` whose
    carry sits in static buffers (the graph ends by copying the block's
    last carry into them, so each replay starts where the last one ended),
    replayed ``n_frames // block`` times between two CUDA events; beside it
    the same number of steps run eagerly between two events.  A capture
    that fails raises: there is no fallback to the eager loop.  On the CPU
    the steps run eagerly, timed by the host clock.
    """
    carry = tuple(carry)
    if block < 1 or n_frames < block:
        raise ValueError(f"scan_graph: need 1 <= block <= n_frames, got {block}, {n_frames}")
    replays = n_frames // block
    frames = replays * block
    dev = carry[0].device
    if dev.type != "cuda":
        c = carry
        t0 = time.perf_counter()
        for _ in range(frames):
            c = tuple(step(c))
        us = (time.perf_counter() - t0) * 1e6 / frames
        return Scan(c, c, us, us, frames, replays, {})

    c = tuple(t.clone() for t in carry)
    for _ in range(WARMUP_STEPS):
        c = tuple(step(c))
    torch.cuda.synchronize(dev)

    static = tuple(t.clone() for t in carry)
    graph = torch.cuda.CUDAGraph()
    before = _counts()
    try:
        with torch.cuda.graph(graph):
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
