"""The readers of the port's own spans (program_spans.py) on synthetic
digests, the match of device events to their launches, and a traced run on
the CPU."""

from types import SimpleNamespace

import pytest

from portbench import program_spans as ps
from portbench.tracing import Digest, union_us


def _dig(intervals, wall_us=100.0, frames=2, port=()):
    dig = Digest(frames=frames, wall_us=wall_us, ops=0, intervals=list(intervals), ranges=[],
                 port=list(port), frame_bound_us=1.0)
    dig.busy_us = union_us(dig.intervals)
    return dig


def _span(a, b, name, **attrs):
    return (a, b, name, attrs)


# A request over the stretch's first 70 us: its set-up, two frames, the
# second's update launching the last kernel.
SPANS = [_span(0.0, 70.0, "request"), _span(0.5, 3.0, "request.setup"),
         _span(3.0, 30.0, "frame"), _span(30.0, 69.0, "frame"),
         _span(44.0, 46.0, "frame.update"), _span(44.5, 45.5, "launch", launches=1)]
INTERVALS = [(10.0, 20.0, "k1"), (25.0, 40.0, "k2"), (50.0, 60.0, "k3")]


def _prog(launches, counters=None):
    events = [(*iv, t) for iv, t in zip(INTERVALS, launches)]
    return ps.Program(spans=SPANS, counters=counters or {"frames": 2}, events=events)


def test_a_gap_closed_by_an_earlier_launch_is_queued_by_a_later_one_host_bound():
    """k1 closes the leading gap [0, 10] and was launched at 5: host-bound;
    k2 was launched at 15, before its gap [20, 25] opened: queued; k3 at
    44.5, after [40, 50] opened: host-bound, in the update (launch spans
    aside); the trailing [60, 100] waits for the client."""
    idle = ps.split_idle(_dig(INTERVALS), _prog([5.0, 15.0, 44.5]))
    assert idle.host_bound_us == pytest.approx(10.0 + 10.0 + 40.0)
    assert idle.queued_us == pytest.approx(5.0)
    assert idle.unattributed_us == 0.0 and idle.unattributed_events == 0
    assert idle.by_span == pytest.approx({"client": 40.0, "frame": 10.0, "frame.update": 10.0})


# Events that overlap, start together and lie inside another: the union is
# [10, 30] and [35, 40], busy 25 us, and the gaps before the last event
# [0, 10] and [30, 35].
OVERLAPPING = [(10.0, 20.0, "k1"), (15.0, 30.0, "k2"), (15.0, 18.0, "k3"), (22.0, 25.0, "k5"),
               (35.0, 40.0, "k4")]


@pytest.mark.parametrize("intervals,launches", [
    (INTERVALS, [5.0, 15.0, 44.5]), (INTERVALS, [5.0, None, 44.5]),
    (INTERVALS, [None, None, None]), (OVERLAPPING, [5.0, 12.0, None, 21.0, 33.0]),
    (OVERLAPPING, [12.0, None, None, 40.0, 28.0]),
])
def test_host_bound_queued_and_unattributed_add_up_to_the_idle(intervals, launches):
    """The gaps walked between the events meet the union of the intervals
    (``tracing.union_us``) at the last event, and the trailing gap is the
    wall after it; with it the three parts are ``device_idle_pct``."""
    from portbench import harness

    dig = _dig(intervals)
    prog = ps.Program(spans=SPANS, counters={"frames": 2},
                      events=sorted((*iv, t) for iv, t in zip(intervals, launches)))
    idle = ps.split_idle(dig, prog)
    assert idle.trailing_us == pytest.approx(dig.wall_us - max(b for _, b, _ in intervals))
    assert idle.by_span[ps.CLIENT] == pytest.approx(idle.trailing_us)
    whole = harness.readers("metrics")["device_idle_pct"].read(dig)
    parts = 100.0 * (idle.host_bound_us + idle.queued_us + idle.unattributed_us) / dig.wall_us
    assert parts == pytest.approx(whole)
    assert idle.unattributed_events == launches.count(None)
    assert ps.host_bound_idle_pct(dig, prog) <= whole


def test_overlapping_events_close_their_gap_by_the_earliest_launch():
    """k2 and k3 start together at 15, inside k1, and k5 inside k2: no gap.
    k4 closes [30, 35], launched at 33 (host-bound); k1 closes [0, 10],
    launched at 5."""
    prog = ps.Program(spans=SPANS, counters={}, events=sorted(
        (*iv, t) for iv, t in zip(OVERLAPPING, [5.0, 12.0, None, 21.0, 33.0])))
    idle = ps.split_idle(_dig(OVERLAPPING), prog)
    assert idle.host_bound_us == pytest.approx(10.0 + 5.0 + 60.0)
    assert idle.queued_us == 0.0 and idle.unattributed_us == 0.0
    assert idle.unattributed_events == 1
    # A second event opens at 35 beside k4, to 45, launched at 29, before
    # the gap opened: the earliest launch of the events that close a gap
    # decides.
    prog.events = sorted([*prog.events, (35.0, 45.0, "k6", 29.0)])
    idle = ps.split_idle(_dig([*OVERLAPPING, (35.0, 45.0, "k6")]), prog)
    assert idle.host_bound_us == pytest.approx(10.0 + 55.0)
    assert idle.queued_us == pytest.approx(5.0)


def test_each_reader_reads_what_is_there_and_none_where_nothing_is():
    dig = _dig(INTERVALS)
    prog = _prog([5.0, 15.0, 44.5], counters={"frames": 2, "alloc_bytes": 3_000_000})
    assert ps.host_bound_idle_pct(dig, prog) == pytest.approx(60.0)
    assert ps.host_us_per_frame(dig, prog) == pytest.approx((27.0 + 39.0) / 2)
    assert ps.request_setup_us(dig, prog) == pytest.approx(2.5)
    assert ps.alloc_mb_per_frame(dig, prog) == pytest.approx(1.5)
    # The CPU: no device events, no allocator; the host spans still read.
    cpu = ps.Program(spans=SPANS, counters={"frames": 2})
    assert ps.host_bound_idle_pct(_dig([]), cpu) is None
    assert ps.alloc_mb_per_frame(_dig([]), cpu) is None
    assert ps.host_us_per_frame(_dig([]), cpu) == pytest.approx((27.0 + 39.0) / 2)
    assert ps.request_setup_us(_dig([]), cpu) == pytest.approx(2.5)
    # No spans and no frames counted: nothing to read.
    empty = ps.Program(spans=[], counters={})
    for reader in READERS:
        assert reader(_dig([]), empty) is None
    assert ps.host_us_per_frame(dig, ps.Program(spans=SPANS, counters={})) is None


READERS = [ps.host_bound_idle_pct, ps.host_us_per_frame, ps.request_setup_us,
           ps.alloc_mb_per_frame]


def _fn_event(a, b, name, corr, cuda):
    from torch.autograd import DeviceType

    return SimpleNamespace(time_range=SimpleNamespace(start=a, end=b), name=name, id=corr,
                           device_type=DeviceType.CUDA if cuda else DeviceType.CPU)


def _kineto(start_ns, corr, name):
    from torch.autograd import DeviceType

    return SimpleNamespace(correlation_id=lambda: corr, start_ns=lambda: start_ns,
                           name=lambda: name, device_type=lambda: DeviceType.CPU)


def test_events_meet_their_launches():
    """A kernel meets the runtime call with its correlation id; the port's
    two kernels of one entry, with none, meet its launch span in the order
    they started; with one launch missing, neither is matched."""
    t0 = 1_000_000
    intervals = [(10.0, 20.0, "elementwise_kernel"), (22.0, 40.0, "frame_step_kernel<4>"),
                 (21.0, 60.0, "frame_pass_kernel<true>")]
    dev = [_fn_event(*iv, corr, True) for iv, corr in zip(intervals, (7, 8, 9))]
    prof = SimpleNamespace(
        events=lambda: [_fn_event(0.0, 1.0, "aten::add", 7, False), *dev],
        profiler=SimpleNamespace(kineto_results=SimpleNamespace(
            trace_start_ns=lambda: t0,
            events=lambda: [_kineto(t0 + 4_000, 7, "cudaLaunchKernel"),
                            _kineto(t0 + 3_000, 7, "aten::add")])))
    dig = _dig(intervals, port=["frame_step_kernel", "frame_pass_kernel"])
    launch = SimpleNamespace(start_ns=t0 + 15_000, end_ns=t0 + 16_000, name="launch",
                             attrs={"kernel": "frame_step", "launches": 2})
    taken = SimpleNamespace(spans=[launch], counters={"frames": 1}, dropped=0)
    prog = ps.digest(prof, dig, taken)
    assert prog.spans == [(15.0, 16.0, "launch", launch.attrs)]
    assert [(name, t) for _, _, name, t in prog.events] == [
        ("elementwise_kernel", 4.0), ("frame_pass_kernel<true>", 15.0),
        ("frame_step_kernel<4>", 15.0)]
    launch.attrs = {"kernel": "frame_step", "launches": 1}
    prog = ps.digest(prof, dig, taken)
    assert [t for _, _, _, t in prog.events] == [4.0, None, None]
    # The runtime call, where the trace has one, before the launch span.
    kineto = prof.profiler.kineto_results.events()
    prof.profiler.kineto_results.events = lambda: [*kineto, _kineto(t0 + 17_000, 9,
                                                                   "cudaLaunchKernelExC")]
    prog = ps.digest(prof, dig, taken)
    assert [t for _, _, _, t in prog.events] == [4.0, 17.0, None]


def test_a_traced_run_on_the_cpu_reports_the_two_host_metrics():
    import torch
    from torch.profiler import ProfilerActivity, profile

    from conan_slam_tpu_torch.config import SlamConfig
    from conan_slam_tpu_torch.filters.ekf import init_state_with_map
    from conan_slam_tpu_torch.runner.loop import run_ekf_slam_precomputed
    from conan_slam_tpu_torch.sim.world import default_world
    from conan_slam_tpu_torch.utils import profiling
    from portbench import harness, tracing

    world = default_world(device="cpu")
    cfg = SlamConfig(max_landmarks=30, max_obs=16, enable_augment=False)
    with profile(activities=[ProfilerActivity.CPU]) as prof, profiling.tracing():
        run_ekf_slam_precomputed(world, cfg, torch.Generator().manual_seed(3),
                                 3 * cfg.observe_interval, init_state_with_map(world.landmarks))
    dig = tracing.digest(prof, frames=3, wall_us=1e5, kernels=harness.port_kernels(),
                         frame_bound_us=1.0, span_names=harness.SPAN_NAMES)
    prog = ps.digest(prof, dig, profiling.take())
    assert ps.host_us_per_frame(dig, prog) > 0 and ps.request_setup_us(dig, prog) > 0
    assert ps.host_bound_idle_pct(dig, prog) is None and ps.alloc_mb_per_frame(dig, prog) is None
