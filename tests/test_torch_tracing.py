"""The port's tracer (``conan_slam_tpu_torch.utils.profiling``): off it
records nothing, reads no clock and allocates nothing; on, its spans nest
with their parents on their own thread, share one request id a driver
call, keep to their buffer, share torch.profiler's clock, and leave the
driver's outputs as they were; and the replay driver opens its spans and
counts its frames where the work happens."""

import inspect
import itertools
import threading
import tracemalloc
from types import SimpleNamespace

import pytest
import torch

from conan_slam_tpu_torch.config import SlamConfig
from conan_slam_tpu_torch.filters.ekf import init_state_with_map
from conan_slam_tpu_torch.runner import loop
from conan_slam_tpu_torch.sim.world import default_world
from conan_slam_tpu_torch.utils import profiling

torch.set_num_threads(2)

FRAME_CHILDREN = ["frame.inputs", "frame.associate", "frame.update", "frame.outputs"]


@pytest.fixture(autouse=True)
def _fresh_tracer():
    """Every test starts and ends with an empty buffer."""
    profiling.take()
    yield
    profiling.take()


def _run(n_frames=4, seed=1, **kw):
    """A short replay of the 30-landmark valet world: known association
    from the whole map registered, or (``switch_association_known=False``)
    gated from an empty map."""
    world = default_world(device="cpu")
    cfg = SlamConfig(max_landmarks=30, max_obs=16, **kw)
    state0 = init_state_with_map(world.landmarks) if cfg.switch_association_known else None
    return loop.run_ekf_slam_precomputed(world, cfg, torch.Generator().manual_seed(seed),
                                         n_frames * cfg.observe_interval, state0)


def test_off_records_nothing_reads_no_clock_and_allocates_nothing(monkeypatch):
    def no_clock():
        raise AssertionError("the tracer read the clock while off")

    monkeypatch.setattr(profiling, "_now", no_clock)
    cpu = torch.device("cpu")
    attrs = {"kernel": "frame_step", "launches": 2}

    # The managers are entered and left by hand: a ``with`` statement makes
    # a short-lived bound ``__exit__`` of whatever manager it is given.
    def calls(n):
        for _ in itertools.repeat(None, n):             # no int objects made
            s = profiling.span("frame")
            s.__enter__()
            a = profiling.alloc(cpu)
            a.__enter__()
            profiling.count("frames")
            profiling.count("frames", 2)
            a.__exit__(None, None, None)
            s.__exit__(None, None, None)
            s = profiling.span("launch", attrs)
            s.__enter__()
            s.__exit__(None, None, None)

    def peak(n):
        tracemalloc.start()
        try:
            before = tracemalloc.get_traced_memory()[0]
            tracemalloc.reset_peak()
            calls(n)
            after, top = tracemalloc.get_traced_memory()
        finally:
            tracemalloc.stop()
        assert after == before
        return top - before

    calls(2)                   # any first-call allocation happens here
    # Not even for a moment: 2,000 rounds peak where the loop alone does.
    assert peak(2000) == peak(0)
    # CPython's free lists hide a short-lived dict from tracemalloc, so the
    # attributes come as one mapping: a call makes no keyword dict.
    params = inspect.signature(profiling.span).parameters.values()
    assert all(p.kind != p.VAR_KEYWORD for p in params)
    assert profiling.span("frame") is profiling.span("request")
    taken = profiling.take()
    assert taken.spans == [] and taken.counters == {} and taken.dropped == 0


def test_spans_nest_with_their_parents_and_one_request_a_root():
    with profiling.tracing():
        assert profiling.TRACER.on
        with profiling.span("a", {"frames": 2}):
            with profiling.span("request"):
                with profiling.span("c"):
                    pass
            with profiling.span("d"):
                pass
        with profiling.span("request"):
            profiling.count("frames", 3)
            profiling.count("frames")
    assert not profiling.TRACER.on
    taken = profiling.take()
    assert [s.name for s in taken.spans] == ["a", "request", "c", "d", "request"]
    a, b, c, d, e = taken.spans
    assert a.parent == 0 and e.parent == 0
    assert b.parent == a.id and d.parent == a.id and c.parent == b.id
    # A request opens its own id whatever is open around it; outside every
    # request the id is 0.
    assert (a.request, b.request, c.request, d.request, e.request) == (0, b.id, b.id, 0, e.id)
    assert len({s.id for s in taken.spans}) == 5
    assert a.attrs == {"frames": 2} and b.attrs == {}
    for child, parent in ((b, a), (c, b), (d, a)):
        assert parent.start_ns <= child.start_ns <= child.end_ns <= parent.end_ns
    assert b.end_ns <= d.start_ns
    assert taken.counters == {"frames": 4} and taken.dropped == 0
    assert profiling.take().spans == []          # take() cleared them
    with profiling.tracing(), pytest.raises(RuntimeError, match="already on"):
        with profiling.tracing():
            pass


def test_spans_nest_on_their_own_thread():
    """Two threads open their spans in turns: each span's parent and request
    are its own thread's, and each closes its own."""
    turn = threading.Barrier(2)

    def work():
        with profiling.span("request"):
            turn.wait()
            with profiling.span("frame"):
                turn.wait()
            turn.wait()

    with profiling.tracing():
        threads = [threading.Thread(target=work) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert profiling.TRACER._open.spans == []
    taken = profiling.take()
    requests = [s for s in taken.spans if s.name == "request"]
    frames = [s for s in taken.spans if s.name == "frame"]
    assert len(requests) == 2 and len(frames) == 2
    assert sorted(f.parent for f in frames) == sorted(r.id for r in requests)
    assert all(f.request == f.parent for f in frames)
    for f in frames:
        (r,) = [r for r in requests if r.id == f.parent]
        assert r.start_ns <= f.start_ns <= f.end_ns <= r.end_ns


def test_buffer_cap_drops_and_counts(monkeypatch):
    monkeypatch.setattr(profiling, "CAPACITY", 3)
    with profiling.tracing():
        for _ in range(5):
            with profiling.span("frame"):
                profiling.count("frames")
    taken = profiling.take()
    assert len(taken.spans) == 3 and taken.dropped == 2
    assert taken.counters == {"frames": 5}
    assert profiling.take().dropped == 0


def test_a_span_shares_the_profilers_clock():
    """A span around a PyTorch op on the CPU holds that op's kineto event,
    both on ``time.time_ns()``'s clock."""
    from torch.profiler import ProfilerActivity, profile

    a = torch.ones(64)
    with profile(activities=[ProfilerActivity.CPU]) as prof, profiling.tracing():
        with profiling.span("op"):
            torch.add(a, 1.0)
    (sp,) = profiling.take().spans
    events = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::add"]
    assert len(events) == 1
    assert sp.start_ns <= events[0].start_ns() <= events[0].end_ns() <= sp.end_ns


def test_one_request_id_per_driver_call():
    with profiling.tracing():
        _run(n_frames=2)
        _run(n_frames=2)
    taken = profiling.take()
    requests = [s for s in taken.spans if s.name == "request"]
    assert len(requests) == 2 and requests[0].id != requests[1].id
    assert all(r.parent == 0 and r.request == r.id for r in requests)
    for s in taken.spans:
        inside = [r for r in requests if r.start_ns <= s.start_ns and s.end_ns <= r.end_ns]
        assert [s.request] == [r.id for r in inside]
    assert taken.counters["requests"] == 2 and taken.counters["frames"] == 4


def test_driver_calls_inside_an_operators_span_keep_their_own_request_ids():
    with profiling.tracing():
        with profiling.span("batch"):
            _run(n_frames=2)
            _run(n_frames=2)
    taken = profiling.take()
    batch = taken.spans[0]
    requests = [s for s in taken.spans if s.name == "request"]
    assert batch.name == "batch" and batch.request == 0
    assert len(requests) == 2 and all(r.parent == batch.id for r in requests)
    assert requests[0].id != requests[1].id
    for s in taken.spans[1:]:
        (r,) = [r for r in requests if r.start_ns <= s.start_ns and s.end_ns <= r.end_ns]
        assert s.request == r.id


@pytest.mark.parametrize("kw", [dict(), dict(switch_association_known=False)],
                         ids=["known", "gated_augment"])
def test_driver_outputs_equal_with_tracing_on_and_off(kw):
    off = _run(**kw)
    with profiling.tracing():
        on = _run(**kw)
    assert profiling.take().counters["frames"] == 4
    for a, b in zip((*off[0], *off[1]), (*on[0], *on[1])):
        assert torch.equal(a, b)


def _children(spans, parent):
    return [s.name for s in spans if s.parent == parent.id]


@pytest.mark.parametrize("kw,n_frames,augment,per_span", [
    pytest.param(dict(enable_augment=False), 5, False, 1, id="known"),
    pytest.param(dict(switch_association_known=False, enable_augment=True), 5, True, 1,
                 id="gated_augment"),
    pytest.param(dict(enable_augment=False, frame_pair=True), 6, False, 2, id="pair"),
])
def test_driver_spans_a_frame_with_its_children_in_order(kw, n_frames, augment, per_span):
    with profiling.tracing():
        _run(n_frames=n_frames, **kw)
    taken = profiling.take()
    (request,) = [s for s in taken.spans if s.name == "request"]
    assert request.attrs == {}
    frames = [s for s in taken.spans if s.name == "frame"]
    assert len(frames) == n_frames // per_span
    assert _children(taken.spans, request) == ["request.setup"] + ["frame"] * len(frames)
    want = FRAME_CHILDREN[:3] + ["frame.augment"] * augment + FRAME_CHILDREN[3:]
    for fr in frames:
        assert fr.attrs == ({"frames": 2} if per_span == 2 else {})
        assert _children(taken.spans, fr) == want
    assert taken.counters == {"requests": 1, "frames": n_frames}
    assert taken.launches == {} and taken.dropped == 0        # the CPU launches no kernel


def test_a_kernel_call_is_a_launch_span(monkeypatch):
    """``CudaKernel.__call__`` opens a ``launch`` span naming the entry and
    its kernels, and ``take()`` reports the launches it counted (a stand-in
    library and stream on the CPU)."""
    from conan_slam_tpu_torch.ops import cuda, frame_kernel  # noqa: F401  (registers H9)

    kernel = next(k for k in cuda.KERNELS.values() if k.launches_per_call == 2)
    class Entry:
        def __call__(self, *args):
            return 0                                    # cudaSuccess

    lib = SimpleNamespace(**{kernel.symbol: Entry()})
    monkeypatch.setattr(cuda, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda d: profiling._OFF)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(kernel, "launches", kernel.launches)
    with profiling.tracing():
        with profiling.span("frame.update"):
            kernel(torch.device("cpu"))
            kernel(torch.device("cpu"))
    taken = profiling.take()
    launches = [s for s in taken.spans if s.name == "launch"]
    assert len(launches) == 2
    assert all(s.attrs == {"kernel": kernel.name, "launches": 2} for s in launches)
    assert all(s.parent == taken.spans[0].id for s in launches)
    assert taken.launches == {kernel.name: 4}
