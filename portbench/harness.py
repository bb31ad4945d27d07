"""One run of one cell: set-up, the measured window, the traced stretch,
the comparison, and the result line.

A cell is the file ``traffic/<cell>.json``; it names its configuration,
``configs/<config>.json``.  End-to-end metrics are the readers in
``e2e/``, per-layer metrics the readers in ``metrics/``, and the port's
kernels the names in ``kernels/*.json``: each found by its file name, so a
new cell, metric or kernel list is a new file.

The window replays the log through the port's replay driver,
``conan_slam_tpu_torch.runner.loop.run_ekf_slam_precomputed``, in
requests of ``request_frames`` frames, closed loop with one client: a
request starts from the state the last one returned and ends when its last
estimated pose is on the host.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import statistics
import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
ROLLOUT_CACHE = ROOT / ".portbench_cache" / "rollouts"
FORBIDDEN = ("jax", "jaxlib", "flax", "conan_slam_tpu", "benchmarks")
TIE_REL = 0.01          # the judge's tie margin on the gated path (judge.py)


class Refused(SystemExit):
    """The run cannot give a result: it exits non-zero and prints none."""

    def __init__(self, why: str):
        print(f"portbench: {why}", file=sys.stderr)
        super().__init__(2)


def load(kind: str, name: str) -> dict:
    path = BENCH / kind / f"{name}.json"
    if not path.is_file():
        known = sorted(p.stem for p in (BENCH / kind).glob("*.json"))
        raise Refused(f"no {kind} file {path.name} (there are: {', '.join(known)})")
    return json.loads(path.read_text())


def readers(kind: str) -> dict:
    """{name: module} of the readers in ``<kind>/*.py``."""
    out = {}
    for path in sorted((BENCH / kind).glob("*.py")):
        if path.stem.startswith("_"):
            continue
        spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{path.stem}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[path.stem] = mod
    return out


def port_kernels() -> list[str]:
    names: set[str] = set()
    for path in sorted((BENCH / "kernels").glob("*.json")):
        names.update(json.loads(path.read_text())["kernels"])
    return sorted(names)


def filter_numbers(config: dict) -> dict:
    """The configuration's vehicle, sensor, noise and filter numbers."""
    out = {}
    for group in ("vehicle", "sensor", "noise", "filter"):
        out.update(config[group])
    return out


def padded_dim(capacity: int, pad: int) -> int:
    d = 3 + 2 * capacity
    return -(-d // pad) * pad if pad and d > pad else d


def start_state(config: dict, traffic: dict, lm: np.ndarray, dtype, device):
    """(x, P, n_active, table) of the first request: the whole map
    registered with an independent sigma0^2 I block each ("registered"),
    or an empty map of ``capacity`` slots ("empty")."""
    import torch

    m = config["map"]
    n_ids = lm.shape[0]
    registered = m["start"] == "registered"
    capacity = n_ids if registered else traffic["capacity"]
    d = padded_dim(capacity, m["pad_multiple"])
    x = torch.zeros((d,), dtype=dtype, device=device)
    p = torch.zeros((d, d), dtype=dtype, device=device)
    table = torch.full((n_ids,), -1, dtype=torch.int64, device=device)
    n_active = 0
    if registered:
        x[3:3 + 2 * n_ids] = torch.as_tensor(lm, device=device).reshape(-1).to(dtype)
        p.diagonal()[3:3 + 2 * n_ids] = m["sigma0"] ** 2
        table = torch.arange(n_ids, device=device)
        n_active = n_ids
    return x, p, n_active, table


@dataclass
class Log:
    """The replayed log on the card: truth, returns and noise draws."""

    truth: tuple          # x_true (T, 3), swa (T,), active (T,), done (T,)
    returns: tuple        # z_true (F, NZ, 2), ids (F, NZ) int64, mask (F, NZ)
    ctrl_noise: object    # (F, S, 2)
    obs_noise: object     # (F, NZ, 2)
    interval: int
    n_frames: int

    def nbytes(self) -> int:
        ts = (*self.truth, *self.returns, self.ctrl_noise, self.obs_noise)
        return sum(t.numel() * t.element_size() for t in ts)


def rollout(config: dict, traffic: dict, lm: np.ndarray, cache_dir: Path | None):
    """The cell's truth and returns (numpy), which no seed changes: made by
    ``gen/`` on a checkout's first run of the cell and kept under
    ``cache_dir`` (a fixed path inside the checkout), keyed by the cell's
    files and the generators' sources, like a build."""
    from portbench.gen import rollout as gen_rollout, world

    nums = filter_numbers(config)
    interval = nums["observe_interval"]
    n_frames = traffic["rollout_frames"]
    key = hashlib.sha256(json.dumps([config, traffic], sort_keys=True).encode())
    for src in ("gen/rollout.py", "gen/world.py"):
        key.update((BENCH / src).read_bytes())
    path = None if cache_dir is None else cache_dir / f"{key.hexdigest()[:24]}.npz"
    if path is not None and path.is_file():
        with np.load(path) as f:
            return (gen_rollout.Truth(f["x_true"], f["swa"], f["active"], f["done"]),
                    gen_rollout.Returns(f["z_true"], f["ids"], f["mask"]))
    truth = gen_rollout.rollout_truth(world.WAYPOINTS, nums, n_frames * interval)
    if truth.done.any():
        raise Refused("the cell's course ends inside its rollout: raise its laps")
    rets = gen_rollout.rollout_returns(truth.x_true, lm, nums["max_range"],
                                       min(lm.shape[0], nums["max_obs"]), interval)
    if path is not None:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp.npz")
        np.savez(tmp, **truth._asdict(), **rets._asdict())
        os.replace(tmp, path)
    return truth, rets


def make_log(config: dict, traffic: dict, lm: np.ndarray, seed: int, device,
             cache_dir: Path | None = None) -> Log:
    """The log on ``device``: the cell's rollout and the seed's noise
    draws, made on the device from ``seed`` in two calls."""
    import torch

    truth, rets = rollout(config, traffic, lm, cache_dir)
    interval = filter_numbers(config)["observe_interval"]
    n_frames = traffic["rollout_frames"]
    dev = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=device)  # noqa: E731
    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    nz = rets.ids.shape[1]
    return Log(truth=tuple(dev(a) for a in truth),
               returns=(dev(rets.z_true), dev(rets.ids, torch.int64), dev(rets.mask)),
               ctrl_noise=torch.randn((n_frames, interval, 2), generator=gen, device=device),
               obs_noise=torch.randn((n_frames, nz, 2), generator=gen, device=device),
               interval=interval, n_frames=n_frames)


def ref_frames(log: Log, f0: int, f1: int) -> list:
    from portbench.reference.ekf import Frame

    s = log.interval
    x_true, swa, active, done = log.truth
    z, ids, mask = log.returns
    act = active[f0 * s:f1 * s].cpu().tolist()
    dn = done[f0 * s:f1 * s].cpu().tolist()
    return [Frame(x_true=x_true[f * s:(f + 1) * s], swa=swa[f * s:(f + 1) * s],
                  active=act[(f - f0) * s:(f - f0 + 1) * s], done=dn[(f - f0 + 1) * s - 1],
                  ctrl_noise=log.ctrl_noise[f], z_true=z[f], ids=ids[f], mask=mask[f],
                  obs_noise=log.obs_noise[f])
            for f in range(f0, f1)]


@dataclass
class Snap:
    """A state copied aside at a request's edge, into buffers made in
    set-up (so the copy allocates nothing inside the window)."""

    x: object
    p: object
    n_active: object
    table: object

    def take(self, st):
        self.x.copy_(st.x)
        self.p.copy_(st.p)
        self.n_active.copy_(st.n_active)
        self.table.copy_(st.table)

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (self.x, self.p, self.n_active, self.table))


@dataclass
class Window:
    steps: int = 0
    wall_s: float = 0.0
    latencies_ms: list = field(default_factory=list)
    peak_bytes: int = 0
    harness_bytes: int = 0
    setup_s: float = 0.0


DRIVER = "run_ekf_slam_precomputed"
LAYER_SPANS = ("ekf_precomp_frame_step", "associate_known", "fused_frame_step",
               "factor_and_associate_gated", "fused_frame_update", "augment", "_noisy_obs")
SPAN_NAMES = (DRIVER, "pose_to_host", *LAYER_SPANS)


@contextmanager
def _no_span(name: str):
    yield


@contextmanager
def spans(on: bool):
    """torch.profiler ranges around the driver's calls into each layer
    (``runner.loop``'s names for them), for the traced run only."""
    if not on:
        yield
        return
    from torch.profiler import record_function

    from conan_slam_tpu_torch.runner import loop

    saved = [(n, getattr(loop, n)) for n in LAYER_SPANS]
    for n, fn in saved:
        def wrapped(*a, _fn=fn, _n=n, **kw):
            with record_function(_n):
                return _fn(*a, **kw)
        setattr(loop, n, wrapped)
    try:
        yield
    finally:
        for n, fn in saved:
            setattr(loop, n, fn)


def run(cell: str, seed: int, seconds: float, trace: bool, device=None, program=None,
        traffic: dict | None = None, control: str | None = None,
        cache_dir: Path | None = ROLLOUT_CACHE) -> dict:
    """One run of ``cell``; returns the result line as a dict.  ``device``,
    ``program`` (the replay driver) and ``traffic`` (the cell's file's
    contents) are for the harness's own tests: the benchmark's runs take
    the card, the port's driver and ``traffic/<cell>.json``.  ``cache_dir``
    keeps the cell's rollout (``rollout``; None makes it anew).
    ``control`` (a precision of ``reference/ekf.py``) is for
    ``calibrate.py``: the control then replays each sampled request from
    the program's start state in that precision, and its numbers come back
    under ``control_checks``."""
    t_setup = time.perf_counter()
    traffic = traffic or load("traffic", cell)
    config = load("configs", traffic["config"])
    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < traffic["chips"]:
            raise Refused(f"cell {cell} needs {traffic['chips']} CUDA device(s); PyTorch sees "
                          f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = torch.device("cuda", 0)
    try:
        from conan_slam_tpu_torch.config import SlamConfig
        from conan_slam_tpu_torch.filters.ekf.state import EKFState
        from conan_slam_tpu_torch.runner.loop import run_ekf_slam_precomputed
        from conan_slam_tpu_torch.sim.world import World
    except ImportError as e:
        raise Refused(f"the program under test is not in this checkout ({e})")
    program = program or run_ekf_slam_precomputed
    from portbench import judge as judge_mod
    from portbench.gen import world
    from portbench.reference.ekf import Filter, State
    from portbench.roofline.bounds import frame_bound_us

    on_card = device.type == "cuda"
    nums = filter_numbers(config)
    cfg = SlamConfig(**{k: v for k, v in nums.items() if k in SlamConfig.__dataclass_fields__})
    if cfg.observe_interval != nums["observe_interval"]:
        raise Refused("the configuration's observe_interval disagrees with its rates")
    wd = traffic["world"]
    lm = world.landmarks(wd["landmarks"], wd["seed"], wd["extent"])
    wrld = World(landmarks=torch.as_tensor(lm, device=device),
                 waypoints=torch.as_tensor(world.WAYPOINTS, device=device))
    log = make_log(config, traffic, lm, seed, device, cache_dir)
    x0, p0, n0, table0 = start_state(config, traffic, lm, torch.float32, device)
    d = x0.shape[0]
    state0 = EKFState(x=x0, p=p0, n_active=torch.tensor(n0, device=device), table=table0)
    f_req, s = traffic["request_frames"], log.interval

    def request(st, k):
        f0, f1 = k * f_req, (k + 1) * f_req
        part = (tuple(a[f0 * s:f1 * s] for a in log.truth), tuple(a[f0:f1] for a in log.returns))
        with span(DRIVER):
            st, outs = program(wrld, cfg, None, f_req * s, st, part,
                               ctrl_noise=log.ctrl_noise[f0:f1], obs_noise=log.obs_noise[f0:f1])
        with span("pose_to_host"):
            outs.x_est[-1].to("cpu")
        return st, outs

    rng = np.random.default_rng([abs(int(seed)), 7])
    picked = sorted({0, *(int(v) for v in rng.integers(1, traffic["sample_within"],
                                                        traffic["sampled_requests"] - 1))})
    edges = sorted({k for j in picked for k in (j, j + 1)} - {0})
    snaps = {k: Snap(torch.empty_like(x0), torch.empty_like(p0),
                     torch.empty((), dtype=torch.int64, device=device), torch.empty_like(table0))
             for k in edges}
    kept: dict[int, tuple] = {}
    if trace:
        from torch.profiler import record_function as span
    else:
        span = _no_span

    with spans(trace):
        warm = EKFState(*(t.clone() for t in state0))
        for k in range(2):
            warm, _ = request(warm, k)
        del warm
        if trace:
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
                torch.zeros(1, device=device).add_(1)
                if on_card:
                    torch.cuda.synchronize()
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        win = Window(setup_s=time.perf_counter() - t_setup,
                     harness_bytes=sum(sn.nbytes() for sn in snaps.values()) + log.nbytes())

        prof, traced = None, None
        st, k = state0, 0
        del state0, x0, p0
        t0 = time.perf_counter()
        t_end = t0
        while True:
            if (k + 1) * f_req > log.n_frames:
                raise Refused(f"the window outran its traffic after {k} requests: the cell's "
                              "rollout_frames is too short for this program")
            # The traced stretch holds no copy of a state the harness takes
            # aside (its device time is not the program's).
            if (trace and prof is None and t_end - t0 >= traffic["trace_after_s"]
                    and not any(k <= e <= k + traffic["trace_requests"] for e in snaps)):
                prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                prof.start()
                traced = [k, time.perf_counter()]
            t_req = time.perf_counter()
            st, outs = request(st, k)
            t_end = time.perf_counter()
            if prof is not None and len(traced) == 2 and k + 1 - traced[0] == traffic["trace_requests"]:
                traced += [k + 1, t_end]
                prof.stop()
            win.latencies_ms.append((t_end - t_req) * 1e3)
            if k in picked:
                kept[k] = (outs.x_est.clone(), outs.n_active.clone())
            k += 1
            if k in snaps:
                snaps[k].take(st)
            if t_end - t0 >= seconds:
                break
        win.steps = k * f_req * s
        win.wall_s = t_end - t0
        n_window = k
        print(f"portbench: window {win.wall_s:.3f} s, {win.steps} steps, {n_window} requests, "
              f"request ms median {statistics.median(win.latencies_ms):.3f}, "
              f"slowest {max(win.latencies_ms):.3f}", file=sys.stderr)
        if on_card:
            win.peak_bytes = torch.cuda.max_memory_allocated(device)
        if trace and (traced is None or len(traced) < 4):
            raise Refused("the window closed before its traced stretch ended: lengthen the "
                          "window or shorten trace_requests")
        # The sampled requests past the window's close, answered now.
        while k <= max(picked):
            st, outs = request(st, k)
            if k in picked:
                kept[k] = (outs.x_est.clone(), outs.n_active.clone())
            k += 1
            if k in snaps:
                snaps[k].take(st)
    del st, outs
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    # The comparison.
    filt = Filter({**nums, "tie_rel": TIE_REL}, "float64")

    def start_of(j: int, dtype) -> State:
        if j == 0:
            return State(*start_state(config, traffic, lm, dtype, device))
        sn = snaps[j]
        return State(sn.x.to(dtype), sn.p.to(dtype), int(sn.n_active), sn.table.clone())

    worst: dict[str, float] = {}
    worst_control: dict[str, float] = {}
    for j in picked:
        frames = ref_frames(log, j * f_req, (j + 1) * f_req)
        end = snaps[j + 1]
        x_est, n_act = kept[j]
        prog = {"x_est": x_est, "n_active": n_act.cpu(), "x": end.x, "p": end.p,
                "table": end.table.cpu()}
        for name, v in judge_mod.judge(filt, start_of(j, torch.float64), frames, prog).items():
            worst[name] = max(worst.get(name, 0.0), v)
        if control:
            for name, v in control_numbers(control, nums, cfg, log, start_of(j, torch.float32),
                                           j, f_req, filt, start_of(j, torch.float64)).items():
                worst_control[name] = max(worst_control.get(name, 0.0), v)
    limits = {**config["limits"], **traffic["limits"]}
    checks = {name: {"value": worst[name], "limit": lim} for name, lim in limits.items()}

    # The metrics.
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(device) if on_card else "cpu", "count": 1,
                   "memory_peak_bytes": win.peak_bytes}
    extra = {}
    if trace:
        from portbench import tracing

        path = "known" if nums["switch_association_known"] else "gated"
        bound = frame_bound_us(path, d, log.returns[0].shape[1], s, nums["switch_heading_known"])
        dig = tracing.digest(prof, frames=(traced[2] - traced[0]) * f_req,
                             wall_us=(traced[3] - traced[1]) * 1e6, kernels=port_kernels(),
                             frame_bound_us=bound[0], span_names=SPAN_NAMES)
        metrics = read_all("metrics", dig)
        device_info.update(busy_s=dig.busy_us / 1e6, window_s=dig.wall_us / 1e6)
        extra["breakdown"] = tracing.breakdown(dig)
    else:
        metrics = read_all("e2e", win)
    if control:
        extra["control_checks"] = {name: {"value": worst_control.get(name, float("inf")),
                                          "limit": lim} for name, lim in limits.items()}
    return {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
            "attempted": n_window, "failed": 0, "metrics": metrics, "device": device_info,
            **extra, "ties": worst.get("ties", 0.0), "checks": checks}


def read_all(kind: str, source) -> dict:
    """Every reader of ``kind`` that finds something to read in ``source``."""
    out = {}
    for name, mod in readers(kind).items():
        v = mod.read(source)
        if v is not None:
            out[name] = {"value": v, "unit": mod.UNIT}
    return out


def control_numbers(precision: str, nums: dict, cfg, log: Log, start32, j: int, f_req: int,
                    filt, start64) -> dict:
    """The judge's numbers for the control on request ``j``: the reference
    in ``precision`` from the program's start state, in the program's
    place.  A control that fails (a covariance that is no longer positive
    definite) reads inf."""
    import torch

    from portbench import control, judge as judge_mod
    from conan_slam_tpu_torch.filters.ekf.state import EKFState

    f0, f1, s = j * f_req, (j + 1) * f_req, log.interval
    st = EKFState(start32.x, start32.p, torch.tensor(start32.n_active, device=start32.x.device),
                  start32.table)
    part = (tuple(a[f0 * s:f1 * s] for a in log.truth), tuple(a[f0:f1] for a in log.returns))
    try:
        new, outs = control.driver(nums, precision)(None, cfg, None, f_req * s, st, part,
                                                    ctrl_noise=log.ctrl_noise[f0:f1],
                                                    obs_noise=log.obs_noise[f0:f1])
    except torch.linalg.LinAlgError:
        return {"cov_gap": float("inf"), "pose_gap_m": float("inf"), "map_mismatch": float("inf")}
    prog = {"x_est": outs.x_est, "n_active": outs.n_active.cpu(), "x": new.x, "p": new.p,
            "table": new.table.cpu()}
    return judge_mod.judge(filt, start64, ref_frames(log, f0, f1), prog)


def loaded_forbidden() -> list[str]:
    """Modules in ``sys.modules`` whose top-level name is forbidden in a
    benchmark run (compared whole: ``conan_slam_tpu_torch`` is allowed)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
