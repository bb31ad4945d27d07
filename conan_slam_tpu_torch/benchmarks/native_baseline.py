"""The native C++ baseline on the bench workload (port of ``bench.py``'s
``bench_native``): the denominator of ``vs_baseline``.

    python -m conan_slam_tpu_torch.benchmarks.native_baseline [steps]

The bench world (``benchmarks.world.bench_world``: 1024 landmarks from
numpy seed 42, all pre-registered with sigma 1 m) through
``conan_slam_tpu_torch.native.run_ekf_baseline`` for NATIVE_STEPS (2,400;
the native filter is steady-state from step 1) from seed 42: the
reference-style scalar loops, then the SIMD-scheduled path (``opt``).
Prints the reference's two lines and the host's CPU model; the
denominator is the better of the two steps/s, as ``bench.py`` takes it.
"""

from __future__ import annotations

import os
import platform
import sys

from conan_slam_tpu_torch import native
from conan_slam_tpu_torch.benchmarks.world import (
    N_LANDMARKS,
    NATIVE_STEPS,
    SEED,
    SIGMA0,
    bench_world,
)


def cpu_model() -> str:
    """The host's CPU model and its cores: /proc/cpuinfo's model name, or
    where a virtual machine leaves that "unknown", its vendor, family and
    model numbers."""
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                info.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    model = info.get("model name")
    if model in (None, "", "unknown") and "vendor_id" in info:
        model = (f"{info['vendor_id']} family {info.get('cpu family', '?')} model "
                 f"{info.get('model', '?')} (model name {model or 'absent'})")
    return f"{model or platform.processor() or platform.machine()}, {os.cpu_count()} cores"


def main(argv=None) -> dict:
    steps = int(argv[0]) if argv else NATIVE_STEPS
    lm, world, _ = bench_world(N_LANDMARKS, "cpu")
    wp = world.waypoints.numpy()
    for name in ("slam_baseline", "hostsim"):
        path, secs, _ = native.build(name)
        print(f"native build: {path} ({secs:.1f} s)", flush=True)
    print(f"host CPU: {cpu_model()}", flush=True)
    out = {}
    for name, label, opt in (("scalar", "native scalar:", False), ("simd", "native SIMD:  ", True)):
        r = native.run_ekf_baseline(lm, wp, steps, seed=SEED, with_noise=True, prebuild_map=True,
                                    sigma0=SIGMA0, opt=opt)
        print(f"{label} {r.steps} steps in {r.seconds:.3f}s ({r.steps_per_s:,.0f} steps/s), "
              f"ATE={r.ate_rmse:.3f} m", flush=True)
        out[name] = dict(steps=r.steps, seconds=r.seconds, steps_per_s=r.steps_per_s,
                         ate_m=r.ate_rmse)
    out["denominator_steps_per_s"] = max(out["scalar"]["steps_per_s"], out["simd"]["steps_per_s"])
    print(f"vs_baseline denominator: {out['denominator_steps_per_s']:,.1f} steps/s", flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
