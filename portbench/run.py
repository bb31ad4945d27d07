"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the result as one JSON line, the last of standard output, and the
numbers the comparison judged, each beside its limit, as the last lines of
standard error.  Exits non-zero, printing no result, where the card or the
program under test is missing, where the window outruns the cell's log, or
where a forbidden module (JAX, the JAX package, the root ``benchmarks``)
is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True, help="a cell: portbench/traffic/<cell>.json")
    ap.add_argument("--seed", required=True, type=int)
    ap.add_argument("--seconds", required=True, type=float, help="the measured window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seconds <= 0:
        ap.error("--seconds must be positive")
    return args


def run_environment(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    port builds its CUDA library into conan_slam_tpu_torch/build/), and one
    host thread for numpy's and PyTorch's own pools: the client is one
    process whose Python thread dispatches the work."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    cache = root / ".portbench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    args = parse(argv)
    run_environment(ROOT)
    sys.path.insert(0, str(ROOT))
    import torch

    torch.set_num_threads(1)
    from portbench import harness

    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace))
    found = harness.loaded_forbidden()
    if found:
        print(f"portbench: forbidden modules loaded in the run's process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    print(f"correct: {result['correct']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
