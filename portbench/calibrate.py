"""The readings the comparison's limits are set from: the program on many
seeds (the lower readings) and the control, the plain reference in TF32 in
the program's place, on a few (the upper readings), at the cell's own
size, in one process.  The benchmark's own runs never run this.

    python3 portbench/calibrate.py --workload <cell> --seeds 12 --control-seeds 3 --seconds 2

Prints one JSON line a seed: every number the judge computes, and the
control's under ``control``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import harness
    from portbench.run import run_environment

    run_environment(ROOT)
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        t0 = time.perf_counter()
        res = harness.run(args.workload, seed, args.seconds, False,
                          control="tf32" if i < args.control_seeds else None)
        line = {"workload": args.workload, "seed": seed, "correct": res["correct"],
                "s": round(time.perf_counter() - t0, 1), "ties": res["ties"],
                "program": {k: v["value"] for k, v in res["checks"].items()}}
        if "control_checks" in res:
            line["control"] = {k: v["value"] for k, v in res["control_checks"].items()}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
