"""What PyTorch's gloo backend does with CUDA tensors on one card, for the
sharded runtime's route table (``parallel.mesh.ROUTES``).

1. Support: each collective alone, float32, int32 and int16, on two fresh
   gloo ranks sharing card 0 (a refused one can end its process: gloo
   writes a device pointer to its socket), with its values checked.
2. Latency: µs a call of a 12-byte all-reduce and a small and a large
   all-gather, two ranks on card 0, for CUDA tensors (``all_reduce`` over
   a zero-filled buffer, as the table routes them, and gloo's own
   all-gather) and for CPU tensors (the host's transport alone).

    python -m conan_slam_tpu_torch.benchmarks.probe_collectives

Needs a CUDA card.  Prints one line an operation, then a JSON line.

It stays beside the route table because no CPU test can see what gloo
does with CUDA tensors: the table's gloo row and ``BIT_VIEWS`` rest on
its support list, and PERF.md's latency of one collective comes from it.
Run it again when the card's PyTorch changes.
"""

from __future__ import annotations

import datetime
import json
import os
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

OPS = [f"{op} {dt}" for dt in ("float32", "int32", "int16")
       for op in ("all_gather", "all_gather_into_tensor", "all_reduce_SUM", "all_reduce_MAX",
                  "all_reduce_MIN", "broadcast")]
OPS += ["batch_isend_irecv float32", "reduce_scatter_tensor float32"]


def _init(rank: int, path: str) -> torch.device:
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{path}", rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=20))
    return dev


def _support(rank: int, path: str, op: str, q) -> None:
    dev = _init(rank, path)
    kind, name = op.split()
    dt = getattr(torch, name)
    t = torch.full((4,), rank + 1, dtype=dt, device=dev)
    try:
        if kind == "all_gather":
            out = [torch.empty_like(t) for _ in range(2)]
            dist.all_gather(out, t)
            ok = [int(o[0]) for o in out] == [1, 2]
        elif kind == "all_gather_into_tensor":
            out = torch.empty(8, dtype=dt, device=dev)
            dist.all_gather_into_tensor(out, t)
            ok = [int(out[0]), int(out[4])] == [1, 2]
        elif kind.startswith("all_reduce"):
            red = kind.split("_")[-1]
            dist.all_reduce(t, op=getattr(dist.ReduceOp, red))
            ok = int(t[0]) == {"SUM": 3, "MAX": 2, "MIN": 1}[red]
        elif kind == "broadcast":
            dist.broadcast(t, 0)
            ok = int(t[0]) == 1
        elif kind == "batch_isend_irecv":
            r = torch.empty_like(t)
            for w in dist.batch_isend_irecv([dist.P2POp(dist.isend, t, 1 - rank),
                                             dist.P2POp(dist.irecv, r, 1 - rank)]):
                w.wait()
            ok = int(r[0]) == 2 - rank
        else:
            out = torch.empty(4, dtype=dt, device=dev)
            dist.reduce_scatter_tensor(out, torch.ones(8, dtype=dt, device=dev))
            ok = int(out[0]) == 2
        torch.cuda.synchronize()
        q.put((rank, "ok" if ok else "wrong values"))
    except Exception as e:   # the probe's answer: what the backend raised
        q.put((rank, f"raises {type(e).__name__}: {str(e).splitlines()[0][:80]}"))


def _latency(rank: int, path: str, q) -> None:
    dev = _init(rank, path)
    out = {}

    def gathered(t):
        blocks = [torch.empty_like(t) for _ in range(2)]
        dist.all_gather(blocks, t)

    def reduced(t):
        buf = torch.zeros((2, *t.shape), dtype=t.dtype, device=t.device)
        buf[rank] = t
        dist.all_reduce(buf)

    for where, device in (("cuda", dev), ("cpu", torch.device("cpu"))):
        for label, shape, reps in (("12 B", (3,), 300), ("320 B", (2, 40), 300),
                                   ("2.6 MB", (128, 5008), 20)):
            t = torch.ones(shape, device=device)
            for route, fn in (("all_reduce", reduced), ("all_gather", gathered)):
                fn(t)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(reps):
                    fn(t)
                torch.cuda.synchronize()
                out[f"{where} {route} {label}"] = 1e6 * (time.perf_counter() - t0) / reps
    q.put((rank, out))


def _pair(target, *args) -> list:
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    path = os.path.join(tempfile.mkdtemp(), "store")
    procs = [ctx.Process(target=target, args=(r, path, *args, q)) for r in range(2)]
    for p in procs:
        p.start()
    got = []
    for _ in range(2):
        try:
            got.append(q.get(timeout=60))
        except Exception:   # a rank that died answers nothing
            got.append((None, "no answer"))
    for p in procs:
        p.join(10)
        if p.is_alive():
            p.kill()
    return [g[1] for g in sorted(got, key=lambda g: (g[0] is None, g[0] or 0))] + [
        [p.exitcode for p in procs]]


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_collectives: needs a CUDA card", file=sys.stderr)
        return 1
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    res = {"support": {}}
    for op in OPS:
        *ranks, codes = _pair(_support, op)
        res["support"][op] = {"ranks": ranks, "exit": codes}
        print(f"{op}: {ranks} (exit codes {codes})", flush=True)
    lat, _, _ = _pair(_latency)
    res["latency_us"] = lat
    for k, v in (lat.items() if isinstance(lat, dict) else []):
        print(f"{k}: {v:,.1f} us", flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
