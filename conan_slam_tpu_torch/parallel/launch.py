"""Starting the ranks of the sharded runtime (the counterpart of the JAX
mesh's device enumeration and of ``jax.distributed.initialize``,
benchmarks/dcn_smoke.py:36-43).

``RankPool(n, device)`` starts ``n`` processes with the ``spawn`` start
method, each initialising the default process group (gloo, or NCCL with
``backend="nccl"``), and keeps them for any number of tasks:
``pool.run(fn, *args)`` runs ``fn(device, *args)`` in every rank at once
(``start`` and ``wait`` split it, so that pools work side by side),
with every numpy array of ``args`` made a tensor on the rank's device, and
returns each rank's result, tensors made numpy, in rank order.  ``run(fn,
n, ...)`` is one task on a pool of its own.

The rendezvous is a ``FileStore`` in a fresh temporary directory
(``init="file"``, as the tests use it) or ``env://`` over TCP on
localhost (``init="env"``: ``MASTER_ADDR`` and ``MASTER_PORT`` set for
every rank, as ``torchrun`` sets them).  Ranks that ``torchrun`` started,
one card a rank, call ``dist.init_process_group("nccl")`` and
``mesh.make_mesh()`` themselves.

A rank that raises, dies or outlives the task's timeout fails the task:
the pool kills every rank (its peers would wait in a collective) and
raises with the rank's traceback.  The process group's own timeout ends a
collective that waits on a dead peer.  Ranks print nothing to stdout,
and each runs one host thread.

Rank entry points are functions of the port (never of a test file: a
spawned rank imports its function's module, and nothing in a rank imports
JAX).
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import socket
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

# Seconds a collective may wait on its peers before the process group fails it.
COLLECTIVE_TIMEOUT = 120.0


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def to_torch(obj, device: torch.device):
    """``obj`` with every numpy array a tensor on ``device`` (through
    tuples, named tuples, lists and dicts)."""
    if isinstance(obj, np.ndarray):
        return torch.as_tensor(obj).to(device)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(to_torch(v, device) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_torch(v, device) for v in obj)
    if isinstance(obj, dict):
        return {k: to_torch(v, device) for k, v in obj.items()}
    return obj


def to_numpy(obj):
    """``obj`` with every tensor a numpy array (through the same
    containers as ``to_torch``)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(to_numpy(v) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_numpy(v) for v in obj)
    if isinstance(obj, dict):
        return {k: to_numpy(v) for k, v in obj.items()}
    return obj


def _init(rank: int, world_size: int, backend: str, init_method: str) -> None:
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT))


def _worker(rank: int, n: int, backend: str, init_method: str, env: dict, device_kind: str,
            tasks, results) -> None:
    sys.stdout = open(os.devnull, "w")       # the parent's stdout is its own
    os.environ.update(env, RANK=str(rank), WORLD_SIZE=str(n), LOCAL_RANK=str(rank))
    # One host thread a rank: the ranks' ops are small, and idle OpenMP
    # workers spinning in every rank starve the others' transports.
    torch.set_num_threads(1)
    try:
        if device_kind == "cpu":
            device = torch.device("cpu")
        else:
            from conan_slam_tpu_torch.parallel.mesh import rank_device

            device = rank_device()
            torch.cuda.set_device(device)
        _init(rank, n, backend, init_method)
    except Exception:
        results.put((rank, False, traceback.format_exc()))
        return
    while True:
        task = tasks.get()
        if task is None:
            break
        fn, args, kwargs = task
        try:
            out = fn(device, *to_torch(args, device), **kwargs)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            results.put((rank, True, to_numpy(out)))
        except Exception:
            results.put((rank, False, traceback.format_exc()))
            break
    dist.destroy_process_group()


class RankPool:
    """``n`` rank processes on ``device`` ("cuda": every rank on its card,
    LOCAL_RANK mod the host's cards; "cpu"), kept for many tasks."""

    def __init__(self, n: int, device: str = "cuda", backend: str | None = None,
                 init: str = "file", timeout: float = 600.0):
        if device not in ("cuda", "cpu"):
            raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
        if device == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the ranks on the CPU")
        self.n, self.device, self.timeout = n, device, timeout
        self.backend = backend or "gloo"
        self._tmp = tempfile.TemporaryDirectory(prefix="csl_ranks_")
        env = {}
        if init == "file":
            init_method = "file://" + os.path.join(self._tmp.name, "store")
        elif init == "env":
            env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port())}
            init_method = "env://"
        else:
            raise ValueError(f"init must be 'file' or 'env', got {init!r}")
        ctx = mp.get_context("spawn")
        self._results = ctx.Queue()
        self._tasks = [ctx.Queue() for _ in range(n)]
        self._procs = [ctx.Process(target=_worker, daemon=True,
                                   args=(r, n, self.backend, init_method, env, device,
                                         self._tasks[r], self._results))
                       for r in range(n)]
        for p in self._procs:
            p.start()
        self.closed = False
        self._pending = None

    def start(self, fn, *args, **kwargs) -> None:
        """Hand ``fn(device, *args, **kwargs)`` to every rank and return at
        once; ``wait`` collects it (one task in flight at a time)."""
        if self.closed:
            raise RuntimeError("the rank pool is closed")
        if self._pending is not None:
            raise RuntimeError("a task is already in flight: wait for it first")
        for q in self._tasks:
            q.put((fn, args, kwargs))
        self._pending = fn

    def run(self, fn, *args, timeout: float | None = None, **kwargs) -> list:
        """``fn(device, *args, **kwargs)`` in every rank; each rank's result
        in rank order.  Raises (and closes the pool) if a rank fails."""
        self.start(fn, *args, **kwargs)
        return self.wait(timeout)

    def wait(self, timeout: float | None = None) -> list:
        """The task in flight's result on every rank, in rank order."""
        fn, self._pending = self._pending, None
        deadline = time.monotonic() + (self.timeout if timeout is None else timeout)
        out: dict[int, object] = {}
        while len(out) < self.n:
            try:
                rank, ok, value = self._results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(self._procs) if not p.is_alive() and r not in out]
                if dead:
                    self.close(kill=True)
                    raise RuntimeError(f"rank(s) {dead} died (exit codes "
                                       f"{[self._procs[r].exitcode for r in dead]}) in {fn.__name__}")
                if time.monotonic() > deadline:
                    self.close(kill=True)
                    raise TimeoutError(f"{fn.__name__} did not finish on every rank in time")
                continue
            if not ok:
                self.close(kill=True)
                raise RuntimeError(f"rank {rank} failed in {fn.__name__}:\n{value}")
            out[rank] = value
        return [out[r] for r in range(self.n)]

    def close(self, kill: bool = False) -> None:
        if self.closed:
            return
        self.closed = True
        if not kill:
            for q in self._tasks:
                q.put(None)
            for p in self._procs:
                p.join(30)
        for p in self._procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        self._tmp.cleanup()

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close(kill=exc[0] is not None)


def run(fn, n: int, *args, device: str = "cuda", backend: str | None = None,
        init: str = "file", timeout: float = 600.0, **kwargs) -> list:
    """One task on ``n`` fresh ranks (``RankPool``)."""
    with RankPool(n, device, backend, init, timeout) as pool:
        return pool.run(fn, *args, **kwargs)
