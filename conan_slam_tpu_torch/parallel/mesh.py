"""The process mesh of the sharded runtime (port of
conan_slam_tpu.parallel.mesh).

The reference's scaling axes, as there:

- ``state``: row blocks of the joint EKF covariance,
- ``particles``: the particle ensemble.

The reference lays a ``jax.sharding.Mesh`` over devices and lets XLA place
the collectives of its ``shard_map`` kernels.  Here a mesh is laid over the
ranks of an initialised ``torch.distributed`` process group, row-major over
the axes as the reference reshapes its devices, and every collective is an
explicit call on one ``Axis``: the ranks that differ only in that axis's
coordinate, one process group each.

``psum``, ``pmax`` and ``pmin`` are one ``all_reduce`` on every route (a
ring or tree all-reduce leaves each sum's bits on one rank and copies
them, so a replicated sum is the same bits on every rank; the tests
hold every replicated output to that).  The all-gather and the ring
shift are one gather of the ranks' blocks, and how that runs is a table
keyed by (backend, device type), ``ROUTES``: NCCL and gloo on CPU tensors
gather natively; for CUDA tensors PyTorch documents only ``broadcast``
and ``all_reduce`` on gloo, so there the gather is an ``all_reduce`` over
a zero-filled buffer in which each rank writes only its own block, which
is exact (a sum with zeros).  Neither backend takes ``int16`` (the i16
gain wire), so it travels as an exact ``int32`` bit view
(``BIT_VIEWS``).

Every collective can be recorded (``Mesh.recording``): its logical bytes,
what XLA's collective of the same shape moves (an all-gather's or an
all-reduce's output, a permute's block), and the bytes of the buffer the
backend call was handed (the transport's).
"""

from __future__ import annotations

import contextlib
import itertools
import math
import os
import socket
from typing import NamedTuple

import torch
import torch.distributed as dist

STATE_AXIS = "state"
PARTICLE_AXIS = "particles"

# How the ranks' blocks are gathered, keyed by (backend, device type):
#   native:     dist.all_gather into a list of blocks
#   all_reduce: dist.all_reduce over an (n, ...) zero-filled buffer, each
#               rank writing its own block (exact)
# psum / pmax / pmin are dist.all_reduce (SUM / MAX / MIN) on every route.
ROUTES = {
    ("gloo", "cpu"): "native",
    ("gloo", "cuda"): "all_reduce",
    ("nccl", "cuda"): "native",
}
# Element types neither backend takes, and the type whose bit view carries
# them (the last dimension is paired up).
BIT_VIEWS = {torch.int16: torch.int32}


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


class Collective(NamedTuple):
    """One recorded collective: ``logical`` bytes as XLA's collective of the
    same shape moves them (an all-gather's or an all-reduce's output, a
    permute's block), ``transport`` the bytes of the buffer the backend
    call was handed."""

    axis: str
    op: str
    shape: tuple
    dtype: str
    logical: int
    transport: int


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Axis:
    """One mesh axis as this rank sees it: its ``size``, this rank's
    coordinate ``index`` on it, and its collectives over the ranks that
    share every other coordinate (global ``ranks``, in axis order)."""

    def __init__(self, mesh: "Mesh", name: str, ranks: list[int], group,
                 route: str | None = None):
        self.mesh = mesh
        self.name = name
        self.ranks = ranks
        self.size = len(ranks)
        self.index = ranks.index(mesh.rank)
        self.group = group
        key = (mesh.backend, mesh.device.type)
        if route is None and key not in ROUTES:
            raise ValueError(f"no collective route for backend {mesh.backend!r} on "
                             f"{mesh.device.type} tensors (routes: {sorted(ROUTES)})")
        self.route = ROUTES[key] if route is None else route
        if self.route not in ("native", "all_reduce"):
            raise ValueError(f"unknown gather route {self.route!r}")

    # -- recording

    def _record(self, op: str, t: torch.Tensor, logical: int, transport: int) -> None:
        if self.mesh.records is not None:
            self.mesh.records.append(Collective(self.name, op, tuple(t.shape),
                                                str(t.dtype).replace("torch.", ""),
                                                logical, transport))

    # -- the transport

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as the backend takes it: contiguous, and an exact bit view
        where the backend lacks its element type."""
        t = t.contiguous()
        carrier = BIT_VIEWS.get(t.dtype)
        return t if carrier is None else t.view(carrier)

    def _unwire(self, t: torch.Tensor, dtype) -> torch.Tensor:
        return t if t.dtype == dtype else t.view(dtype)

    def _blocks(self, t: torch.Tensor) -> tuple[list[torch.Tensor], int]:
        """Every rank's ``t`` (same shape and type on every rank), in axis
        order, and the bytes of the buffer the backend was handed."""
        w = self._wire(t)
        if self.route == "native":
            out = [torch.empty_like(w) for _ in range(self.size)]
            dist.all_gather(out, w, group=self.group)
            return [self._unwire(b, t.dtype) for b in out], self.size * _nbytes(w)
        buf = torch.zeros((self.size, *w.shape), dtype=w.dtype, device=w.device)
        buf[self.index] = w
        dist.all_reduce(buf, group=self.group)
        return [self._unwire(b, t.dtype) for b in buf.unbind(0)], _nbytes(buf)

    # -- the collectives of the reference's kernels

    def _reduce(self, t: torch.Tensor, op, name: str) -> torch.Tensor:
        out = self._wire(t).clone()
        if out.dtype != t.dtype:
            raise ValueError(f"{name}: {t.dtype} has no reduction on {self.mesh.backend}")
        dist.all_reduce(out, op=op, group=self.group)
        self._record(name, t, _nbytes(t), _nbytes(out))
        return out

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``t``, the same bits on every rank."""
        return self._reduce(t, dist.ReduceOp.SUM, "psum")

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise max over the ranks (exact)."""
        return self._reduce(t, dist.ReduceOp.MAX, "pmax")

    def pmin(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise min over the ranks (exact)."""
        return self._reduce(t, dist.ReduceOp.MIN, "pmin")

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim`` in axis order (the
        reference's tiled all-gather)."""
        blocks, moved = self._blocks(t)
        out = torch.cat(blocks, dim)
        self._record("all_gather", t, _nbytes(out), moved)
        return out

    def ppermute(self, t: torch.Tensor, shift: int = 1) -> torch.Tensor:
        """The ring permute: rank i's ``t`` goes to rank (i + shift) mod n;
        returns the block of rank (i - shift) mod n, taken from the
        gather (n blocks on the wire where a point-to-point exchange
        moves one; gloo has no send on CUDA tensors)."""
        blocks, moved = self._blocks(t)
        self._record("ppermute", t, _nbytes(t), moved)
        return blocks[(self.index - shift) % self.size].clone()


class Mesh:
    """A mesh over every rank of the default process group: ``shape``
    maps each axis name to its size (row-major, as the reference's device
    array), ``axis(name)`` gives this rank's view of one axis, and every
    tensor of the sharded kernels lives on ``device``.  ``route`` names
    the gather's route in place of ``ROUTES``' entry for this backend and
    device (both routes run on CPU tensors)."""

    def __init__(self, axis_sizes: dict[str, int], device: torch.device,
                 route: str | None = None):
        self.rank = dist.get_rank()
        self.world_size = dist.get_world_size()
        self.backend = dist.get_backend()
        self.device = device
        self.shape = dict(axis_sizes)
        self.records: list[Collective] | None = None
        names = tuple(axis_sizes)
        sizes = tuple(axis_sizes[n] for n in names)
        if math.prod(sizes) != self.world_size:
            raise ValueError(f"mesh {axis_sizes} needs {math.prod(sizes)} ranks, the process "
                             f"group has {self.world_size}")
        coords = list(itertools.product(*(range(s) for s in sizes)))   # rank r -> coords[r]
        self._axes = {}
        for a, name in enumerate(names):
            # Every rank creates every group, in the same order.
            others = sorted({c[:a] + c[a + 1:] for c in coords})
            for rest in others:
                ranks = [coords.index(rest[:a] + (k,) + rest[a:]) for k in range(sizes[a])]
                group = dist.new_group(ranks)
                if self.rank in ranks:
                    self._axes[name] = Axis(self, name, ranks, group, route)

    def axis(self, name: str) -> Axis:
        return self._axes[name]

    @contextlib.contextmanager
    def recording(self):
        """Record every collective of the block; yields the list."""
        saved, self.records = self.records, []
        try:
            yield self.records
        finally:
            self.records = saved


def rank_device() -> torch.device:
    """This rank's card: ``LOCAL_RANK`` mod the cards this host has (one
    card: every rank on card 0)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the sharded paths on the CPU")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    return torch.device("cuda", local % torch.cuda.device_count())


_MESHES: dict = {}


def make_mesh(axis_sizes: dict[str, int] | None = None,
              device: torch.device | str | None = None) -> Mesh:
    """Build a mesh over the initialised process group.  Default: every
    rank on the ``state`` axis; ``axis_sizes`` e.g. ``{"state": 2,
    "particles": 2}``, whose product must be the world size.  ``device``
    defaults to this rank's card (``rank_device``).  Every rank calls it
    alike; a mesh already made over the same process group is reused (its
    groups made once).

    NCCL takes one device a rank: it raises when two ranks of the group
    would share one (several ranks on one card run over gloo)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: initialise the process group first (parallel.launch)")
    device = rank_device() if device is None else torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if not axis_sizes:
        axis_sizes = {STATE_AXIS: dist.get_world_size()}
    if dist.get_backend() == "nccl":
        if device.type != "cuda":
            raise ValueError("NCCL runs on CUDA tensors only: use gloo for the CPU")
        torch.cuda.set_device(device)
        seen = [None] * dist.get_world_size()
        dist.all_gather_object(seen, (socket.gethostname(), device.index))
        if len(set(seen)) != len(seen):
            raise ValueError(f"NCCL needs one device a rank, but ranks share one: {seen}; "
                             "run several ranks on one card over gloo")
    key = (id(dist.group.WORLD), tuple(axis_sizes.items()), device)
    if key not in _MESHES:
        _MESHES[key] = Mesh(axis_sizes, device)
    return _MESHES[key]
