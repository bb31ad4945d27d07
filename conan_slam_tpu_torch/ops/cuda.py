"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

All ``csrc/*.cu`` compile with ``nvcc`` for Hopper (``sm_90a``) into ONE
shared library with a plain C interface, loaded with ``ctypes``: no PyTorch
headers, so the build takes seconds.  Each source compiles in its own
``nvcc`` process, all started together, and one more links the objects.
The build runs at first use, from the package's own sources, into
``build/`` beside them (listed in .gitignore), and again whenever a source
is newer than the library.

Every C entry point launches on the stream it is given, allocates nothing,
and returns ``cudaGetLastError()`` after its launch; ``CudaKernel`` raises on
a non-zero return and counts the launches that succeeded.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
LIB_PATH = BUILD_DIR / "libconan_slam_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
# Shared memory one block may use on Hopper (227 KB).
MAX_SMEM_BYTES = 232_448

_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return path


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    return any(src.stat().st_mtime > built for src in CSRC.iterdir())


def build(extra_flags: tuple[str, ...] = ()) -> tuple[Path, float, str]:
    """Compile ``csrc/*.cu`` if the library is missing or stale: one
    ``nvcc -c`` per source, all in parallel, then one link.

    Returns ``(library path, seconds spent building, compiler output)``;
    the seconds are 0.0 when the library was current.
    """
    if not _stale():
        return LIB_PATH, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}"
    t0 = time.perf_counter()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f".{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, *extra_flags, "-c", "-o", str(obj), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((cmd, obj, proc))
    outputs, failed = [], []
    for cmd, _, proc in jobs:
        out, _ = proc.communicate()
        outputs.append(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
    objs = [obj for _, obj, _ in jobs]
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = BUILD_DIR / f".{LIB_PATH.name}.{tag}.tmp"
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({res.returncode}):\n{' '.join(cmd)}\n{res.stdout}{res.stderr}"
            )
        os.replace(tmp, LIB_PATH)     # atomic: a concurrent loader sees old or new
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return LIB_PATH, time.perf_counter() - t0, "".join(outputs) + res.stdout + res.stderr


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        path, _, _ = build()
        lib = ctypes.CDLL(str(path))
        lib.csl_error_string.argtypes = [ctypes.c_int]
        lib.csl_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong
F = ctypes.c_float

KERNELS: dict[str, "CudaKernel"] = {}


class CudaKernel:
    """One C entry point of the library, with its launch count.

    ``source`` is the CUDA file in the repo, ``replaces`` the TPU kernel of
    the reference it ports (file:line).  The stream is appended to every
    call: PyTorch's current stream on the tensors' device.
    """

    def __init__(self, name: str, symbol: str, argtypes: list, source: str,
                 replaces: str):
        self.name = name
        self.symbol = symbol
        self.argtypes = list(argtypes) + [P]
        self.source = source
        self.replaces = replaces
        self.launches = 0
        KERNELS[name] = self

    def __call__(self, device: torch.device, *args) -> None:
        """Launch on ``device``'s current stream; ``args`` as ``argtypes``."""
        lib = library()
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        with torch.cuda.device(device):
            err = fn(*args, P(torch.cuda.current_stream(device).cuda_stream))
        if err != 0:
            msg = lib.csl_error_string(err).decode()
            raise RuntimeError(f"CUDA kernel {self.name} failed to launch: {msg} ({err})")
        self.launches += 1


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True if every tensor lies on the CPU (take the plain version), False
    if every one lies on the same CUDA device (launch the kernel); raises
    otherwise."""
    devices = {t.device for t in tensors}
    kinds = {d.type for d in devices}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"} and len(devices) == 1:
        return False
    raise ValueError(f"tensors must all be on the CPU or all on one CUDA device, got {devices}")


def check(t: torch.Tensor, name: str, shape: tuple, dtype=torch.float32) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``shape``/``dtype``."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def vector_stride(t: torch.Tensor, name: str, n: int, dtype=torch.float32) -> int:
    """Raise unless ``t`` is a CUDA vector of ``n`` elements of ``dtype``
    (any stride); return its stride in elements."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != (n,):
        raise ValueError(f"{name}: expected shape ({n},), got {tuple(t.shape)}")
    return t.stride(0)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return P(t.data_ptr())
