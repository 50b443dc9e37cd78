"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``),
one ``nvcc`` per source, all started together, and the objects are linked
into ONE shared library with a plain C interface, loaded with ``ctypes``.
No PyTorch header is included, so a build takes seconds.

* The build happens at first use, from this package's sources only, into
  ``topicmodelsvb_jl_torch/_build/``.  The library's file name carries a
  hash of the sources and flags, so a stale build is never loaded.
* No ``--use_fast_math``: it would turn ``expf``/``logf`` into
  approximate intrinsics, and the bound's accuracy depends on them.
* Each C entry point returns ``cudaGetLastError()`` after its launch;
  :func:`check` raises on anything but 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_lib = None
_functions = {}   # name -> the C entry point, its argument types declared


def _sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit "
                           "to build the kernels")
    return found


def library_path() -> Path:
    """Path of the library built from the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libtmvb_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library of the same hash exists.

    The compiler's resource report (``-Xptxas=-v``: registers, shared
    memory, spills) is kept beside the library as ``.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    jobs = []
    for src in _sources():
        if src.suffix != ".cu":
            continue
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log = []
    for cmd, _, proc in jobs:
        text = proc.communicate()[0]
        log.append(text)
        if proc.returncode != 0:
            for _, _, other in jobs:
                other.wait()
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{text}")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in jobs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    for _, obj, _ in jobs:
        obj.unlink()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    out.with_suffix(".log").write_text("".join(log) + proc.stdout + proc.stderr)
    os.replace(tmp, out)   # atomic: a concurrent loader sees all or nothing
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.tmvb_error_string.argtypes = [ctypes.c_int]
            lib.tmvb_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def function(name: str, argtypes: list, restype=ctypes.c_int):
    """The C entry point ``name`` with its argument and result types
    declared; looked up once per process."""
    fn = _functions.get(name)
    if fn is None:
        fn = getattr(_load(), name)
        fn.argtypes = argtypes
        fn.restype = restype
        _functions[name] = fn
    return fn


def launch(fn, device, *args) -> int:
    """``fn(*args, stream)`` on the current stream of the CUDA ``device``,
    made the current device only when it is not already; returns the C
    entry point's error code."""
    import torch

    if device.index is None or device.index == torch.cuda.current_device():
        return fn(*args, torch.cuda.current_stream(device).cuda_stream)
    with torch.cuda.device(device):
        return fn(*args, torch.cuda.current_stream(device).cuda_stream)


def require(what: str, device, specs: dict) -> None:
    """Raise unless every ``name: (tensor, shape, dtype)`` in ``specs`` is
    a contiguous tensor of that shape and dtype on ``device``."""
    for name, (t, shape, dtype) in specs.items():
        if t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{what}: {name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = _load().tmvb_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
