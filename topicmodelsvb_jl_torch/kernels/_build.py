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

:func:`check_dtype` is the one gate on the state's dtype: it says, before
anything is allocated, whether a family runs in that dtype on a device
along the mesh axes it uses, from the kernels that run reaches.
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


# The kernels each family's step and bound launch on the card.
FAMILY_KERNELS = {
    "LDA": ("lda_estep", "lda_elbo_tok", "scatter_rows"),
    "fLDA": ("flda_estep", "scatter_rows"),
    "CTM": ("lda_elbo_tok", "scatter_rows"),
    "fCTM": ("scatter_rows",),
    "CTPF": ("ctpf_estep", "scatter_rows"),
    "DTM": ("scatter_rows",),
    "HMTM": ("hmtm_estep", "hmtm_logz", "scatter_rows"),
}
# The mesh axes each family runs on: the data axis, the vocab axis that
# shards the tables' storage (and CTPF's user axis), and the two that split
# a document's token slots, the routed vocab axis and the sequence axis.
FAMILY_AXES = {
    "LDA": ("data", "vocab", "routed", "seq"),
    "fLDA": ("data", "vocab", "seq"),
    "CTM": ("data", "vocab", "seq"),
    "fCTM": ("data", "vocab", "seq"),
    "CTPF": ("data", "vocab", "user", "seq"),
    "DTM": ("data", "vocab"),
    "HMTM": ("data", "vocab"),
}
# The pass modes an axis that splits the token slots adds (CTM and fCTM
# sum their per-pass statistic in plain tensor code and add none).
AXIS_KERNELS = {
    ("LDA", "routed"): ("lda_estep_pass",),
    ("LDA", "seq"): ("lda_estep_pass",),
    ("fLDA", "seq"): ("flda_estep_pass",),
    ("CTPF", "seq"): ("ctpf_estep_pass",),
}
# Kernels with a float64 mode; every kernel has a float32 one.  All ten
# have both, so every family runs float32 or float64 on the card along
# every axis; the table stays the gate's one source.
FLOAT64_KERNELS = frozenset({
    "scatter_rows", "lda_estep", "lda_elbo_tok", "flda_estep", "ctpf_estep", "hmtm_estep",
    "hmtm_logz", "lda_estep_pass", "flda_estep_pass", "ctpf_estep_pass"})


def kernels_of(family: str, axes=()) -> tuple:
    """The kernels ``family`` launches on the card along ``axes`` (mesh
    axis kinds from :data:`FAMILY_AXES`)."""
    if family not in FAMILY_KERNELS:
        raise ValueError(f"unknown model family {family!r}")
    for ax in axes:
        if ax not in FAMILY_AXES[family]:
            raise ValueError(f"{family} has no {ax} axis (it has {FAMILY_AXES[family]})")
    extra = tuple(k for ax in axes for k in AXIS_KERNELS.get((family, ax), ()))
    return FAMILY_KERNELS[family] + extra


def check_dtype(family: str, dtype, device, axes=()) -> None:
    """Raise ``TypeError`` unless ``family`` runs with state dtype
    ``dtype`` (a torch dtype or its name) on ``device`` along ``axes``.

    A CPU device runs the plain versions, in any dtype.  A CUDA device
    launches the kernels, and every kernel the run reaches
    (:func:`kernels_of`) must have a mode of that dtype: float32 always,
    float64 where :data:`FLOAT64_KERNELS` has it.  The message names the
    first kernel that lacks the mode.  Nothing is allocated, and no
    device is touched."""
    name = str(dtype).replace("torch.", "")
    kind = getattr(device, "type", None) or str(device).split(":")[0]
    kernels = kernels_of(family, axes)
    if kind != "cuda" or name == "float32":
        return
    if name != "float64":
        raise TypeError(f"{family} in {name} on CUDA: the kernels run float32 or float64")
    for k in kernels:
        if k not in FLOAT64_KERNELS:
            via = next((ax for ax in axes if k in AXIS_KERNELS.get((family, ax), ())), None)
            where = f" (the {via} axis's pass mode)" if via else ""
            raise TypeError(
                f"{family} in float64 on CUDA: the {k} kernel{where} has no float64 mode; "
                "run float32 on the card, or float64 with device='cpu'")
