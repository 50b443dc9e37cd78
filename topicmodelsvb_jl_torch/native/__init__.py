"""ctypes loader for the native corpus parser (``tmvb_native.cpp``).

Compiled with ``g++`` at first use into ``topicmodelsvb_jl_torch/_build/``
(the library's name carries a hash of the source, so a stale build is
never loaded).  When no compiler or library is available,
:func:`parse_delimited_ints` returns None and ``corpus.readcorp`` parses
in pure Python: the native parser speeds loading up and is never required.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "tmvb_native.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_i64p = ctypes.POINTER(ctypes.c_int64)


def _library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return _BUILD_DIR / f"libtmvb_native_{digest}.so"


def _build(out: Path) -> bool:
    # compile to a private temp name and os.replace into place: concurrent
    # processes (test workers) may build at once, and dlopen of a
    # half-written library fails or loads garbage
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", str(_SRC), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, out)
    return True


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        out = _library_path()
        if not out.exists() and not _build(out):
            return None
        try:
            lib = ctypes.CDLL(str(out))
        except OSError:
            return None
        lib.tmvb_count.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_char, _i64p, _i64p]
        lib.tmvb_count.restype = None
        lib.tmvb_parse.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_char, _i64p, _i64p]
        lib.tmvb_parse.restype = ctypes.c_int64
        _lib = lib
        return _lib


def parse_delimited_ints(data: bytes, delim: str = ","):
    """Parse a text buffer of delimited integers into CSR form.

    Returns (values int64 [n_vals], line_offsets int64 [n_lines + 1]), or
    None when the native library is unavailable or ``delim`` is not one
    byte.  Raises ValueError on a malformed byte, mirroring the
    reference's per-document load error (Corpus.jl:298).
    """
    d = delim.encode()
    if len(d) != 1:
        return None
    lib = get_lib()
    if lib is None:
        return None
    n = len(data)
    n_lines = ctypes.c_int64(0)
    n_vals = ctypes.c_int64(0)
    lib.tmvb_count(data, n, d, ctypes.byref(n_lines), ctypes.byref(n_vals))
    vals = np.empty(max(n_vals.value, 1), dtype=np.int64)
    offs = np.zeros(n_lines.value + 1, dtype=np.int64)
    rc = lib.tmvb_parse(data, n, d, vals.ctypes.data_as(_i64p), offs.ctypes.data_as(_i64p))
    if rc != 0:
        raise ValueError(f"malformed integer near byte {rc - 1}")
    return vals[: offs[-1]], offs
