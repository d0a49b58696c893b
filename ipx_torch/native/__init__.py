"""Native (C++) MPS tokenizer: build and ctypes bindings.

``mps_parser.cpp`` tokenizes and parses MPS text for large files.  It is
compiled with ``g++`` at first use into the package's build directory
(``ipx_torch.kernels._build.build_dir()``, ``build/ipx_torch/`` by default),
named by a hash of the source and the flags, so the source tree is never
written.  Every consumer handles ``load_mps_lib() is None`` (no C++
toolchain, or a failed build) by taking the pure-Python parser: the C++ side
only tokenizes, and the semantics live in ``ipx_torch/problem/mps.py``, so
both give the same result by construction.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

from ipx_torch.kernels._build import build_dir

SRC = Path(__file__).resolve().parent / "mps_parser.cpp"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return build_dir() / f"mps_parser-{h.hexdigest()[:16]}.so"


def _build(lib: Path) -> bool:
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        return False
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, lib)        # atomic: a concurrent process sees all or none
    return True


def load_mps_lib():
    """Return the ctypes-bound parser library, building it on first use.
    Returns None when it cannot be built (no C++ toolchain)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = library_path()
        if not path.exists() and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        lib.ipx_mps_parse.restype = ctypes.c_void_p
        lib.ipx_mps_parse.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                      ctypes.c_char_p, ctypes.c_int64]
        lib.ipx_mps_counts.restype = None
        lib.ipx_mps_counts.argtypes = [ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_int64)]
        lib.ipx_mps_name.restype = ctypes.c_char_p
        lib.ipx_mps_name.argtypes = [ctypes.c_void_p]
        lib.ipx_mps_obj_rhs.restype = ctypes.c_double
        lib.ipx_mps_obj_rhs.argtypes = [ctypes.c_void_p]
        lib.ipx_mps_fill.restype = None
        lib.ipx_mps_fill.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 12
        lib.ipx_mps_free.restype = None
        lib.ipx_mps_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib
