"""Build and load the CUDA kernels of ``ipx_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers), is
compiled by ``nvcc`` for ``sm_90a`` into a shared library at first use, and is
loaded with ``ctypes``.  Libraries go to ``build/ipx_torch/`` beside the
package (override with ``IPX_TORCH_BUILD_DIR``), named by a hash of the
source, the shared headers (``csrc/*.cuh``) and the flags, so an unchanged
source is compiled once.  Nothing is
built at import: machines without ``nvcc`` import every module and run the
plain versions on CPU tensors.  A failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("fused_matvec", "row_matvec", "assemble_sym", "factor_panels",
           "fused_panel", "solve_panels", "cholesky_right", "accum_panel")
# Largest m of the panel-major factor and pair-solve
# (``kernels.cholesky.MAX_M``).  The sources are compiled with it and
# ``csrc/solve_panels.cu`` fails to compile if it outgrows one block's shared
# memory, so this is the only place the limit is written.
PANEL_MAX_M = 4864
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC",
              f"-DIPX_PANEL_MAX_M={PANEL_MAX_M}")

_libs: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    d = os.environ.get("IPX_TORCH_BUILD_DIR")
    return Path(d) if d else CSRC.parent.parent / "build" / "ipx_torch"


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe:
        return exe
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    exe = os.path.join(home, "bin", "nvcc")
    if os.path.exists(exe):
        return exe
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA kernels "
        "of ipx_torch are built from source at first use")


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):      # included by the sources
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source unless its library exists; returns
    (process or None, library path, temporary output path)."""
    src, lib = _target(name)
    if lib.exists():
        return None, lib, None
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, lib, tmp


def _finish(name: str, proc, lib: Path, tmp) -> Path:
    if proc is None:
        return lib
    out, _ = proc.communicate()
    if proc.returncode != 0:
        if tmp.exists():
            tmp.unlink()
        raise RuntimeError(f"nvcc failed on {name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, lib)        # atomic: a concurrent process sees all or none
    return lib


def build_all() -> float:
    """Compile every source, all ``nvcc`` processes started together.
    Returns the seconds taken."""
    t0 = time.perf_counter()
    jobs = [(name, *_start(name)) for name in SOURCES]
    for name, proc, lib, tmp in jobs:
        _libs[name] = ctypes.CDLL(str(_finish(name, proc, lib, tmp)))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if need be."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(_finish(name, *_start(name))))
        _libs[name] = lib
    return lib
