"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface under ``build/kernels/`` at the
repository root, named by a hash of the source so an edited kernel is
rebuilt, and loaded with ``ctypes``. Nothing is built or loaded at
import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_ROOT = Path(__file__).resolve().parents[2]
_SRC = _ROOT / "ivlnce_tpu_torch" / "csrc" / "mapper_kernels.cu"
BUILD_DIR = _ROOT / "build" / "kernels"
# ``-cudart shared`` links the CUDA runtime PyTorch has already loaded, so
# a profiler sees these launches as it sees PyTorch's own
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-cudart", "shared",
    "-Xptxas", "-v",
]

_lib = None
build_log = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> Path:
    """Compile the mapper kernels if this source has no library yet. The
    compiler's output (``build_log``) is kept beside the library."""
    global build_log
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:12]
    out = BUILD_DIR / f"libmapper_kernels-{digest}.so"
    log = out.with_suffix(".log")
    if out.exists():
        build_log = log.read_text() if log.exists() else ""
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", tmp, str(_SRC)],
        capture_output=True, text=True,
    )
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {_SRC}:\n{build_log}")
    log.write_text(build_log)
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mapper_accumulate_scratch_bytes.argtypes = [i] * 3
    lib.mapper_accumulate_scratch_bytes.restype = ctypes.c_longlong
    lib.mapper_accumulate.argtypes = [p] * 10 + [i] * 4 + [f] * 5 + [p]
    lib.mapper_accumulate.restype = i
    lib.mapper_rasterize.argtypes = [p] * 7 + [i] * 5 + [f] * 5 + [p]
    lib.mapper_rasterize.restype = i
    lib.mapper_rasterize_resident_clusters.argtypes = [
        i, i, ctypes.POINTER(ctypes.c_int)]
    lib.mapper_rasterize_resident_clusters.restype = i
    lib.mapper_known_load_scratch_bytes.argtypes = [i] * 3
    lib.mapper_known_load_scratch_bytes.restype = ctypes.c_longlong
    lib.mapper_known_load.argtypes = [p] * 9 + [i] * 3 + [f] * 2 + [p]
    lib.mapper_known_load.restype = i
    lib.mapper_error_string.argtypes = [i]
    lib.mapper_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def check(err: int, name: str) -> None:
    """Raise on a nonzero ``cudaGetLastError()`` from a launch."""
    if err != 0:
        msg = _lib.mapper_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")

