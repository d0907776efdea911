"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library of its own with a plain C interface under
``build/kernels/`` at the repository root, named by a hash of the source
so an edited kernel is rebuilt, and loaded with ``ctypes``: the mapper
kernels (``library``) and the instruction bi-LSTM (``lstm_library``).
Nothing is built or loaded at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Tuple

import torch

_ROOT = Path(__file__).resolve().parents[2]
_SRC = _ROOT / "ivlnce_tpu_torch" / "csrc" / "mapper_kernels.cu"
_LSTM_SRC = _ROOT / "ivlnce_tpu_torch" / "csrc" / "instruction_lstm.cu"
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
_lstm_lib = None
build_log = ""  # the mapper library's compiler output
lstm_build_log = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _compile(src: Path) -> Tuple[Path, str]:
    """Compile ``src`` if this source has no library yet; the library's
    path and the compiler's output, which is kept beside it."""
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    out = BUILD_DIR / f"lib{src.stem}-{digest}.so"
    log = out.with_suffix(".log")
    if out.exists():
        return out, log.read_text() if log.exists() else ""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", tmp, str(src)],
        capture_output=True, text=True,
    )
    text = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {src}:\n{text}")
    log.write_text(text)
    os.replace(tmp, out)
    return out, text


def build() -> Path:
    """Compile the mapper kernels if this source has no library yet
    (``build_log``: the compiler's output)."""
    global build_log
    out, build_log = _compile(_SRC)
    return out


def library() -> ctypes.CDLL:
    """The loaded mapper kernel library, built on first call."""
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


def lstm_library() -> ctypes.CDLL:
    """The loaded instruction bi-LSTM library, built on first call
    (``lstm_build_log``: the compiler's output)."""
    global _lstm_lib, lstm_build_log
    if _lstm_lib is not None:
        return _lstm_lib
    path, lstm_build_log = _compile(_LSTM_SRC)
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.instruction_lstm_rows.argtypes = [p] * 6 + [i] * 4 + [p]
    lib.instruction_lstm_rows.restype = i
    lib.instruction_lstm_error_string.argtypes = [i]
    lib.instruction_lstm_error_string.restype = ctypes.c_char_p
    _lstm_lib = lib
    return lib


def check(err: int, name: str) -> None:
    """Raise on a nonzero ``cudaGetLastError()`` from a launch."""
    if err != 0:
        # either library's cudaGetErrorString
        msg = (_lib.mapper_error_string(err) if _lib is not None
               else _lstm_lib.instruction_lstm_error_string(err)).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")
