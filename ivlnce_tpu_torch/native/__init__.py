"""Native runtime components (C++ via ctypes), built on demand: the store
half of ``ivlnce_tpu/native/__init__.py``.

- libivlnce_store.so: append-only trajectory record store (LMDB
  replacement for the DAgger trainers).

``build()`` compiles with the in-tree Makefile into ``build/native/`` of
the checkout the first time a library is requested; the trajectory store
uses its format-compatible Python engine when no toolchain is available
(see trainers/trajectory_store.py).
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from typing import Optional

logger = logging.getLogger("ivlnce_tpu_torch")

_NATIVE_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_NATIVE_DIR)),
                         "build", "native")
_CACHE = {}


def build() -> bool:
    try:
        subprocess.run(
            ["make", "-s", "-C", _NATIVE_DIR, f"OUT={BUILD_DIR}"],
            check=True,
            capture_output=True,
        )
        return True
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        logger.warning("native build failed; using Python fallbacks: %s", e)
        return False


def load_library(name: str) -> Optional[ctypes.CDLL]:
    if name in _CACHE:
        return _CACHE[name]
    path = os.path.join(BUILD_DIR, name)
    # Always run the (incremental) build: binaries are not committed, and
    # make rebuilds a stale .so whenever its source changed, so a leftover
    # binary can never shadow the in-tree C++ sources.
    if not build() and not os.path.exists(path):
        _CACHE[name] = None
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        lib = None
    _CACHE[name] = lib
    return lib


def store_library() -> Optional[ctypes.CDLL]:
    lib = load_library("libivlnce_store.so")
    if lib is not None and not getattr(lib, "_ts_configured", False):
        lib.ts_open.restype = ctypes.c_void_p
        lib.ts_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.ts_put.restype = ctypes.c_int
        lib.ts_put.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
            ctypes.c_char_p, ctypes.c_uint64,
        ]
        lib.ts_get.restype = ctypes.c_int64
        lib.ts_get.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
            ctypes.c_char_p, ctypes.c_uint64,
        ]
        lib.ts_count.restype = ctypes.c_uint64
        lib.ts_count.argtypes = [ctypes.c_void_p]
        lib.ts_sync.restype = ctypes.c_int
        lib.ts_sync.argtypes = [ctypes.c_void_p]
        lib.ts_refresh.restype = ctypes.c_int
        lib.ts_refresh.argtypes = [ctypes.c_void_p]
        lib.ts_close.restype = None
        lib.ts_close.argtypes = [ctypes.c_void_p]
        lib._ts_configured = True
    return lib
