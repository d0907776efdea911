"""Trajectory store: keyed blob database for collected episodes.

Replaces py-lmdb + msgpack_numpy (reference dagger_trainer.py:148-155,
332-371). Values are msgpack with a numpy extension encoding (arrays as
{b"__nd__": shape/dtype/bytes}); the storage engine is the native C++
append-only store (native/store.cpp) with a format-compatible
pure-Python engine. The PyTorch counterpart of
``ivlnce_tpu/trainers/trajectory_store.py``: the same format, so each
package reads the stores the other writes.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Dict, Iterator, Optional

import msgpack
import numpy as np

from ivlnce_tpu_torch import native

_MAGIC = struct.pack("<II", 0x53545649, 1)


# -----------------------------------------------------------------------------
# msgpack <-> numpy
# -----------------------------------------------------------------------------
def _encode(obj):
    if isinstance(obj, np.ndarray):
        return {
            b"__nd__": True,
            b"dtype": obj.dtype.str,
            b"shape": list(obj.shape),
            b"data": obj.tobytes(),
        }
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    raise TypeError(f"cannot serialize {type(obj)}")


def _decode(obj):
    if isinstance(obj, dict) and (b"__nd__" in obj or "__nd__" in obj):
        b = obj.get(b"dtype", obj.get("dtype"))
        shape = obj.get(b"shape", obj.get("shape"))
        data = obj.get(b"data", obj.get("data"))
        return np.frombuffer(data, dtype=np.dtype(b)).reshape(shape).copy()
    return obj


def packb(obj) -> bytes:
    return msgpack.packb(obj, default=_encode, use_bin_type=True)


def unpackb(data: bytes):
    return msgpack.unpackb(
        data, object_hook=_decode, raw=False, strict_map_key=False
    )


# -----------------------------------------------------------------------------
# storage engines
# -----------------------------------------------------------------------------
class _PyStore:
    """Pure-Python engine writing the identical IVTS format."""

    def __init__(self, path: str, writable: bool):
        self.path = path
        self.writable = writable
        mode = "r+b" if os.path.exists(path) else "w+b"
        if not writable:
            mode = "rb"
        self._f = open(path, mode)
        self._index: Dict[bytes, tuple] = {}
        self._scan()

    def _scan(self):
        f = self._f
        f.seek(0, os.SEEK_END)
        size = f.tell()
        if size == 0:
            if not self.writable:
                raise FileNotFoundError(self.path)
            f.write(_MAGIC)
            f.flush()
            self._end = 8
            return
        f.seek(0)
        if f.read(8) != _MAGIC:
            raise ValueError(f"not an IVTS store: {self.path}")
        off = 8
        while off + 12 <= size:
            f.seek(off)
            keylen = struct.unpack("<I", f.read(4))[0]
            if off + 4 + keylen + 8 > size:
                break
            key = f.read(keylen)
            vallen = struct.unpack("<Q", f.read(8))[0]
            val_off = off + 4 + keylen + 8
            if val_off + vallen > size:
                break
            self._index[key] = (val_off, vallen)
            off = val_off + vallen
        self._end = off

    def put(self, key: bytes, value: bytes):
        assert self.writable
        f = self._f
        f.seek(self._end)
        f.write(struct.pack("<I", len(key)))
        f.write(key)
        f.write(struct.pack("<Q", len(value)))
        val_off = self._end + 4 + len(key) + 8
        f.write(value)
        self._index[key] = (val_off, len(value))
        self._end = val_off + len(value)

    def get(self, key: bytes) -> Optional[bytes]:
        entry = self._index.get(key)
        if entry is None:
            return None
        off, length = entry
        self._f.seek(off)
        return self._f.read(length)

    def count(self) -> int:
        return len(self._index)

    def sync(self):
        self._f.flush()
        os.fsync(self._f.fileno())

    def refresh(self):
        self._index.clear()
        self._scan()

    def keys(self):
        return list(self._index.keys())

    def close(self):
        self._f.close()


class _NativeStore:
    def __init__(self, path: str, writable: bool):
        self._lib = native.store_library()
        if self._lib is None:
            raise OSError("native store unavailable")
        self._h = self._lib.ts_open(path.encode(), 1 if writable else 0)
        if not self._h:
            raise OSError(f"cannot open store {path}")

    def put(self, key: bytes, value: bytes):
        rc = self._lib.ts_put(self._h, key, len(key), value, len(value))
        if rc != 0:
            raise OSError("ts_put failed")

    def get(self, key: bytes) -> Optional[bytes]:
        import ctypes

        n = self._lib.ts_get(self._h, key, len(key), None, 0)
        if n < 0:
            return None
        buf = ctypes.create_string_buffer(n)
        got = self._lib.ts_get(self._h, key, len(key), buf, n)
        if got != n:
            raise OSError("ts_get failed")
        return buf.raw

    def count(self) -> int:
        return int(self._lib.ts_count(self._h))

    def sync(self):
        self._lib.ts_sync(self._h)

    def refresh(self):
        self._lib.ts_refresh(self._h)

    def close(self):
        if self._h:
            self._lib.ts_close(self._h)
            self._h = None


class TrajectoryStore:
    """Keyed trajectory DB with msgpack-numpy values.

    API mirrors the trainers' LMDB usage: integer-string keys, count()
    for dataset length, drop() to reset (dagger_trainer.py:517-521)."""

    def __init__(self, path: str, writable: bool = False):
        # ``path`` may be the reference's ".lmdb" directory convention;
        # store a single file inside/alongside it
        if path.endswith(".lmdb") or os.path.isdir(path):
            os.makedirs(path, exist_ok=True)
            path = os.path.join(path, "data.ivts")
        else:
            parent = os.path.dirname(path)
            if parent:
                os.makedirs(parent, exist_ok=True)
        self.path = path
        self.writable = writable
        self._engine = self._make_engine()

    def _make_engine(self):
        try:
            return _NativeStore(self.path, self.writable)
        except OSError:
            return _PyStore(self.path, self.writable)

    @staticmethod
    def drop(path: str):
        if path.endswith(".lmdb") or os.path.isdir(path):
            file_path = os.path.join(path, "data.ivts")
        else:
            file_path = path
        if os.path.exists(file_path):
            os.remove(file_path)

    def put(self, key, value: Any):
        self._engine.put(str(key).encode(), packb(value))

    def get(self, key) -> Any:
        raw = self._engine.get(str(key).encode())
        if raw is None:
            raise KeyError(key)
        return unpackb(raw)

    def __contains__(self, key) -> bool:
        return self._engine.get(str(key).encode()) is not None

    def count(self) -> int:
        return self._engine.count()

    def sync(self):
        self._engine.sync()

    def refresh(self):
        self._engine.refresh()

    def close(self):
        self._engine.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
