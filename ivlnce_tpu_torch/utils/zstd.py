"""zstd decompression through the system's ``libzstd.so.1``, bound with
``ctypes`` (Orbax checkpoints: OCDBT node bodies and zarr chunks are zstd
frames).

One route: the shared library found by ``ctypes.util.find_library("zstd")``.
The prototypes are declared here, so no header is needed. Python 3.12 has
no ``compression.zstd``, and the port takes no ``zstandard`` module. Without
the library, ``decompress`` raises; there is no second decoder to fall back
on. The library is loaded at the first call, never at import."""

from __future__ import annotations

import ctypes
import ctypes.util
import functools

# ZSTD_getFrameContentSize's two sentinels (zstd.h)
_CONTENTSIZE_UNKNOWN = 2**64 - 1
_CONTENTSIZE_ERROR = 2**64 - 2


class ZstdError(ValueError):
    """A frame libzstd refused, or input that holds no whole frame."""


class _InBuffer(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


class _OutBuffer(ctypes.Structure):
    _fields_ = [("dst", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


@functools.cache
def library() -> ctypes.CDLL:
    """``libzstd``, with the prototypes of the functions used here."""
    name = ctypes.util.find_library("zstd")
    if name is None:
        raise RuntimeError(
            "libzstd.so.1 was not found (ctypes.util.find_library('zstd')): "
            "reading an Orbax checkpoint needs the system's zstd library")
    lib = ctypes.CDLL(name)
    size_t, void_p = ctypes.c_size_t, ctypes.c_void_p
    for fn, restype, argtypes in (
        ("ZSTD_getFrameContentSize", ctypes.c_ulonglong, [void_p, size_t]),
        ("ZSTD_decompress", size_t, [void_p, size_t, void_p, size_t]),
        ("ZSTD_isError", ctypes.c_uint, [size_t]),
        ("ZSTD_getErrorName", ctypes.c_char_p, [size_t]),
        ("ZSTD_createDStream", void_p, []),
        ("ZSTD_freeDStream", size_t, [void_p]),
        ("ZSTD_initDStream", size_t, [void_p]),
        ("ZSTD_DStreamOutSize", size_t, []),
        ("ZSTD_decompressStream", size_t,
         [void_p, ctypes.POINTER(_OutBuffer), ctypes.POINTER(_InBuffer)]),
    ):
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    return lib


def _check(lib, code: int, what: str) -> int:
    if lib.ZSTD_isError(code):
        raise ZstdError(f"{what}: {lib.ZSTD_getErrorName(code).decode()}")
    return code


def decompress(data) -> bytes:
    """The content of the one zstd frame ``data`` (bytes-like). A frame
    that records its content size is decoded in one call into a buffer of
    that size; one that does not, through the streaming API. Raises
    ``ZstdError`` on anything but exactly one whole frame."""
    lib = library()
    src = bytes(data)
    if not src:
        raise ZstdError("no zstd frame: the input is empty")
    size = lib.ZSTD_getFrameContentSize(src, len(src))
    if size == _CONTENTSIZE_ERROR:
        raise ZstdError("not a zstd frame (bad magic or header)")
    if size != _CONTENTSIZE_UNKNOWN:
        out = ctypes.create_string_buffer(max(size, 1))
        n = _check(lib, lib.ZSTD_decompress(out, size, src, len(src)),
                   "ZSTD_decompress")
        if n != size:
            raise ZstdError(f"frame decoded to {n} bytes, its header says "
                            f"{size}")
        return ctypes.string_at(out, size)
    return _decompress_stream(lib, src)


def _decompress_stream(lib, src: bytes) -> bytes:
    stream = lib.ZSTD_createDStream()
    if not stream:
        raise MemoryError("ZSTD_createDStream")
    try:
        _check(lib, lib.ZSTD_initDStream(stream), "ZSTD_initDStream")
        chunk = lib.ZSTD_DStreamOutSize()
        out = ctypes.create_string_buffer(chunk)
        src_buf = ctypes.create_string_buffer(src, len(src))
        inb = _InBuffer(ctypes.cast(src_buf, ctypes.c_void_p), len(src), 0)
        parts = []
        while True:
            outb = _OutBuffer(ctypes.cast(out, ctypes.c_void_p), chunk, 0)
            left = _check(lib, lib.ZSTD_decompressStream(
                stream, ctypes.byref(outb), ctypes.byref(inb)),
                "ZSTD_decompressStream")
            parts.append(ctypes.string_at(out, outb.pos))
            if left == 0:  # the frame is complete
                break
            if inb.pos == inb.size and outb.pos < outb.size:
                raise ZstdError("truncated zstd frame")
        if inb.pos != inb.size:
            raise ZstdError(f"{inb.size - inb.pos} bytes after the zstd "
                            "frame")
        return b"".join(parts)
    finally:
        lib.ZSTD_freeDStream(stream)
