"""A reader of tensorstore's OCDBT key-value store (the on-disk format of
Orbax checkpoints with ``use_ocdbt``), for the port, which has neither
tensorstore nor orbax.

The store is a directory. ``manifest.ocdbt`` holds the configuration, a
table of data files and the versions, each with the root of its B+tree.
The tree's nodes and the values too large to stay inline lie in data files
(``d/<name>``, or another writer's ``ocdbt.process_<i>/d/<name>`` that an
Orbax commit merged in), each at an offset and a length.

A manifest or a node is one file or part of one: a 4-byte big-endian
magic, the whole length as a little-endian u64, the format version and the
compression as varints, the body (a zstd frame, or raw), then a CRC-32C of
everything before it as a little-endian u32. A body's integers are varints
(LEB128) unless said otherwise, and its arrays of records are written
column by column. Anything this reader does not know (a magic, a version,
a compression, a value kind, a manifest kind) raises; it never guesses."""

from __future__ import annotations

import os
import struct
from typing import Dict, List, NamedTuple, Optional, Tuple

from ivlnce_tpu_torch.utils import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_NODE_MAGIC = 0x0CDB20DE
_FORMAT_VERSION = 0
_COMPRESSIONS = (0, 1)  # none, zstd
_HEADER = struct.Struct(">I")


class OcdbtFormatError(ValueError):
    """A file that is not OCDBT as this reader knows it."""


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as the OCDBT files end with."""
    c = 0xFFFFFFFF
    table = _CRC32C
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


class _Reader:
    """Cursor over a decoded body."""

    def __init__(self, data: bytes, where: str):
        self.data, self.pos, self.where = data, 0, where

    def varint(self) -> int:
        value, shift = 0, 0
        while True:
            if self.pos >= len(self.data):
                raise OcdbtFormatError(f"{self.where}: truncated varint")
            byte = self.data[self.pos]
            self.pos += 1
            value |= (byte & 0x7F) << shift
            if byte < 0x80:
                return value
            shift += 7
            if shift > 63:
                raise OcdbtFormatError(f"{self.where}: varint over 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise OcdbtFormatError(f"{self.where}: truncated body")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8s(self, n: int) -> List[int]:
        return list(self.take(n))

    def u64les(self, n: int) -> List[int]:
        return list(struct.unpack(f"<{n}Q", self.take(8 * n)))

    def done(self) -> None:
        if self.pos != len(self.data):
            raise OcdbtFormatError(
                f"{self.where}: {len(self.data) - self.pos} bytes left over")


def decode_file(raw: bytes, magic: int, where: str) -> bytes:
    """The body of one manifest or node: the header and CRC-32C checked,
    the body decompressed."""
    if len(raw) < 4 + 8 + 2 + 4:
        raise OcdbtFormatError(f"{where}: {len(raw)} bytes is too short")
    (got,) = _HEADER.unpack_from(raw)
    if got != magic:
        raise OcdbtFormatError(
            f"{where}: magic {got:#010x}, expected {magic:#010x}")
    (length,) = struct.unpack_from("<Q", raw, 4)
    if length != len(raw):
        raise OcdbtFormatError(
            f"{where}: header says {length} bytes, the file has {len(raw)}")
    (crc,) = struct.unpack_from("<I", raw, len(raw) - 4)
    if crc32c(raw[:-4]) != crc:
        raise OcdbtFormatError(f"{where}: CRC-32C mismatch")
    head = _Reader(raw[12:-4], where)
    version = head.varint()
    if version != _FORMAT_VERSION:
        raise OcdbtFormatError(f"{where}: unknown format version {version}")
    compression = head.varint()
    if compression not in _COMPRESSIONS:
        raise OcdbtFormatError(f"{where}: unknown compression {compression}")
    body = head.data[head.pos:]
    return zstd.decompress(body) if compression == 1 else body


class DataFile(NamedTuple):
    """A data file: its base path and its path relative to that, both
    relative to the store's directory. The data file tables of a node read
    from a file are relative to that file's base path."""

    base: str
    relative: str

    @property
    def path(self) -> str:
        return self.base + self.relative


def _data_file_table(r: _Reader, base: str) -> List[DataFile]:
    """``num_files``, then each path's length shared with the previous
    path (none for the first), its suffix's length and the length of its
    base path, then the suffixes."""
    n = r.varint()
    if n == 0:
        return []
    shared = [0] + r.varints(n - 1)
    suffix = r.varints(n)
    base_len = r.varints(n)
    files, prev = [], b""
    for i in range(n):
        if shared[i] > len(prev) or base_len[i] > shared[i] + suffix[i]:
            raise OcdbtFormatError(f"{r.where}: bad data file table")
        path = prev[:shared[i]] + r.take(suffix[i])
        files.append(DataFile(base + path[:base_len[i]].decode(),
                              path[base_len[i]:].decode()))
        prev = path
    for f in files:
        if ".." in f.path.split("/") or f.path.startswith("/"):
            raise OcdbtFormatError(f"{r.where}: data file {f.path} leaves "
                                   "the store")
    return files


class Location(NamedTuple):
    file: DataFile
    offset: int
    length: int


def _locations(r: _Reader, files: List[DataFile], n: int) -> List[Location]:
    """``n`` references, column by column: data file ids, offsets,
    lengths."""
    ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
    if any(i >= len(files) for i in ids):
        raise OcdbtFormatError(f"{r.where}: data file id out of range")
    return [Location(files[i], o, n_)
            for i, o, n_ in zip(ids, offsets, lengths)]


def _prefixed_keys(r: _Reader, n: int) -> Tuple[List[int], List[int]]:
    """The lengths of ``n`` keys that each share a prefix with the one
    before: the shared lengths (none is stored for the first key) and the
    suffix lengths. The suffixes come later in the body
    (``_key_suffixes``)."""
    shared = [0] + r.varints(n - 1) if n else []
    return shared, r.varints(n)


def _key_suffixes(r: _Reader, shared: List[int], suffix: List[int]
                  ) -> List[bytes]:
    keys, prev = [], b""
    for s, n in zip(shared, suffix):
        if s > len(prev):
            raise OcdbtFormatError(f"{r.where}: bad key prefix")
        prev = prev[:s] + r.take(n)
        keys.append(prev)
    return keys


class Manifest(NamedTuple):
    generation: int
    root: Optional[Location]
    root_height: int
    num_keys: int


def read_manifest(root_dir: str) -> Manifest:
    """The configuration and the latest version of the store at
    ``root_dir`` (the manifest kind "single": the newest versions are
    inline; older ones, in version-tree nodes, are not needed to read the
    latest)."""
    where = os.path.join(root_dir, "manifest.ocdbt")
    with open(where, "rb") as f:
        r = _Reader(decode_file(f.read(), MANIFEST_MAGIC, where), where)
    r.take(16)  # uuid
    kind = r.varint()
    if kind != 0:
        raise OcdbtFormatError(f"{where}: manifest kind {kind} (only 0, "
                               "'single', is known)")
    r.varint()  # max_inline_value_bytes
    r.varint()  # max_decoded_node_bytes
    r.u8s(1)  # version_tree_arity_log2
    compression = r.varint()
    if compression not in _COMPRESSIONS:
        raise OcdbtFormatError(f"{where}: unknown node compression "
                               f"{compression}")
    if compression == 1:
        r.take(4)  # the zstd level, an int32le
    files = _data_file_table(r, "")
    # the versions inline: generation, root height (u8), root location,
    # the tree's statistics, commit time (u64le)
    n = r.varint()
    generation = r.varints(n)
    height = r.u8s(n)
    roots = _locations(r, files, n)
    num_keys = r.varints(n)
    r.varints(n)  # num_tree_bytes
    r.varints(n)  # num_indirect_value_bytes
    r.u64les(n)  # commit_time
    # references to version-tree nodes of older versions: generation,
    # location, generation count, commit time (u64le), height (u8)
    m = r.varint()
    r.varints(m)
    _locations(r, files, m)
    r.varints(m)
    r.u64les(m)
    r.u8s(m)
    r.done()
    if n == 0:
        return Manifest(0, None, 0, 0)
    i = max(range(n), key=generation.__getitem__)
    root = roots[i] if roots[i].length else None
    return Manifest(generation[i], root, height[i], num_keys[i])


class OcdbtStore:
    """The latest version of an OCDBT store, read at construction into a
    table from each key to its value's place: ``list()`` gives the keys in
    order, ``read(key)`` a value's bytes."""

    def __init__(self, root_dir: str):
        self.root_dir = root_dir
        self.manifest = read_manifest(root_dir)
        # key -> bytes (inline) or Location (indirect)
        self._values: Dict[bytes, object] = {}
        if self.manifest.root is not None:
            self._walk(self.manifest.root, self.manifest.root_height, b"")
        if len(self._values) != self.manifest.num_keys:
            raise OcdbtFormatError(
                f"{root_dir}: the tree holds {len(self._values)} keys, the "
                f"manifest says {self.manifest.num_keys}")

    def _read_range(self, loc: Location) -> bytes:
        path = os.path.join(self.root_dir, loc.file.path)
        with open(path, "rb") as f:
            f.seek(loc.offset)
            data = f.read(loc.length)
        if len(data) != loc.length:
            raise OcdbtFormatError(
                f"{path}: {loc.length} bytes at {loc.offset} run past the "
                "end of the file")
        return data

    def _walk(self, loc: Location, height: int, prefix: bytes) -> None:
        where = f"{loc.file.path}@{loc.offset}"
        r = _Reader(decode_file(self._read_range(loc), BTREE_NODE_MAGIC,
                                where), where)
        got = r.u8s(1)[0]
        if got != height:
            raise OcdbtFormatError(f"{where}: node height {got}, its parent "
                                   f"says {height}")
        files = _data_file_table(r, loc.file.base)
        n = r.varint()
        if height == 0:
            self._leaf(r, files, n, prefix)
        else:
            self._interior(r, files, n, prefix, height)

    def _leaf(self, r: _Reader, files, n: int, prefix: bytes) -> None:
        """Keys, value lengths, kinds (u8: 0 inline, 1 indirect), the
        indirect values' data file ids and offsets, then the inline values
        one after another."""
        shared, suffix = _prefixed_keys(r, n)
        keys = _key_suffixes(r, shared, suffix)
        lengths = r.varints(n)
        kinds = r.u8s(n)
        if any(k > 1 for k in kinds):
            raise OcdbtFormatError(f"{r.where}: unknown value kind")
        indirect = [i for i in range(n) if kinds[i] == 1]
        ids, offsets = r.varints(len(indirect)), r.varints(len(indirect))
        if any(i >= len(files) for i in ids):
            raise OcdbtFormatError(f"{r.where}: data file id out of range")
        places = {i: Location(files[f], o, lengths[i])
                  for i, f, o in zip(indirect, ids, offsets)}
        for i, key in enumerate(keys):
            self._values[prefix + key] = (
                places[i] if kinds[i] else r.take(lengths[i]))
        r.done()

    def _interior(self, r: _Reader, files, n: int, prefix: bytes,
                  height: int) -> None:
        """Each child's first key, the length of that key which every key
        of the child shares (the child's keys are stored without it), the
        child's location, then its statistics (keys, tree bytes, indirect
        value bytes)."""
        shared, suffix = _prefixed_keys(r, n)
        common = r.varints(n)
        keys = _key_suffixes(r, shared, suffix)
        children = _locations(r, files, n)
        r.varints(3 * n)
        r.done()
        for key, c, loc in zip(keys, common, children):
            if c > len(key):
                raise OcdbtFormatError(f"{r.where}: bad subtree prefix")
            self._walk(loc, height - 1, prefix + key[:c])

    def list(self) -> List[bytes]:
        return sorted(self._values)

    def __contains__(self, key) -> bool:
        return (key.encode() if isinstance(key, str) else key) in self._values

    def read(self, key) -> bytes:
        value = self._values[key.encode() if isinstance(key, str) else key]
        if isinstance(value, Location):
            return self._read_range(value)
        return value
