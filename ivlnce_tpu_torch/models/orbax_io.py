"""Orbax checkpoint directories, read without orbax, tensorstore or JAX:
the JAX trainer's ``TPU.async_checkpointing`` save
(``ckpt.N.pth.orbax/`` beside a ``ckpt.N.pth.meta.json``).

Such a directory holds an OCDBT store (``ocdbt.py``) of zarr v2 arrays,
one per leaf, under the leaf's ``param_name``: ``<name>/.zarray`` and its
chunks ``<name>/<i>.<j>...``. ``_METADATA`` gives the tree, each leaf's
path as a list of keys, each a dict key or a sequence index;
``array_metadatas/process_0`` names the arrays. ``load_orbax_checkpoint``
returns what the JAX trainer's ``load_checkpoint`` returns
(base_trainer.py:296-314): the sidecar's meta updated by the restored
tree, in which the optax states are dicts and lists, and ``EmptyState``
and ``MaskedNode`` are ``None``."""

from __future__ import annotations

import json
import math
import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ivlnce_tpu_torch.models.ocdbt import OcdbtStore
from ivlnce_tpu_torch.utils import zstd

# zarr v2 dtypes read here (little-endian or byte-sized); bfloat16 is read
# as its bits and handed back as torch.bfloat16
_DTYPES = {"<f4": np.float32, "<f8": np.float64, "<i4": np.int32,
           "<i8": np.int64, "|u1": np.uint8, "|b1": np.bool_,
           "bfloat16": np.uint16}
_TMP_MARK = ".orbax-checkpoint-tmp-"
# _METADATA's key types: a sequence index, a dict key
_SEQUENCE, _DICT = 1, 2


class OrbaxFormatError(ValueError):
    """A directory that is not an Orbax checkpoint as this reader knows
    it."""


def _zarray(store: OcdbtStore, name: str) -> Dict[str, Any]:
    meta = json.loads(store.read(f"{name}/.zarray"))
    where = f"{name}/.zarray"
    if meta.get("zarr_format") != 2:
        raise OrbaxFormatError(f"{where}: zarr_format "
                               f"{meta.get('zarr_format')}, expected 2")
    if meta["dtype"] not in _DTYPES:
        raise OrbaxFormatError(f"{where}: dtype {meta['dtype']!r}")
    if meta.get("order", "C") != "C":
        raise OrbaxFormatError(f"{where}: order {meta['order']!r}")
    if meta.get("filters"):
        raise OrbaxFormatError(f"{where}: filters {meta['filters']}")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise OrbaxFormatError(f"{where}: compressor {compressor}")
    if meta.get("dimension_separator", ".") != ".":
        raise OrbaxFormatError(
            f"{where}: dimension_separator {meta['dimension_separator']!r}")
    # a missing chunk reads as 0, as zarr v2 readers (tensorstore) fill it
    # for a null fill_value, the one Orbax writes
    if meta.get("fill_value") is not None:
        raise OrbaxFormatError(f"{where}: fill_value {meta['fill_value']}")
    if len(meta["chunks"]) != len(meta["shape"]):
        raise OrbaxFormatError(f"{where}: chunks {meta['chunks']} for "
                               f"shape {meta['shape']}")
    return meta


def read_array(store: OcdbtStore, name: str, *,
               bfloat16_as_float32: bool = False):
    """The zarr v2 array ``name`` of ``store`` (C order, ``.``-separated
    chunk keys, zstd or no compressor, no filters, a null fill value): a
    numpy array, or for bfloat16 a ``torch.bfloat16`` tensor (numpy has no
    bfloat16), widened to a float32 numpy array, exactly, with
    ``bfloat16_as_float32``. Chunks are cut to the array's edge; a chunk
    the store lacks reads as 0."""
    meta = _zarray(store, name)
    dtype = np.dtype(_DTYPES[meta["dtype"]])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    out = np.zeros(shape, dtype=dtype)
    for index in np.ndindex(*(-(-s // c) if c else 0
                              for s, c in zip(shape, chunks))):
        key = f"{name}/{'.'.join(map(str, index)) if index else '0'}"
        if key not in store:
            continue
        raw = store.read(key)
        if meta.get("compressor") is not None:
            raw = zstd.decompress(raw)
        n = math.prod(chunks) * dtype.itemsize
        if len(raw) != n:
            raise OrbaxFormatError(f"{key}: {len(raw)} bytes, a chunk of "
                                   f"{chunks} {meta['dtype']} is {n}")
        chunk = np.frombuffer(raw, dtype=dtype).reshape(chunks)
        region = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(index, chunks, shape))
        out[region] = chunk[tuple(slice(0, r.stop - r.start)
                                  for r in region)]
    if meta["dtype"] != "bfloat16":
        return out
    bits = torch.from_numpy(out.view(np.int16))
    tensor = bits.view(torch.bfloat16)
    return tensor.float().numpy() if bfloat16_as_float32 else tensor


def _committed(path: str) -> None:
    """Raise unless ``path`` is a committed Orbax checkpoint."""
    if _TMP_MARK in os.path.basename(os.path.normpath(path)):
        raise OrbaxFormatError(f"{path} is a temporary directory of an "
                               "Orbax save that did not finish")
    meta_path = os.path.join(path, "_CHECKPOINT_METADATA")
    if not os.path.exists(meta_path):
        raise OrbaxFormatError(f"{path} has no _CHECKPOINT_METADATA: not "
                               "a committed Orbax checkpoint")
    with open(meta_path) as f:
        if json.load(f).get("commit_timestamp_nsecs") is None:
            raise OrbaxFormatError(f"{path}: _CHECKPOINT_METADATA records "
                                   "no commit")


def _leaves(path: str) -> List[Tuple[List[Tuple[str, int]], Dict]]:
    """Each leaf of ``_METADATA``'s tree: its keys with their types, and
    its value metadata."""
    with open(os.path.join(path, "_METADATA")) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt") or meta.get("use_zarr3"):
        raise OrbaxFormatError(
            f"{path}: use_ocdbt {meta.get('use_ocdbt')}, use_zarr3 "
            f"{meta.get('use_zarr3')} (only OCDBT with zarr v2 is read)")
    leaves = []
    for entry in meta["tree_metadata"].values():
        keys = [(k["key"], k["key_type"]) for k in entry["key_metadata"]]
        if any(t not in (_SEQUENCE, _DICT) for _, t in keys):
            raise OrbaxFormatError(f"{path}: key types in {keys}")
        leaves.append((keys, entry["value_metadata"]))
    return leaves


def _build(items: List[Tuple[List[Tuple[str, int]], Any]], depth: int = 0):
    """The tree of the ``(keys, value)`` leaves that share their first
    ``depth`` keys: a dict under dict keys, a list under sequence
    indices."""
    if any(len(keys) == depth for keys, _ in items):
        if len(items) != 1:
            raise OrbaxFormatError(f"a leaf and a subtree at {items[0][0]}")
        return items[0][1]
    groups: Dict[str, list] = {}
    kinds = set()
    for keys, value in items:
        key, kind = keys[depth]
        kinds.add(kind)
        groups.setdefault(key, []).append((keys, value))
    if len(kinds) != 1:
        raise OrbaxFormatError(f"dict keys and sequence indices together "
                               f"under {items[0][0][:depth]}")
    if kinds == {_DICT}:
        return {k: _build(g, depth + 1) for k, g in groups.items()}
    index = sorted(groups, key=int)
    if [int(i) for i in index] != list(range(len(index))):
        raise OrbaxFormatError(f"sequence indices {index} under "
                               f"{items[0][0][:depth]}")
    return [_build(groups[i], depth + 1) for i in index]


def load_orbax_tree(path: str, *, bfloat16_as_float32: bool = False
                    ) -> Dict[str, Any]:
    """The tree saved in the Orbax checkpoint directory ``path``: its
    leaves read from the OCDBT store as ``read_array`` reads them, ``None``
    where orbax saved none. A leaf's array is named by its keys joined by
    dots (a key may hold a dot itself, so names are never split)."""
    _committed(path)
    # the arrays' names, which orbax lists for jax.Array leaves only (a
    # trainer resumed from a pickle holds numpy optax states and saves
    # np.ndarray leaves)
    names = None
    listing = os.path.join(path, "array_metadatas", "process_0")
    if os.path.exists(listing):
        with open(listing) as f:
            names = {a["array_metadata"]["param_name"]
                     for a in json.load(f)["array_metadatas"]}
    store = OcdbtStore(path)
    items, seen = [], set()
    for keys, value_meta in _leaves(path):
        kind = value_meta["value_type"]
        if kind == "None":
            value = None
        elif kind in ("jax.Array", "np.ndarray"):
            name = ".".join(k for k, _ in keys)
            if name in seen or names is not None and name not in names:
                raise OrbaxFormatError(
                    f"{path}: leaf {[k for k, _ in keys]} has no array of "
                    f"its own in array_metadatas ({name})")
            seen.add(name)
            value = read_array(store, name,
                               bfloat16_as_float32=bfloat16_as_float32)
        else:
            raise OrbaxFormatError(f"{path}: leaf {keys} of value type "
                                   f"{kind!r}")
        items.append((keys, value))
    if any(t != _DICT for _, t in (keys[0] for keys, _ in items)):
        raise OrbaxFormatError(f"{path}: the tree's root is not a dict")
    return _build(items)


def load_orbax_checkpoint(path: str, *, bfloat16_as_float32: bool = False
                          ) -> Dict[str, Any]:
    """An Orbax checkpoint as the JAX trainer's ``load_checkpoint`` returns
    it: ``{**meta, **restored}``, with ``meta`` from the
    ``ckpt.N.pth.meta.json`` beside ``ckpt.N.pth.orbax`` (``{}`` when that
    is absent). ``path`` is the directory."""
    restored = load_orbax_tree(path, bfloat16_as_float32=bfloat16_as_float32)
    meta_path = path.replace(".orbax", "") + ".meta.json"
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return {**meta, **restored}
