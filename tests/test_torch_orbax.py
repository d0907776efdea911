"""Orbax checkpoint directories in the port, on the CPU: the JAX trainer's
``TPU.async_checkpointing`` save (``ckpt.N.pth.orbax`` beside
``ckpt.N.pth.meta.json``) read by ``ivlnce_tpu_torch``, which has no
orbax, tensorstore, zstandard or JAX. Those four are the oracles here:

(a) ``utils/zstd.py`` against ``zstandard``: frames at levels 1, 3 and
    19, with and without a content size, multi-block frames of several
    MB, an empty payload; input that is not one whole frame raises;
(b) ``models/ocdbt.py`` against tensorstore's OCDBT driver: every key and
    value of a JAX-written checkpoint (its root, which merges the
    process's tree, and that tree alone) and of stores tensorstore writes
    with deep B+trees, many versions, no compression and values in their
    own data files; files it does not know raise;
(c) ``orbax_io.read_array`` against tensorstore's zarr driver: each dtype,
    several chunks, edge chunks, missing chunks, scalars; what Orbax does
    not write (other compressors, filters, orders, fill values, chunk key
    separators) raises;
(d) ``load_orbax_checkpoint`` and the trainer's ``load_checkpoint``
    against ``ocp.PyTreeCheckpointer().restore``, bit for bit: at the
    training tests' widths, at MapCMA's full widths (params and Adam) and
    with ``custom_lr``'s ``multi_transform``; the meta is the sidecar's;
(e) the committed fixture (``ivlnce_tpu_torch/testdata/orbax_small``,
    which ``chip_smoke.py`` phase 18 reads on the card) is what
    ``write_small_fixture`` writes;
(f) the trainer: JAX's ``_eval_checkpoint`` on an Orbax checkpoint
    against the port's eval of its folder (identical actions, equal
    stats); the warm start against JAX's (weights, loss, gradients); the
    resume's Adam moments, step and epoch; the folder listing.

The JAX package's two faults on this path are shown here too: its resume
from an Orbax checkpoint fails in optax, and its ``eval()`` of a folder
takes the ``.meta.json`` sidecar for a checkpoint (ROADMAP §3)."""

import hashlib
import json
import os
import pickle
import random
import shutil
import struct
import subprocess
import sys

import jax
import numpy as np
import optax
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch
import zstandard

import ivlnce_tpu.trainers  # noqa: F401  (registration side effects)
from ivlnce_tpu.config import get_config as jax_config
from ivlnce_tpu.utils.registry import registry as jax_registry
from ivlnce_tpu.utils.tb import TensorboardWriter as JaxTensorboardWriter
from ivlnce_tpu_torch.config import get_config as torch_config
from ivlnce_tpu_torch.models import checkpoint_io as tcio
from ivlnce_tpu_torch.models import ocdbt, orbax_io
from ivlnce_tpu_torch.models.convert import params_from_jax
from ivlnce_tpu_torch.run import register_all
from ivlnce_tpu_torch.trainers import base_trainer as tbt
from ivlnce_tpu_torch.utils import zstd
from ivlnce_tpu_torch.utils.registry import registry as torch_registry
from tests import test_torch_eval as teval
from tests.test_torch_resume import _jax_optimizer
from tests.test_torch_train import (
    LOSS_RTOL, MAP_CONFIG, MAP_ENCODER, UNPADDED, _assert_grads_match,
    _jax_grad_step, _opts, _pair, _torch_loss, _tour_masks, _train_batch,
    one_torch_thread)  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "ivlnce_tpu_torch", "testdata", "orbax_small")
# the committed fixture's MapCMA: the training config cut to widths whose
# Orbax checkpoint and pickle twin fit in 2 MB together; the frozen depth
# encoder (24.8 M parameters) is left out of the checkpoint, so a load
# keeps the policy's seeded weights there, in both packages
FIXTURE_CONFIG = "configs/fake/map_cma_train_tf.yaml"
FIXTURE_OPTS = [
    "MODEL.STATE_ENCODER.hidden_size", 16,
    "MODEL.SEMANTIC_MAP_ENCODER.channels", 4,
    "MODEL.SEMANTIC_MAP_ENCODER.output_size", 16,
    "MODEL.DEPTH_ENCODER.output_size", 8,
    "MODEL.INSTRUCTION_ENCODER.hidden_size", 16,
    "MODEL.INSTRUCTION_ENCODER.embedding_size", 8,
] + [x for s in ("DEPTH_SENSOR", "RGB_SENSOR")
     for x in (f"TASK_CONFIG.SIMULATOR.{s}.HEIGHT", 64,
               f"TASK_CONFIG.SIMULATOR.{s}.WIDTH", 64)]


def _jax_trainer(config):
    return jax_registry.get_trainer(config.TRAINER_NAME)(config)


def _save_orbax(trainer, params, opt_state, name="ckpt.0.pth", **meta):
    """The JAX trainer's own ``save_checkpoint`` under
    ``TPU.async_checkpointing``, waited for, of device arrays as the
    trainer holds them (orbax writes numpy leaves without their array
    metadata)."""
    assert trainer.config.TPU.async_checkpointing
    trainer.params = jax.device_put(params)
    trainer.opt_state = jax.device_put(opt_state)
    trainer.save_checkpoint(name, **meta)
    trainer._orbax.wait_until_finished()
    return os.path.join(trainer.config.CHECKPOINT_FOLDER, name)


def _restore(path):
    return ocp.PyTreeCheckpointer().restore(os.path.abspath(path))


def _assert_same_tree(got, want, path="tree"):
    """``got`` (the port's reader) equals orbax's restore ``want`` bit for
    bit: dicts, lists and ``None`` alike, arrays of one dtype, shape and
    byte content (bfloat16 as the port's ``torch.bfloat16``)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same_tree(g, w, f"{path}[{i}]")
    elif want is None:
        assert got is None, path
    else:
        want = np.asarray(want)
        if str(want.dtype) == "bfloat16":
            assert got.dtype == torch.bfloat16, path
            got = got.view(torch.int16).numpy()
            want = want.view(np.int16)
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert got.tobytes() == want.tobytes(), path


def _leaves(tree, path=()):
    """(name, array) of each leaf, named as Orbax names them: keys and
    sequence indices joined by dots, an optax state's fields by name."""
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    elif tree is not None:
        yield ".".join(path), np.asarray(tree)


# -- (a) zstd ----------------------------------------------------------------
def _payloads():
    rng = np.random.default_rng(0)
    walk = np.cumsum(rng.normal(0, 1, 700_000)).astype(np.float32)
    return {"empty": b"", "small": b"orbax" * 7,
            "multi_block": walk.tobytes()}  # 2.8 MB: 22 blocks of 128 KB


@pytest.mark.parametrize("content_size", [True, False])
@pytest.mark.parametrize("level", [1, 3, 19])
def test_zstd_matches_zstandard(level, content_size):
    for name, payload in _payloads().items():
        frame = zstandard.ZstdCompressor(
            level=level, write_content_size=content_size).compress(payload)
        assert frame[:4] == b"\x28\xb5\x2f\xfd"
        want = zstandard.ZstdDecompressor().decompressobj().decompress(frame)
        got = zstd.decompress(frame)
        assert got == want == payload, name


def test_zstd_refuses_what_is_not_one_frame():
    """No input, another magic, a truncated frame (with and without a
    content size), two frames, a frame with a byte after it."""
    frame = zstandard.ZstdCompressor(level=3).compress(b"x" * 1000)
    unsized = zstandard.ZstdCompressor(
        write_content_size=False).compress(b"x" * 1000)
    for bad in (b"", b"\x0c\xdb\x3a\x2a" + bytes(20), frame[:-3],
                unsized[:-3], frame + frame, unsized + b"\0"):
        with pytest.raises(zstd.ZstdError):
            zstd.decompress(bad)


# -- checkpoints the JAX trainer writes ---------------------------------------
def _adam_steps(optimizer, params, steps, seed=5):
    """``steps`` optax updates on seeded gradients, none to the frozen
    depth encoder (as in training), so its moments stay 0."""
    rng = np.random.default_rng(seed)
    state = optimizer.init(params)
    for _ in range(steps):
        grads = jax.tree_util.tree_map(
            lambda a: rng.normal(0, 1, np.shape(a)).astype(np.float32),
            params)
        grads["depth_encoder"] = jax.tree_util.tree_map(
            np.zeros_like, params["depth_encoder"])
        updates, state = optimizer.update(grads, state, params)
        params = jax.device_get(optax.apply_updates(params, updates))
    return params, jax.device_get(state)


def _train_dirs(root):
    return ["CHECKPOINT_FOLDER", os.path.join(root, "ckpts"),
            "TENSORBOARD_DIR", os.path.join(root, "tb"),
            "IL.DAGGER.lmdb_features_dir", os.path.join(root, "traj.lmdb")]


def _write_training_checkpoint(root, custom_lr):
    """The JAX trainer's Orbax checkpoint of the training tests' MapCMA
    (``_pair``'s weights) after two Adam steps, epoch 3, step 11."""
    os.chdir(REPO)
    opts = _opts(custom_lr=custom_lr) + _train_dirs(root)
    tcfg, jpol, params, tpol = _pair(MAP_CONFIG, opts)
    jcfg = jax_config(MAP_CONFIG, opts + ["TPU.async_checkpointing", True])
    trainer = _jax_trainer(jcfg)
    params, state = _adam_steps(_jax_optimizer(jcfg), params, 2)
    path = _save_orbax(trainer, params, state, "ckpt.3.pth", dagger_it=1,
                       epoch=3, step_id=11)
    return {"path": path, "opts": opts, "jcfg": jcfg, "jpol": jpol,
            "params": params, "tpol": tpol}


@pytest.fixture(scope="module")
def training_ckpt(tmp_path_factory):
    return _write_training_checkpoint(
        str(tmp_path_factory.mktemp("train_ckpt")), custom_lr=False)


@pytest.fixture(scope="module")
def custom_lr_ckpt(tmp_path_factory):
    return _write_training_checkpoint(
        str(tmp_path_factory.mktemp("custom_lr_ckpt")), custom_lr=True)


# -- (b) OCDBT -----------------------------------------------------------------
def _tensorstore_store(root, config, rng):
    """A store tensorstore writes with ``config``: three transactions of
    100 keys with shared prefixes, values of 0 to 300 bytes, then a 3 MB
    value, an empty key and an empty value, each its own commit."""
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}",
                          "config": config}).result()
    for c in range(3):
        with ts.Transaction() as txn:
            for i in range(100):
                kv.with_transaction(txn)[f"a{i % 7}.b/{c}.{i}"] = bytes(
                    rng.integers(0, 256, int(rng.integers(0, 300)),
                                 dtype=np.uint8))
    kv.write("big", bytes(rng.integers(0, 256, 3_000_000,
                                       dtype=np.uint8))).result()
    kv.write("", b"empty key").result()
    kv.write("zero", b"").result()
    return root


def _assert_store_matches_tensorstore(root):
    store = ocdbt.OcdbtStore(root)
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{root}"}).result()
    keys = kv.list().result()
    assert store.list() == sorted(keys) and len(keys) > 100
    for key in keys:
        assert store.read(key) == kv.read(key).result().value, key
    return store


@pytest.mark.parametrize("config", [
    # deep B+trees, two versions to a version-tree node, zstd level 7
    {"max_inline_value_bytes": 16, "max_decoded_node_bytes": 300,
     "version_tree_arity_log2": 1, "compression": {"id": "zstd", "level": 7}},
    # uncompressed nodes
    {"max_inline_value_bytes": 100, "max_decoded_node_bytes": 1000,
     "version_tree_arity_log2": 2, "compression": None},
], ids=["deep_zstd", "raw"])
def test_ocdbt_reads_what_tensorstore_writes(tmp_path, config):
    store = _assert_store_matches_tensorstore(
        _tensorstore_store(str(tmp_path), config, np.random.default_rng(1)))
    assert store.manifest.root_height >= 2
    assert store.manifest.generation > 2
    assert len(store.read("big")) == 3_000_000
    if config["compression"] is None:
        # the 3 MB value went to a data file of its own
        big = store._values[b"big"]
        assert sum(v.file == big.file for v in store._values.values()
                   if isinstance(v, ocdbt.Location)) == 1


def test_ocdbt_reads_the_jax_trainers_checkpoint(training_ckpt):
    """The root store, whose one leaf points into the process's data files
    (``ocdbt.process_0/d/``), and the process's store alone; the largest
    value is a chunk of over 1 MB."""
    path = training_ckpt["path"] + ".orbax"
    root = _assert_store_matches_tensorstore(path)
    sub = _assert_store_matches_tensorstore(
        os.path.join(path, "ocdbt.process_0"))
    assert root.list() == sub.list()
    places = [v for v in root._values.values()
              if isinstance(v, ocdbt.Location)]
    assert {p.file.base for p in places} == {"ocdbt.process_0/"}
    largest = max(places, key=lambda p: p.length)
    assert largest.length > 1_000_000


def _rewrite(path, edit):
    """``path``'s manifest with ``edit`` applied to its raw bytes, the
    CRC-32C made to match again unless ``edit`` broke it on purpose."""
    with open(path, "rb") as f:
        raw = bytearray(f.read())
    raw, fix_crc = edit(raw)
    if fix_crc:
        raw[-4:] = struct.pack("<I", ocdbt.crc32c(bytes(raw[:-4])))
    with open(path, "wb") as f:
        f.write(raw)


def _bad_magic(raw):
    raw[3] ^= 1
    return raw, True


def _bad_version(raw):
    raw[12] = 1
    return raw, True


def _bad_compression(raw):
    raw[13] = 2
    return raw, True


def _bad_crc(raw):
    raw[-1] ^= 1
    return raw, False


def _bad_length(raw):
    return raw + b"\0", False


@pytest.mark.parametrize("edit", [_bad_magic, _bad_version,
                                  _bad_compression, _bad_crc, _bad_length],
                         ids=["magic", "version", "compression", "crc",
                              "length"])
def test_ocdbt_refuses_a_file_it_does_not_know(tmp_path, edit):
    root = str(tmp_path / "store")
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{root}"}).result()
    kv.write("k", b"v").result()
    assert ocdbt.OcdbtStore(root).read("k") == b"v"
    _rewrite(os.path.join(root, "manifest.ocdbt"), edit)
    with pytest.raises(ocdbt.OcdbtFormatError):
        ocdbt.OcdbtStore(root)


def test_ocdbt_refuses_a_numbered_manifest(tmp_path):
    root = str(tmp_path / "store")
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}",
                          "config": {"manifest_kind": "numbered"}}).result()
    kv.write("k", b"v").result()
    with pytest.raises(ocdbt.OcdbtFormatError, match="manifest kind 1"):
        ocdbt.OcdbtStore(root)


# -- (c) zarr arrays -------------------------------------------------------------
ARRAYS = {
    # dtype, shape, chunks, compressor (the fill value is null, the
    # dimension separator ".", as Orbax writes them)
    "f4_chunked": ("<f4", [5, 7], [2, 3], {"id": "zstd", "level": 1}),
    "f8": ("<f8", [4, 4, 3], [3, 2, 2], None),
    "i4_scalar": ("<i4", [], [], {"id": "zstd", "level": 3}),
    "i8": ("<i8", [9], [4], {"id": "zstd", "level": 1}),
    "u1": ("|u1", [6, 5], [4, 4], {"id": "zstd", "level": 1}),
    "b1": ("|b1", [3, 3], [2, 2], None),
    "bf16": ("bfloat16", [5, 3], [2, 2], {"id": "zstd", "level": 1}),
}


def test_read_array_matches_tensorstore(tmp_path):
    """Each array written whole but for its first chunk (absent from the
    store, so it reads as 0), with edge chunks cut to the shape; the
    scalar written whole."""
    rng = np.random.default_rng(2)
    kvstore = {"driver": "ocdbt", "base": f"file://{tmp_path}"}
    want = {}
    for name, (dtype, shape, chunks, comp) in ARRAYS.items():
        arr = ts.open({"driver": "zarr", "kvstore": kvstore, "path": name,
                       "metadata": {"shape": shape, "chunks": chunks,
                                    "dtype": dtype, "compressor": comp,
                                    "fill_value": None,
                                    "dimension_separator": "."}},
                      create=True).result()
        values = (rng.normal(0, 100, shape)
                  .astype(arr.dtype.numpy_dtype))
        if shape:
            arr[chunks[0]:] = values[chunks[0]:]
        else:
            arr[()] = values
        want[name] = arr.read().result()
    store = ocdbt.OcdbtStore(str(tmp_path))
    for name, (dtype, shape, chunks, _) in ARRAYS.items():
        if shape:
            assert f"{name}/{'.'.join(['0'] * len(shape))}" not in store
        got = orbax_io.read_array(store, name)
        if dtype == "bfloat16":
            assert got.dtype == torch.bfloat16
            assert np.array_equal(got.view(torch.int16).numpy(),
                                  want[name].view(np.int16))
            widened = orbax_io.read_array(store, name,
                                          bfloat16_as_float32=True)
            assert np.array_equal(widened, want[name].astype(np.float32))
            continue
        assert got.dtype == want[name].dtype and got.shape == tuple(shape)
        assert got.tobytes() == want[name].tobytes(), name


@pytest.mark.parametrize("field,value", [
    ("compressor", {"id": "blosc", "cname": "lz4"}),
    ("filters", [{"id": "delta", "dtype": "<f4"}]),
    ("order", "F"),
    ("dtype", ">f4"),
    ("fill_value", 7),
    ("dimension_separator", "/"),
])
def test_read_array_refuses_what_it_does_not_know(tmp_path, field, value):
    """An array Orbax could have written, read, then each field set to
    what Orbax does not write."""
    kvstore = {"driver": "ocdbt", "base": f"file://{tmp_path}"}
    ts.open({"driver": "zarr", "kvstore": kvstore, "path": "a",
             "metadata": {"shape": [2], "chunks": [2], "dtype": "<f4",
                          "compressor": {"id": "zstd", "level": 1}}},
            create=True).result()[...] = np.ones(2, np.float32)
    kv = ts.KvStore.open(kvstore).result()
    np.testing.assert_array_equal(
        orbax_io.read_array(ocdbt.OcdbtStore(str(tmp_path)), "a"), 1)
    meta = json.loads(kv.read("a/.zarray").result().value)
    meta[field] = value
    kv.write("a/.zarray", json.dumps(meta).encode()).result()
    with pytest.raises(orbax_io.OrbaxFormatError, match=field.rstrip("s")):
        orbax_io.read_array(ocdbt.OcdbtStore(str(tmp_path)), "a")


# -- (d) the Orbax tree -------------------------------------------------------------
def _assert_loads_as_orbax_restores(path):
    """``load_orbax_checkpoint`` and ``load_checkpoint`` on the JAX
    trainer's ``ckpt.N.pth``: the tree equals orbax's restore bit for bit,
    the meta the sidecar, the state_dict ``params_from_jax`` of the
    restored params."""
    want = _restore(path + ".orbax")
    got = orbax_io.load_orbax_checkpoint(path + ".orbax")
    with open(path + ".meta.json") as f:
        meta = json.load(f)
    assert {k: got[k] for k in meta} == meta
    assert set(got) == set(meta) | set(want)
    _assert_same_tree({k: got[k] for k in want}, want)
    ckpt = tbt.load_checkpoint(path)
    assert ckpt["epoch"] == meta["epoch"]
    state = params_from_jax(jax.device_get(want["params"]))
    assert set(ckpt["state_dict"]) == set(state)
    for k, v in state.items():
        assert torch.equal(ckpt["state_dict"][k], v), k
    return want


def test_load_matches_orbax_restore_at_the_test_widths(training_ckpt):
    want = _assert_loads_as_orbax_restores(training_ckpt["path"])
    adam = want["optim_state"]
    assert isinstance(adam, list) and adam[1] is None
    assert int(adam[0]["count"]) == 2


def test_load_matches_orbax_restore_with_custom_lr(custom_lr_ckpt):
    want = _assert_loads_as_orbax_restores(custom_lr_ckpt["path"])
    labels = want["optim_state"]["inner_states"]
    assert set(labels) == {"map", "regular"}
    # the other label's parameters: optax's MaskedNode, restored as None
    assert labels["map"]["inner_state"][0]["mu"]["state_encoder"] is None


def test_load_matches_orbax_restore_at_full_width(tmp_path):
    """MapCMA at the training config's own widths and sensors (hidden 512,
    256x256 depth), its params and Adam state after one step."""
    os.chdir(REPO)
    opts = _train_dirs(str(tmp_path))
    register_all()
    tcfg = torch_config(MAP_CONFIG, opts)
    hw = tcfg.TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.HEIGHT
    assert tcfg.MODEL.STATE_ENCODER.hidden_size == 512 and hw == 256
    torch.manual_seed(4)
    trainer = torch_registry.get_trainer(tcfg.TRAINER_NAME)(tcfg, "cpu")
    tpol, _ = trainer._build_policy(tcfg, None)
    params = jax.tree_util.tree_map(
        np.array, tcio.jax_params_from_state_dict(tpol.state_dict()))
    jcfg = jax_config(MAP_CONFIG, opts + ["TPU.async_checkpointing", True])
    params, state = _adam_steps(optax.adam(jcfg.IL.lr), params, 1)
    path = _save_orbax(_jax_trainer(jcfg), params, state, "ckpt.1.pth",
                       epoch=1, step_id=4)
    want = _assert_loads_as_orbax_restores(path)
    n = sum(a.size for _, a in _leaves(want["params"]))
    assert n > 13_000_000


def test_uncommitted_and_temporary_directories_raise(training_ckpt,
                                                     tmp_path):
    src = training_ckpt["path"] + ".orbax"
    tmp_dir = str(tmp_path / "ckpt.3.pth.orbax.orbax-checkpoint-tmp-17")
    shutil.copytree(src, tmp_dir)
    with pytest.raises(orbax_io.OrbaxFormatError, match="did not finish"):
        orbax_io.load_orbax_checkpoint(tmp_dir)
    uncommitted = str(tmp_path / "ckpt.3.pth.orbax")
    shutil.copytree(src, uncommitted)
    meta_path = os.path.join(uncommitted, "_CHECKPOINT_METADATA")
    with open(meta_path) as f:
        meta = json.load(f)
    meta["commit_timestamp_nsecs"] = None
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    with pytest.raises(orbax_io.OrbaxFormatError, match="no commit"):
        orbax_io.load_orbax_checkpoint(uncommitted)
    os.remove(meta_path)
    with pytest.raises(orbax_io.OrbaxFormatError, match="not a committed"):
        tbt.load_checkpoint(str(tmp_path / "ckpt.3.pth"))


# -- (e) the committed fixture ---------------------------------------------------
def write_small_fixture(out):
    """The committed fixture, written by the JAX package: the JAX
    trainer's Orbax checkpoint ``ckpt.0.pth.orbax`` with its
    ``ckpt.0.pth.meta.json``, its pickle twin ``pickle/ckpt.0.pth``
    (the same trainer state, ``TPU.async_checkpointing False``), and
    ``fixture.json``: the config and opts of its widths and each array's
    dtype, shape and SHA-256 as orbax restores it. The weights are JAX's
    seeded initialisation but the frozen depth encoder; Adam's moments
    are optax's initial ones. The config paths in the sidecar are
    relative to ``out``."""
    os.chdir(REPO)
    jcfg = jax_config(FIXTURE_CONFIG, FIXTURE_OPTS + [
        "CHECKPOINT_FOLDER", ".", "TPU.async_checkpointing", True])
    info = {"depth_hw": 64, "map_hw": 64}
    jpol = jax_registry.get_policy(jcfg.MODEL.policy_name).from_config(
        jcfg, info)
    params = jax.device_get(jpol.init_params(jax.random.PRNGKey(0)))
    del params["depth_encoder"]
    trainer = _jax_trainer(jcfg)
    os.makedirs(os.path.join(out, "pickle"), exist_ok=True)
    os.chdir(out)
    try:
        state = jax.device_get(optax.adam(jcfg.IL.lr).init(params))
        _save_orbax(trainer, params, state)
        twin = jcfg.clone()
        twin.defrost()
        twin.TPU.async_checkpointing = False
        twin.CHECKPOINT_FOLDER = "pickle"
        twin.freeze()
        trainer.config = twin
        trainer.save_checkpoint("ckpt.0.pth")
    finally:
        os.chdir(REPO)
    arrays = {name: {"dtype": str(a.dtype), "shape": list(a.shape),
                     "sha256": hashlib.sha256(a.tobytes()).hexdigest()}
              for name, a in _leaves(_restore(
                  os.path.join(out, "ckpt.0.pth.orbax")))}
    with open(os.path.join(out, "fixture.json"), "w") as f:
        json.dump({"config": FIXTURE_CONFIG, "opts": FIXTURE_OPTS,
                   "checkpoint": "ckpt.0.pth",
                   "pickle_twin": "pickle/ckpt.0.pth",
                   "arrays": arrays}, f, indent=1, sort_keys=True)
        f.write("\n")


def test_committed_fixture_is_what_the_generator_writes(tmp_path):
    """Regenerated into ``tmp_path``: both Orbax checkpoints restore to the
    same arrays, both pickles hold them, and ``fixture.json`` is the same
    (bytes differ: Orbax writes UUIDs and times). The whole fixture stays
    under 2 MB, and the port reads it to the recorded hashes."""
    out = str(tmp_path / "fixture")
    write_small_fixture(out)
    with open(os.path.join(out, "fixture.json")) as f:
        fresh = json.load(f)
    with open(os.path.join(FIXTURE, "fixture.json")) as f:
        committed = json.load(f)
    assert fresh == committed
    for root in (out, FIXTURE):
        _assert_same_tree(
            orbax_io.load_orbax_tree(os.path.join(root, "ckpt.0.pth.orbax")),
            _restore(os.path.join(FIXTURE, "ckpt.0.pth.orbax")))
        with open(os.path.join(root, "pickle", "ckpt.0.pth"), "rb") as f:
            twin = pickle.load(f)
        for name, a in _leaves({"params": twin["params"],
                                "optim_state": twin["optim_state"]}):
            assert hashlib.sha256(a.tobytes()).hexdigest() == (
                committed["arrays"][name]["sha256"]), name
    size = sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(FIXTURE) for f in files)
    assert size < 2 * 2**20
    ckpt = orbax_io.load_orbax_checkpoint(
        os.path.join(FIXTURE, "ckpt.0.pth.orbax"))
    got = dict(_leaves({"params": ckpt["params"],
                        "optim_state": ckpt["optim_state"]}))
    assert set(got) == set(committed["arrays"])
    for name, want in committed["arrays"].items():
        assert hashlib.sha256(got[name].tobytes()).hexdigest() == (
            want["sha256"]), name
    assert ckpt["config"]["CHECKPOINT_FOLDER"] == "."


def test_the_port_reads_the_fixture_without_the_oracles():
    """In a process where jax, optax, orbax, tensorstore and zstandard
    cannot be imported, ``load_checkpoint`` reads the committed fixture
    to the hashes orbax's restore gave."""
    code = (
        "import hashlib, json, sys\n"
        "for m in ('jax', 'jaxlib', 'optax', 'orbax', 'tensorstore',\n"
        "          'zstandard'):\n"
        "    sys.modules[m] = None\n"
        "from ivlnce_tpu_torch.trainers.base_trainer import load_checkpoint\n"
        f"ckpt = load_checkpoint({os.path.join(FIXTURE, 'ckpt.0.pth')!r})\n"
        "adam = ckpt['optim_state'][0]\n"
        "out = {'count': int(adam['count']), 'epoch': ckpt['epoch'],\n"
        "       'w': hashlib.sha256(ckpt['params']['action_distribution']\n"
        "            ['linear']['w'].tobytes()).hexdigest(),\n"
        "       'state_dict': len(ckpt['state_dict'])}\n"
        "print(json.dumps(out))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    with open(os.path.join(FIXTURE, "fixture.json")) as f:
        arrays = json.load(f)["arrays"]
    assert out["w"] == arrays["params.action_distribution.linear.w"][
        "sha256"]
    assert (out["count"], out["epoch"]) == (0, 0)
    assert out["state_dict"] > 50


# -- (f) the trainer ----------------------------------------------------------------
def test_eval_of_an_orbax_folder_matches_jax(tmp_path):
    """JAX's ``_eval_checkpoint`` on ``ckpt.0.pth`` (its Orbax directory)
    against the port's ``eval()`` of the folder that holds it and its
    sidecar: identical actions at every step and equal stats JSONs (the
    scenario of ``test_torch_eval.py``: 2 lanes, one tour of two
    episodes each)."""
    os.chdir(REPO)
    root = str(tmp_path)
    ds = os.path.join(root, "ds")
    teval._tiny_dataset(ds)
    jcfg = teval._configure(jax_config(teval.CONFIG), ds, "jax")
    jcfg.defrost()
    jcfg.TPU.async_checkpointing = True
    jcfg.freeze()
    register_all()
    tcfg = teval._configure(torch_config(teval.CONFIG), ds, "torch")
    info = {"depth_hw": 64, "map_hw": 64}
    jpol = jax_registry.get_policy("MapCMAPolicy").from_config(jcfg, info)
    params = jax.device_get(jpol.init_params(jax.random.PRNGKey(3)))
    jt = _jax_trainer(jcfg)
    state = jax.device_get(optax.adam(jcfg.IL.lr).init(params))
    path = _save_orbax(jt, params, state, "ckpt.0.pth", epoch=0, step_id=0)
    folder = os.path.dirname(tcfg.EVAL_CKPT_PATH_DIR)
    for name in ("ckpt.0.pth.orbax", "ckpt.0.pth.meta.json"):
        src = path + name[len("ckpt.0.pth"):]
        (shutil.copytree if os.path.isdir(src) else shutil.copy)(
            src, os.path.join(folder, name))
    tcfg.defrost()
    tcfg.EVAL_CKPT_PATH_DIR = folder
    tcfg.freeze()

    actions = {"jax": [], "torch": []}
    j_step = jt._policy_step

    def jax_step(*args, **kwargs):
        out, batch = j_step(*args, **kwargs)
        actions["jax"].append(np.asarray(out.actions).ravel().tolist())
        return out, batch

    jt._policy_step = jax_step
    random.seed(0)  # the vector env shuffles scenes over lanes
    with JaxTensorboardWriter(jcfg.TENSORBOARD_DIR) as writer:
        jt._eval_checkpoint(path, writer, 0)

    tt = torch_registry.get_trainer(tcfg.TRAINER_NAME)(tcfg, "cpu")
    t_step = tt._policy_step
    evaluated = []
    t_eval = tt._eval_checkpoint

    def torch_step(*args, **kwargs):
        acts, rnn = t_step(*args, **kwargs)
        actions["torch"].append(acts.ravel().tolist())
        return acts, rnn

    def recording_eval(checkpoint_path, writer, index=0):
        evaluated.append((os.path.basename(checkpoint_path), index))
        return t_eval(checkpoint_path, writer, index)

    tt._policy_step = torch_step
    tt._eval_checkpoint = recording_eval
    random.seed(0)
    tt.eval()

    assert evaluated == [("ckpt.0.pth.orbax", 0)]
    assert len(actions["torch"]) > 10
    assert actions["torch"] == actions["jax"]
    for pattern in ("iterative_stats_ckpt_0_val_seen.json",
                    "iterative_all_stats_ckpt_0_val_seen.json",
                    "dtw_data_ckpt_0_val_seen.json"):
        assert teval._load(tcfg.RESULTS_DIR, pattern) == teval._load(
            jcfg.RESULTS_DIR, pattern), pattern


def test_folder_listing(training_ckpt, tmp_path, monkeypatch):
    """A folder with an Orbax checkpoint, its sidecar and a pickle: the
    port evaluates each checkpoint once, under its index; ``ckpt.N.pth``
    naming its Orbax directory evaluates that one. The JAX package lists
    the sidecar as a checkpoint of its own, which its ``load_checkpoint``
    cannot read, and lists ``ckpt.N.pth`` as a folder (ROADMAP §3, fault
    2)."""
    folder = tmp_path / "ckpts"
    shutil.copytree(training_ckpt["path"] + ".orbax",
                    folder / "ckpt.3.pth.orbax")
    shutil.copy(training_ckpt["path"] + ".meta.json",
                folder / "ckpt.3.pth.meta.json")
    with open(folder / "ckpt.10.pth", "wb") as f:
        pickle.dump({"params": {}}, f)
    assert tbt.checkpoints_in(str(folder)) == [
        (3, str(folder / "ckpt.3.pth.orbax")),
        (10, str(folder / "ckpt.10.pth"))]

    os.chdir(REPO)
    register_all()
    opts = _train_dirs(str(tmp_path)) + ["EVAL_CKPT_PATH_DIR", str(folder)]
    tcfg = torch_config(teval.CONFIG, opts)
    jcfg = jax_config(teval.CONFIG, opts)
    seen = {"jax": [], "torch": []}

    def recorder(side):
        def record(self, checkpoint_path, writer, index=0, *args):
            seen[side].append((os.path.basename(checkpoint_path), index))
        return record

    jcls = jax_registry.get_trainer(jcfg.TRAINER_NAME)
    tcls = torch_registry.get_trainer(tcfg.TRAINER_NAME)
    monkeypatch.setattr(jcls, "_eval_checkpoint", recorder("jax"))
    monkeypatch.setattr(tcls, "_eval_checkpoint", recorder("torch"))
    jt = jcls(jcfg)
    jt.eval()
    tcls(tcfg, "cpu").eval()
    assert seen["torch"] == [("ckpt.3.pth.orbax", 3), ("ckpt.10.pth", 10)]
    assert sorted(seen["jax"]) == sorted([
        ("ckpt.3.pth.orbax", 3), ("ckpt.3.pth.meta.json", 3),
        ("ckpt.10.pth", 10)])
    with pytest.raises(pickle.UnpicklingError):
        jt.load_checkpoint(str(folder / "ckpt.3.pth.meta.json"))

    seen["torch"].clear()
    for cfg in (tcfg, jcfg):
        cfg.defrost()
        cfg.EVAL_CKPT_PATH_DIR = str(folder / "ckpt.3.pth")
        cfg.freeze()
    tcls(tcfg, "cpu").eval()
    assert seen["torch"] == [("ckpt.3.pth", 3)]
    with pytest.raises(FileNotFoundError):
        jcls(jcfg).eval()


def test_warm_start_matches_jax(training_ckpt, tmp_path):
    """``IL.load_from_ckpt`` from the Orbax checkpoint: the port's weights
    are the JAX trainer's (``_merge_loaded_params``, base_trainer.py:218)
    exactly, and the first train step's loss is within LOSS_RTOL and each
    gradient within GRAD_TOL of its largest |value| of JAX's
    ``make_train_step`` on the same batch. The map encoder's gradients are
    left out as in ``test_train_step_loss_and_gradients_match_jax``:
    float32 cannot resolve them behind batch-statistics BatchNorm, which
    ``test_map_encoder_backward_matches_jax`` holds in float64."""
    os.chdir(REPO)
    load = ["IL.load_from_ckpt", True,
            "IL.ckpt_to_load", training_ckpt["path"]]
    opts = training_ckpt["opts"] + load
    jt = _jax_trainer(jax_config(MAP_CONFIG, opts))
    jt._initialize_policy(jt.config, load_from_ckpt=True)
    jparams = jax.device_get(jt.params)
    register_all()
    tcfg = torch_config(MAP_CONFIG, opts)
    tt = torch_registry.get_trainer(tcfg.TRAINER_NAME)(tcfg, "cpu")
    tt._initialize_training(tcfg)
    want = params_from_jax(jparams)
    state = tt.policy.state_dict()
    for k, v in want.items():
        assert torch.equal(state[k], v), k
    assert (tt.start_epoch, tt.step_id) == (0, 0)

    batch = _train_batch(tt.policy, UNPADDED)
    tour = _tour_masks(batch[3])
    _, jgrads, jloss, _, _, _ = _jax_grad_step(training_ckpt["jpol"])(
        jparams, batch, tour)
    loss = _torch_loss(tt.policy, batch, tour)[0]
    loss.backward()
    assert abs(float(loss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    _assert_grads_match(tt.policy, jgrads, skip=(MAP_ENCODER,))


@pytest.mark.parametrize("custom_lr", [False, True])
def test_resume_restores_adam(custom_lr, request):
    """``IL.is_requeue`` from the Orbax checkpoint: each parameter's
    moments are the restored ``mu`` and ``nu`` in the port's layout, bit
    for bit, its step their count, and epoch and step come from the
    sidecar."""
    ckpt = request.getfixturevalue(
        "custom_lr_ckpt" if custom_lr else "training_ckpt")
    os.chdir(REPO)
    register_all()
    tcfg = torch_config(MAP_CONFIG, ckpt["opts"] + [
        "IL.load_from_ckpt", True, "IL.is_requeue", True,
        "IL.ckpt_to_load", ckpt["path"]])
    tt = torch_registry.get_trainer(tcfg.TRAINER_NAME)(tcfg, "cpu")
    tt._initialize_training(tcfg)
    assert (tt.start_epoch, tt.step_id) == (4, 11)
    restored = _restore(ckpt["path"] + ".orbax")["optim_state"]
    adams = ([restored["inner_states"][k]["inner_state"][0]
              for k in ("map", "regular")] if custom_lr else [restored[0]])
    moments = {}
    for adam in adams:
        mu = params_from_jax({k: v for k, v in adam["mu"].items()
                              if v is not None})
        nu = params_from_jax({k: v for k, v in adam["nu"].items()
                              if v is not None})
        for name in mu:
            moments[name] = (mu[name], nu[name], int(adam["count"]))
    params = dict(tt.policy.named_parameters())
    assert len(tt.optimizer.param_groups) == (2 if custom_lr else 1)
    for name, p in params.items():
        st = tt.optimizer.state[p]
        m, v, count = moments[name]
        assert torch.equal(st["exp_avg"], m), name
        assert torch.equal(st["exp_avg_sq"], v), name
        assert float(st["step"]) == count == 2, name
    assert any(float(tt.optimizer.state[p]["exp_avg"].abs().max()) > 0
               for p in params.values())


def test_jax_resume_from_orbax_fails_in_optax(training_ckpt):
    """ROADMAP §3, fault 1: the JAX trainer's ``IL.is_requeue`` sets its
    optax state to what orbax restores, which optax cannot update."""
    restored = _restore(training_ckpt["path"] + ".orbax")
    params = restored["params"]
    grads = jax.tree_util.tree_map(np.zeros_like, params)
    with pytest.raises(AttributeError, match="mu"):
        optax.adam(1e-3).update(grads, restored["optim_state"], params)


if __name__ == "__main__":
    # regenerate the committed fixture:
    # JAX_PLATFORMS=cpu python -m tests.test_torch_orbax
    shutil.rmtree(FIXTURE, ignore_errors=True)
    write_small_fixture(FIXTURE)
