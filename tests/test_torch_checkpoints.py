"""The port reads every checkpoint kind the JAX package's eval reads, and
the reference's external weights, into the state the JAX package's
loaders give (``params_from_jax`` of the JAX tree, tensor for tensor):

- a pickle written by the JAX trainer's own ``save_checkpoint``, with its
  optax ``optim_state``, read in a process where the JAX stack cannot be
  imported;
- a reference-layout ``.pth`` (``net.*``, ``action_distribution.*`` and
  the reference's ``net._scale``), from the reference-named replicas of
  ``tests/test_policy_checkpoint_parity.py``;
- the port's own ``torch.save`` file;
- the DDPPO depth encoder, the pretrained map encoder and RedNet (with
  and without a ``module.`` prefix), from files the tests write.

It also holds the port's copies of ``convert_state_dict`` and
``remap_reference_policy_params`` against the JAX ones, the merge's
rules, and the refusals (an Orbax directory, a pickled config class)."""

import json
import math
import os
import re
import subprocess
import sys
import types

import numpy as np
import optax
import pytest
import torch

from ivlnce_tpu.config import get_config as jax_config
from ivlnce_tpu.models import checkpoint_io as jcio
from ivlnce_tpu.trainers.base_trainer import BaseVLNCETrainer as JaxTrainer
from ivlnce_tpu_torch.config import get_config as torch_config
from ivlnce_tpu_torch.mapping import obs_transforms as TOT
from ivlnce_tpu_torch.models import checkpoint_io as tcio
from ivlnce_tpu_torch.models.convert import (
    params_from_jax,
    rednet_params_from_jax,
)
from ivlnce_tpu_torch.run import register_all
from ivlnce_tpu_torch.trainers.base_trainer import (
    BaseVLNCETrainer,
    load_checkpoint,
    save_checkpoint,
)
from ivlnce_tpu_torch.utils.registry import registry
from tests import test_policy_checkpoint_parity as ref
from tests.test_models import TorchGNResNetEncoder
from tests.test_torch_train import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_STACK = ("jax", "jaxlib", "optax", "flax", "orbax")


def _port_config(policy_name="MapCMAPolicy", **paths):
    """The port's config at the replicas' widths."""
    cfg = torch_config()
    cfg.defrost()
    m = cfg.MODEL
    m.policy_name = policy_name
    m.STATE_ENCODER.hidden_size = ref.HIDDEN
    m.DEPTH_ENCODER.output_size = ref.D_OUT
    m.DEPTH_ENCODER.ddppo_checkpoint = paths.get("ddppo", "NONE")
    m.SEMANTIC_MAP_ENCODER.output_size = ref.M_OUT
    m.SEMANTIC_MAP_ENCODER.channels = ref.MAP_CH
    m.SEMANTIC_MAP_ENCODER.last_ch_mult = 4
    m.SEMANTIC_MAP_ENCODER.from_pretrained = "map_encoder" in paths
    m.SEMANTIC_MAP_ENCODER.checkpoint = paths.get("map_encoder", "")
    m.RGB_ENCODER.output_size = ref.R_OUT
    m.INSTRUCTION_ENCODER.vocab_size = ref.VOCAB
    m.INSTRUCTION_ENCODER.embedding_size = ref.EMB
    m.INSTRUCTION_ENCODER.hidden_size = ref.IHID
    m.INSTRUCTION_ENCODER.use_pretrained_embeddings = False
    m.PROGRESS_MONITOR.use = True
    cfg.freeze()
    return cfg


def _port_state(policy_name="MapCMAPolicy"):
    """The port policy's seeded initial state_dict."""
    register_all()
    torch.manual_seed(0)
    policy = registry.get_policy(policy_name).from_config(
        _port_config(policy_name),
        {"depth_hw": ref.DEPTH_HW, "map_hw": ref.MAP_HW},
    )
    return policy.state_dict()


def _jax_tree(state, tmp_path, name="init.pth"):
    """``state`` as the JAX package's loader reads it: its param tree."""
    path = str(tmp_path / name)
    torch.save({"state_dict": state}, path)
    return jcio.load_reference_policy_checkpoint(path)["params"]


def _n_leaves(tree):
    return sum(_n_leaves(v) if isinstance(v, dict) else 1
               for v in tree.values())


def _assert_states_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def _assert_trees_equal(got, want, path=""):
    assert isinstance(got, dict) == isinstance(want, dict), path
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}.{k}")
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=path)
        assert np.asarray(got).shape == np.asarray(want).shape, path


# -- reference-layout .pth and the port's own file -----------------------------
@pytest.mark.parametrize("policy_name,replica", [
    ("MapCMAPolicy", ref.TorchMapCMA), ("LatentCMAPolicy", ref.TorchLatentCMA),
])
def test_reference_pth_loads_as_the_jax_package_loads_it(
        tmp_path, policy_name, replica):
    torch.manual_seed(11)
    tpolicy = ref.TorchPolicy(replica()).eval()
    ref._randomize_bn_stats(tpolicy)
    # the reference keeps its attention scale as a buffer
    tpolicy.net.register_buffer(
        "_scale", torch.tensor(1.0 / math.sqrt(ref.HIDDEN // 2)))
    path = ref._save_reference_ckpt(tmp_path, tpolicy)

    init = _port_state(policy_name)
    loaded = load_checkpoint(path)
    assert loaded["epoch"] == 7 and loaded["step_id"] == 123
    assert "net._scale" not in loaded["state_dict"]
    got = tcio.merge_params(init, loaded["state_dict"])

    # the JAX package: its loader and merge over the same initial weights
    jloaded = jcio.load_reference_policy_checkpoint(path)
    want = params_from_jax(
        jcio.merge_params(_jax_tree(init, tmp_path), jloaded["params"]))
    _assert_states_equal(got, want)
    # the port's copies of the converters build the same tree
    _assert_trees_equal(
        tcio.jax_params_from_state_dict(tpolicy.state_dict()),
        jloaded["params"])


def test_own_checkpoint_round_trips(tmp_path):
    register_all()
    config = _port_config()
    torch.manual_seed(2)
    policy = registry.get_policy("MapCMAPolicy").from_config(
        config, {"depth_hw": ref.DEPTH_HW, "map_hw": ref.MAP_HW})
    path = str(tmp_path / "ckpt.0.pth")
    save_checkpoint(policy, config, path, epoch=3)
    loaded = load_checkpoint(path)
    assert loaded["epoch"] == 3
    assert loaded["config"]["MODEL"]["policy_name"] == "MapCMAPolicy"
    _assert_states_equal(loaded["state_dict"], policy.state_dict())


# -- the JAX trainer's pickle, with the JAX stack blocked -----------------------
@pytest.mark.parametrize("custom_lr", [False, True])
def test_jax_pickle_loads_without_the_jax_stack(tmp_path, custom_lr):
    params = _jax_tree(_port_state(), tmp_path)
    if custom_lr:
        # the JAX trainer's optimizer with SEMANTIC_MAP_ENCODER.custom_lr
        optimizer = optax.multi_transform(
            {"map": optax.adam(2.5e-6), "regular": optax.adam(1e-4)},
            lambda p: {k: ("map" if k == "map_encoder" else "regular")
                       for k in p},
        )
    else:
        optimizer = optax.adam(1e-4)
    jcfg = jax_config()
    jcfg.defrost()
    jcfg.CHECKPOINT_FOLDER = str(tmp_path)
    jcfg.freeze()
    trainer = types.SimpleNamespace(config=jcfg, params=params,
                                    opt_state=optimizer.init(params))
    JaxTrainer.save_checkpoint(trainer, "ckpt.4.pth", dagger_it=1, epoch=2,
                               step_id=9)

    out = str(tmp_path / "state.pt")
    code = "\n".join([
        "import json, sys",
        *(f"sys.modules[{m!r}] = None" for m in JAX_STACK),
        "import torch",
        "from ivlnce_tpu_torch.models.checkpoint_io import InertJaxObject",
        "from ivlnce_tpu_torch.trainers.base_trainer import load_checkpoint",
        f"ck = load_checkpoint({str(tmp_path / 'ckpt.4.pth')!r})",
        f"torch.save(ck['state_dict'], {out!r})",
        "names, arrays = set(), [0]",
        "def walk(o):",
        "    if isinstance(o, InertJaxObject):",
        "        names.add(type(o).__name__)",
        "        walk(o.args), walk(o.kwargs), walk(o.state)",
        "    elif isinstance(o, (tuple, list)):",
        "        [walk(x) for x in o]",
        "    elif isinstance(o, dict):",
        "        [walk(x) for x in o.values()]",
        "    elif hasattr(o, 'shape'):",
        "        arrays[0] += 1",
        "walk(ck['optim_state'])",
        "print(json.dumps({'names': sorted(names), 'arrays': arrays[0],",
        "                  'epoch': ck['epoch'], 'step_id': ck['step_id'],",
        "                  'config': type(ck['config']).__name__,",
        "                  'jax': sorted(m for m, v in sys.modules.items()",
        "                                if v is not None and",
        "                                m.split('.')[0] in ('jax', 'optax'))}))",
    ])
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    info = json.loads(proc.stdout.strip().splitlines()[-1])
    assert info["jax"] == []
    assert info["epoch"] == 2 and info["step_id"] == 9
    assert info["config"] == "dict"
    assert "ScaleByAdamState" in info["names"]
    if custom_lr:
        # multi_transform's per-group states over masked trees
        assert {"MaskedState", "MaskedNode"} <= set(info["names"])
    # Adam's mu and nu for every leaf of the tree, and its step counts
    assert info["arrays"] > 2 * _n_leaves(params)
    got = torch.load(out, weights_only=True)
    _assert_states_equal(got, params_from_jax(params))


# -- external encoders ---------------------------------------------------------------
def _external_files(tmp_path):
    torch.manual_seed(5)
    depth = TorchGNResNetEncoder(spatial_size=ref.DEPTH_HW // 2)
    ddppo = {f"actor_critic.net.visual_encoder.{k}": v
             for k, v in depth.state_dict().items()}
    # keys the loader skips: the rest of the DDPPO agent
    ddppo["actor_critic.net.prev_action_embedding.weight"] = torch.ones(5, 32)
    ddppo["actor_critic.action_distribution.linear.bias"] = torch.ones(4)
    map_encoder = ref.TorchMapEncoder()
    ref._randomize_bn_stats(map_encoder)
    maps = {f"encoder.cnn.{k}": v
            for k, v in map_encoder.cnn.state_dict().items()}
    maps["decoder.0.weight"] = torch.ones(3)
    paths = {"ddppo": str(tmp_path / "ddppo.pth"),
             "map_encoder": str(tmp_path / "map_encoder.pth")}
    torch.save({"state_dict": ddppo}, paths["ddppo"])
    torch.save({"state_dict": maps}, paths["map_encoder"])
    return paths


def test_external_encoders_load_as_the_jax_package_loads_them(tmp_path,
                                                             caplog):
    paths = _external_files(tmp_path)
    init = _port_state()
    with caplog.at_level("INFO", logger="ivlnce_tpu_torch"):
        got = BaseVLNCETrainer._load_external_encoders(
            _port_config(**paths), init)
    assert f"Loaded DDPPO depth encoder: {paths['ddppo']}" in caplog.text
    assert f"Loaded map encoder: {paths['map_encoder']}" in caplog.text

    # the JAX trainer's _load_external_encoders on the same weights
    tree = _jax_tree(init, tmp_path)
    depth = tree["depth_encoder"]
    depth["visual_encoder"] = jcio.merge_params(
        depth["visual_encoder"], jcio.load_ddppo_depth_encoder(paths["ddppo"]))
    tree["map_encoder"] = jcio.merge_params(
        tree["map_encoder"], jcio.load_map_encoder(paths["map_encoder"]))
    _assert_states_equal(got, params_from_jax(tree))
    changed = {k for k in init if not torch.equal(init[k], got[k])}
    assert any(k.startswith("net.depth_encoder.visual_encoder.")
               for k in changed)
    assert any(k.startswith("net.map_encoder.cnn.") for k in changed)
    assert all(k.startswith(("net.depth_encoder.visual_encoder.",
                             "net.map_encoder.cnn.")) for k in changed)


def test_missing_external_files_keep_the_seeded_weights(tmp_path, caplog):
    init = _port_state()
    config = _port_config(ddppo=str(tmp_path / "none.pth"),
                          map_encoder=str(tmp_path / "none2.pth"))
    with caplog.at_level("INFO", logger="ivlnce_tpu_torch"):
        got = BaseVLNCETrainer._load_external_encoders(config, init)
    _assert_states_equal(got, init)
    assert "Loaded" not in caplog.text


@pytest.mark.parametrize("prefix", ["module.", ""])
def test_rednet_file_loads_as_the_jax_package_loads_it(tmp_path, monkeypatch,
                                                       prefix):
    from ivlnce_tpu_torch.models.rednet import RedNet

    torch.manual_seed(1)
    source = RedNet().eval()
    ref._randomize_bn_stats(source)
    state = source.state_dict()
    path = str(tmp_path / "rednet.pkl")
    torch.save({"model_state": {prefix + k: v for k, v in state.items()},
                "epoch": 1}, path)
    monkeypatch.setattr(TOT, "REDNET_CHECKPOINT", path)
    model = TOT._load_rednet(torch_config(), torch.device("cpu"))
    got = model.state_dict()
    _assert_states_equal(got, rednet_params_from_jax(jcio.load_rednet(path)))
    _assert_states_equal(got, state)
    _assert_trees_equal(tcio.convert_state_dict(state),
                        jcio.convert_state_dict(state))


# -- the merge and the refusals ------------------------------------------------------
def test_merge_follows_the_jax_merge_rules():
    target = {"a.weight": torch.zeros(2, 3), "a.bias": torch.ones(2),
              "bn.num_batches_tracked": torch.tensor(0)}
    merged = tcio.merge_params(target, {
        "a.weight": np.full((2, 3), 2.0, np.float64),
        "bn.num_batches_tracked": torch.tensor(7, dtype=torch.int32),
    })
    assert merged["a.weight"].dtype == torch.float32
    assert torch.equal(merged["a.weight"], torch.full((2, 3), 2.0))
    assert torch.equal(merged["a.bias"], torch.ones(2))  # kept
    assert merged["bn.num_batches_tracked"].dtype == torch.int64
    assert int(merged["bn.num_batches_tracked"]) == 7
    with pytest.raises(KeyError, match="unexpected tensor b.weight"):
        tcio.merge_params(target, {"b.weight": torch.zeros(1)})
    with pytest.raises(ValueError, match="shape mismatch at a.bias"):
        tcio.merge_params(target, {"a.bias": torch.zeros(3)})


@pytest.mark.parametrize("layout", ["directory", "suffix"])
def test_orbax_directories_raise_with_the_reason(tmp_path, layout):
    """An Orbax directory (``path`` or ``path + ".orbax"``) that holds no
    committed checkpoint raises, naming it and why; the port reads
    committed ones (``tests/test_torch_orbax.py``)."""
    path = str(tmp_path / "ckpt.0.pth")
    directory = path if layout == "directory" else path + ".orbax"
    os.makedirs(directory)
    with pytest.raises(ValueError, match=(
            f"{re.escape(directory)} has no _CHECKPOINT_METADATA: not a "
            "committed Orbax checkpoint")):
        load_checkpoint(path)


class _PickledConfig(dict):
    """Stands in for a reference checkpoint's yacs config node."""


def test_pickled_config_classes_are_refused_by_both_packages(tmp_path):
    path = str(tmp_path / "ckpt.0.pth")
    torch.save({"state_dict": {}, "config": _PickledConfig(a=1)}, path)
    with pytest.raises(Exception, match="_PickledConfig"):
        load_checkpoint(path)
    with pytest.raises(Exception, match="_PickledConfig"):
        jcio.load_reference_policy_checkpoint(path)
