"""Checkpoint reading for the port, from
``ivlnce_tpu/models/checkpoint_io.py``.

- The name table between the JAX package's parameter trees and the
  reference (torch) module names. The port's modules carry the reference
  names, so a tree converts to a ``state_dict`` by these renames
  (``models/convert.py``).
- The JAX package's pure-numpy converters, as the port's own copies:
  ``convert_state_dict`` and ``remap_reference_policy_params`` turn a
  reference ``state_dict`` into the JAX package's tree
  (``jax_params_from_state_dict``, for writing the JAX layout).
- ``merge_params``: the JAX merge's rules over ``state_dict`` names.
- Loaders of the reference's files, each returning a ``state_dict`` in
  the port's names: a policy checkpoint (``load_reference_policy_checkpoint``),
  the DDPPO depth encoder, RedNet and the pretrained map encoder.
- ``load_jax_pickle``: the JAX package's own pickles, read without
  importing JAX; ``adam_state_from_optax`` resumes their optax Adam
  state in the port's ``torch.optim.Adam``.
"""

from __future__ import annotations

import pickle
import re
from typing import Any, Dict

import numpy as np
import torch

Params = Dict[str, Any]

# habitat's RNNStateEncoder wraps the GRU in an ``.rnn`` attribute
RNN_WRAPPED = ("state_encoder", "second_state_encoder")

# kernel-size-1 Conv1d attention projections: torch stores (out, in, 1),
# the JAX package (out, in)
CONV1D_KEYS = ("dep_kv", "map_kv", "rgb_kv", "depth_kv", "text_k")

# instruction encoder submodules: JAX name -> reference name
INSTRUCTION_RENAMES = {
    "embedding": "embedding_layer",
    "lstm_fwd": "encoder_rnn",
    "lstm_bwd": "encoder_rnn",  # the reverse direction (``_reverse``)
}

# the RGB trunk: the JAX package's torchvision stage names -> the
# reference's positions in ``rgb_encoder.cnn``, Sequential(*resnet
# .children()) (resnet_encoders.py:139; 2 relu and 3 maxpool hold no
# parameters)
RGB_TRUNK_POSITIONS = {
    "conv1": "0", "bn1": "1",
    "layer1": "4", "layer2": "5", "layer3": "6", "layer4": "7",
}

# recurrent leaves: JAX name -> torch name (``_l0`` + optional reverse)
RNN_LEAVES = {
    "w_ih": "weight_ih",
    "w_hh": "weight_hh",
    "b_ih": "bias_ih",
    "b_hh": "bias_hh",
}

# norm / linear / conv leaves: JAX name -> torch name
LEAVES = {
    "w": "weight",
    "b": "bias",
    "scale": "weight",
    "bias": "bias",
    "mean": "running_mean",
    "var": "running_var",
}

# the reference's attention scale buffer: a constant the port computes
REFERENCE_SCALE_KEY = "net._scale"

_RNN_RE = re.compile(r"^(weight|bias)_(ih|hh)_l0(_reverse)?$")


# -----------------------------------------------------------------------------
# reference state_dict -> the JAX package's tree (pure numpy)
# -----------------------------------------------------------------------------
def convert_state_dict(state_dict: Dict[str, "np.ndarray"]) -> Params:
    """Convert a flat torch state_dict (tensors or ndarrays) to a nested
    param tree following the JAX package's conventions."""
    arrays: Dict[str, np.ndarray] = {}
    for k, v in state_dict.items():
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        arrays[k] = np.asarray(v)

    root: Params = {}
    # group by parent module so weight rank can disambiguate bias naming
    by_module: Dict[str, Dict[str, np.ndarray]] = {}
    for k, v in arrays.items():
        parts = k.split(".")
        mod, leaf = ".".join(parts[:-1]), parts[-1]
        by_module.setdefault(mod, {})[leaf] = v

    for mod, leaves in by_module.items():
        node = root
        if mod:
            for p in mod.split("."):
                node = node.setdefault(p, {})
        _convert_module(node, leaves)
    return root


def _convert_module(node: Params, leaves: Dict[str, np.ndarray]) -> None:
    weight = leaves.get("weight")
    is_norm = weight is not None and weight.ndim == 1
    has_running = "running_mean" in leaves

    for leaf, v in leaves.items():
        m = _RNN_RE.match(leaf)
        if m:
            kind, gate, rev = m.groups()
            key = ("w_" if kind == "weight" else "b_") + gate
            if rev:
                node.setdefault("_reverse", {})[key] = v
            else:
                node[key] = v
        elif leaf == "weight":
            if v.ndim == 4:
                node["w"] = np.transpose(v, (2, 3, 1, 0))
            elif v.ndim == 1:
                node["scale"] = v
            else:
                node["w"] = v
        elif leaf == "bias":
            node["bias" if (is_norm or has_running) else "b"] = v
        elif leaf == "running_mean":
            node["mean"] = v
        elif leaf == "running_var":
            node["var"] = v
        elif leaf == "num_batches_tracked":
            pass
        else:
            node[leaf] = v


# reference rgb_encoder.cnn is Sequential(*resnet.children()[:-1])
# (resnet_encoders.py:139): positional indices -> torchvision stage names
_RESNET_SEQ_TO_NAME = {v: k for k, v in RGB_TRUNK_POSITIONS.items()}


def remap_reference_policy_params(params: Params) -> Params:
    """Translate the reference policy's torch module names onto the JAX
    package's param-tree names (init_map_cma / init_latent_cma):

    - instruction_encoder.embedding_layer -> .embedding;
      .encoder_rnn (+_reverse)            -> .lstm_fwd / .lstm_bwd
    - state_encoder.rnn / second_state_encoder.rnn -> flattened (habitat's
      RNNStateEncoder wraps the GRU in an .rnn attribute)
    - rgb_encoder.cnn.<seq idx> -> torchvision stage names
    - kv/text_k Conv1d weights squeeze their trailing kernel dim
    - the '_scale' attention buffer is dropped (a constant)
    """
    p = dict(params)
    ie = p.get("instruction_encoder")
    if isinstance(ie, dict):
        ie = dict(ie)
        if "embedding_layer" in ie:
            ie["embedding"] = ie.pop("embedding_layer")
        rnn = ie.pop("encoder_rnn", None)
        if rnn is not None:
            rnn = dict(rnn)
            bwd = rnn.pop("_reverse", None)
            ie["lstm_fwd"] = rnn
            if bwd is not None:
                ie["lstm_bwd"] = bwd
        p["instruction_encoder"] = ie
    for k in RNN_WRAPPED:
        node = p.get(k)
        if isinstance(node, dict) and set(node) == {"rnn"}:
            p[k] = node["rnn"]
    for k in CONV1D_KEYS:
        node = p.get(k)
        if isinstance(node, dict):
            w = node.get("w")
            if w is not None and w.ndim == 3 and w.shape[-1] == 1:
                p[k] = {**node, "w": w[..., 0]}
    rgb = p.get("rgb_encoder")
    if isinstance(rgb, dict) and isinstance(rgb.get("cnn"), dict):
        cnn = rgb["cnn"]
        if any(idx in cnn for idx in _RESNET_SEQ_TO_NAME):
            new = {
                name: cnn[idx]
                for idx, name in _RESNET_SEQ_TO_NAME.items()
                if idx in cnn
            }
            for k2, v2 in cnn.items():
                if k2 not in _RESNET_SEQ_TO_NAME:
                    new.setdefault(k2, v2)
            p["rgb_encoder"] = {**rgb, "cnn": new}
    p.pop("_scale", None)
    return p


def jax_params_from_state_dict(state: Dict[str, Any]) -> Params:
    """A reference-layout policy state_dict (``net.*`` and
    ``action_distribution.*``; the port's own) -> the JAX package's param
    tree, as its ``load_reference_policy_checkpoint`` builds it."""
    net = {k[len("net."):]: v for k, v in state.items()
           if k.startswith("net.")}
    head = {
        k[len("action_distribution."):]: v
        for k, v in state.items()
        if k.startswith("action_distribution.")
    }
    params = remap_reference_policy_params(convert_state_dict(net))
    params["action_distribution"] = convert_state_dict(head)
    return params


# -----------------------------------------------------------------------------
# merging loaded weights into a module's state_dict
# -----------------------------------------------------------------------------
def merge_params(target: Dict[str, torch.Tensor],
                 source: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Merge loaded weights into an initialised ``state_dict`` with the
    JAX package's ``merge_params`` rules: a key the target lacks raises
    ``KeyError``, a shape mismatch ``ValueError``; a target key missing
    from ``source`` keeps its initialised value; values take the
    target's dtype."""
    out = dict(target)
    for k, v in source.items():
        if k not in target:
            raise KeyError(f"unexpected tensor {k}")
        tgt = target[k]
        if not isinstance(v, torch.Tensor):
            v = torch.from_numpy(np.ascontiguousarray(v))
        if tuple(tgt.shape) != tuple(v.shape):
            raise ValueError(
                f"shape mismatch at {k}: "
                f"checkpoint {tuple(v.shape)} vs model {tuple(tgt.shape)}"
            )
        out[k] = v.to(dtype=tgt.dtype)
    return out


# -----------------------------------------------------------------------------
# the reference's files (reference key surgery), in the port's names
# -----------------------------------------------------------------------------
def load_torch_file(path: str):
    """``torch.load`` of a reference file onto the CPU, tensors and plain
    containers only: a file that pickles other classes (a yacs config)
    raises, naming the class."""
    return torch.load(path, map_location="cpu", weights_only=True)


def load_reference_policy_checkpoint(path: str) -> Dict[str, Any]:
    """A reference training checkpoint (base_il_trainer.py:143-168) or the
    port's own: the raw dict, its ``state_dict`` (``net.*`` and
    ``action_distribution.*``) without the reference's ``net._scale``."""
    ckpt = load_torch_file(path)
    state = dict(ckpt["state_dict"])
    state.pop(REFERENCE_SCALE_KEY, None)
    return {**ckpt, "state_dict": state}


def load_ddppo_depth_encoder(path: str) -> Dict[str, torch.Tensor]:
    """gibson-2plus-resnet50.pth (resnet_encoders.py:48-61):
    ``actor_critic.net.visual_encoder.*`` -> the policy's
    ``net.depth_encoder.visual_encoder.*``."""
    weights = {}
    for k, v in load_torch_file(path)["state_dict"].items():
        parts = k.split(".")[2:]
        if not parts or parts[0] != "visual_encoder":
            continue
        weights["net.depth_encoder." + ".".join(parts)] = v
    return weights


def load_rednet(path: str) -> Dict[str, torch.Tensor]:
    """rednet_mp3d_best_model.pkl (mapper.py:758-779): its ``model_state``,
    without a ``module.`` prefix, in RedNet's names."""
    state = load_torch_file(path)["model_state"]
    first = next(iter(state))
    if first.startswith("module."):
        state = {k[len("module."):]: v for k, v in state.items()}
    return dict(state)


def load_map_encoder(path: str) -> Dict[str, torch.Tensor]:
    """The pretrained map encoder (map_encoder.py:62-70): keys under
    ``encoder.cnn.`` -> the policy's ``net.map_encoder.cnn.*``."""
    prefix = "encoder.cnn."
    return {
        "net.map_encoder.cnn." + k[len(prefix):]: v
        for k, v in load_torch_file(path)["state_dict"].items()
        if k.startswith(prefix)
    }


# -----------------------------------------------------------------------------
# the JAX package's own pickles
# -----------------------------------------------------------------------------
JAX_STACK_MODULES = ("jax", "jaxlib", "optax", "flax", "chex", "orbax")


class InertJaxObject:
    """Stands in for a class of the JAX stack in a JAX pickle (the optax
    states of ``optim_state``): keeps what it was built from and does
    nothing."""

    def __new__(cls, *args, **kwargs):
        obj = super().__new__(cls)
        obj.args, obj.kwargs, obj.state = args, kwargs, None
        return obj

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        self.state = state


class _JaxFreeUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if module.split(".")[0] in JAX_STACK_MODULES:
            return type(name, (InertJaxObject,), {"__module__": module})
        return super().find_class(module, name)


def load_jax_pickle(path: str) -> Dict[str, Any]:
    """A checkpoint pickled by the JAX trainer (``params``,
    ``optim_state``, ``config``, ...), read without importing the JAX
    stack: its classes (optax's optimizer states) come back inert. Like
    any pickle it can run code: read only files a trusted trainer
    wrote."""
    with open(path, "rb") as f:
        return _JaxFreeUnpickler(f).load()


# optax's state classes, by name (they come back as InertJaxObjects): the
# containers ``adam_state_from_optax`` walks, and Adam's own state
_OPTAX_CONTAINERS = ("MultiTransformState", "PartitionState", "MaskedState")
_OPTAX_EMPTY = ("EmptyState", "ScaleState")
_BN_STATISTICS = ("running_mean", "running_var", "num_batches_tracked")


def _adam_states(node, where: str = "optim_state") -> list:
    """The ``ScaleByAdamState``s of an optax state read by
    ``load_jax_pickle``: ``optax.adam``'s ``(ScaleByAdamState,
    EmptyState)``, or ``multi_transform``'s labels, each a
    ``MaskedState`` over that tuple. Anything else raises, naming it."""
    if isinstance(node, (tuple, list)):
        return [s for i, v in enumerate(node)
                for s in _adam_states(v, f"{where}[{i}]")]
    if isinstance(node, dict):
        return [s for k, v in node.items()
                for s in _adam_states(v, f"{where}.{k}")]
    name = type(node).__name__
    if isinstance(node, InertJaxObject):
        if name == "ScaleByAdamState":
            return [node]
        if name in _OPTAX_EMPTY:
            return []
        if name in _OPTAX_CONTAINERS:
            return _adam_states(list(node.args), f"{where}.{name}")
    raise ValueError(f"{where}: {name} is not a state of optax.adam or of "
                     "its multi_transform")


def _unmasked(tree):
    """``tree`` without the ``MaskedNode`` leaves a masked optax state
    holds for the parameters of another label."""
    if isinstance(tree, dict):
        return {k: _unmasked(v) for k, v in tree.items()
                if type(v).__name__ != "MaskedNode"}
    return tree


def adam_state_from_optax(optim_state, optimizer: torch.optim.Adam,
                          policy: torch.nn.Module) -> None:
    """Resume the JAX trainer's optax Adam (``optax.adam``, or the
    ``SEMANTIC_MAP_ENCODER.custom_lr`` ``multi_transform`` of two) in the
    port's ``optimizer`` over ``policy``'s parameters: each parameter's
    ``exp_avg`` / ``exp_avg_sq`` are optax's ``mu`` / ``nu`` in the port's
    names and layout (``params_from_jax``, so convolution moments go HWIO
    -> OIHW as the weights do), its ``step`` its label's ``count``.

    Moments of BatchNorm running statistics (the map encoder's, the RGB
    trunk's) are dropped: the JAX package keeps the statistics in its
    parameter tree, where the port keeps buffers, which Adam never
    moves. Any other moment without a port parameter, a port parameter
    without a moment, and a shape that differs raise, naming the
    tensor."""
    from ivlnce_tpu_torch.models.convert import params_from_jax

    params = dict(policy.named_parameters())
    moments: Dict[str, Dict[str, Any]] = {}
    for adam in _adam_states(optim_state):
        count, mu, nu = adam.args
        exp_avg = params_from_jax(_unmasked(mu))
        exp_avg_sq = params_from_jax(_unmasked(nu))
        for name, m in exp_avg.items():
            if name.endswith(_BN_STATISTICS):
                continue
            if name not in params:
                raise KeyError(f"optax moment {name} has no parameter in "
                               "the port's policy")
            if name in moments:
                raise ValueError(f"two optax states hold moments of {name}")
            shape = tuple(params[name].shape)
            for got in (m, exp_avg_sq[name]):
                if tuple(got.shape) != shape:
                    raise ValueError(
                        f"shape mismatch at {name}: optax moment "
                        f"{tuple(got.shape)} vs parameter {shape}")
            moments[name] = {
                "step": torch.tensor(float(np.asarray(count)),
                                     dtype=torch.float32),
                "exp_avg": m,
                "exp_avg_sq": exp_avg_sq[name],
            }
    missing = sorted(set(params) - set(moments))
    if missing:
        raise KeyError(f"no optax moments for the parameters {missing}")
    names = {id(p): name for name, p in params.items()}
    order = [names[id(p)] for group in optimizer.param_groups
             for p in group["params"]]
    state = optimizer.state_dict()
    state["state"] = {i: moments[name] for i, name in enumerate(order)}
    optimizer.load_state_dict(state)
