"""Carry weights from the JAX package's parameter trees into the port.

``params_from_jax(np_params)`` turns the nested dict of numpy arrays the
JAX MapCMA or LatentCMA policy holds (for example from
``jax.device_get``) into the port's policy state_dict;
``rednet_params_from_jax`` does the same for RedNet."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ivlnce_tpu_torch.models import checkpoint_io as cio


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _leaf(path: str, value: np.ndarray):
    """(torch path, tensor) for one JAX leaf."""
    parts = path.split(".")
    leaf = parts[-1]
    mods = parts[:-1]
    top = mods[0] if mods else ""
    if top == "instruction_encoder" and len(mods) == 2:
        sub = mods[1]
        name = cio.INSTRUCTION_RENAMES[sub]
        if leaf in cio.RNN_LEAVES:
            leaf = cio.RNN_LEAVES[leaf] + "_l0"
            if sub == "lstm_bwd":
                leaf += "_reverse"
        else:
            leaf = cio.LEAVES[leaf]
        return f"instruction_encoder.{name}.{leaf}", value
    if mods[:2] == ["rgb_encoder", "cnn"]:
        mods = mods[:2] + [cio.RGB_TRUNK_POSITIONS[mods[2]]] + mods[3:]
    if top in cio.RNN_WRAPPED and leaf in cio.RNN_LEAVES:
        return f"{top}.rnn.{cio.RNN_LEAVES[leaf]}_l0", value
    if leaf == "w" and value.ndim == 4:
        value = np.transpose(value, (3, 2, 0, 1))  # HWIO -> OIHW
    elif leaf == "w" and top in cio.CONV1D_KEYS and len(mods) == 1:
        value = value[..., None]
    return ".".join(mods + [cio.LEAVES[leaf]]), value


def params_from_jax(np_params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX MapCMA or LatentCMA policy params -> the port's policy
    state_dict."""
    return _state_dict(np_params, "net.")


def rednet_params_from_jax(np_params: Dict[str, Any]
                           ) -> Dict[str, torch.Tensor]:
    """JAX RedNet params (``init_rednet``'s tree) -> the port's RedNet
    state_dict. Convolution weights go HWIO -> OIHW and transposed
    convolution weights HWOI -> IOHW, one permutation for both: the
    inverse of the JAX package's torch-checkpoint import."""
    return _state_dict(np_params, "")


def _state_dict(np_params: Dict[str, Any], prefix: str
                ) -> Dict[str, torch.Tensor]:
    state: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(np_params).items():
        name, value = _leaf(path, value)
        if not name.startswith("action_distribution."):
            name = prefix + name
        state[name] = torch.from_numpy(np.array(value))
        if name.endswith("running_var"):
            state[name[: -len("running_var")] + "num_batches_tracked"] = (
                torch.tensor(0)
            )
    return state
