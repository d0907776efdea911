"""Observation batching utilities (reference:
ivlnce_baselines/common/utils.py:12-146): the PyTorch counterpart of
``ivlnce_tpu/utils/batching.py``. Host arrays are batched with numpy; the
wire decode runs on the device in torch."""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, List, Optional, Set

import numpy as np


def extract_instruction_tokens(
    observations: List[Dict],
    instruction_sensor_uuid: str = "instruction",
    tokens_uuid: str = "tokens",
    max_length: Optional[int] = 200,
) -> List[Dict]:
    """Replace instruction dicts by fixed-length token arrays
    (reference utils.py:12-35, padded to ``max_length`` as the JAX package
    pads them, so both see the same token rows)."""
    if (
        not observations
        or instruction_sensor_uuid not in observations[0]
        or instruction_sensor_uuid == "pointgoal_with_gps_compass"
    ):
        return observations
    for obs in observations:
        entry = obs.get(instruction_sensor_uuid)
        if isinstance(entry, dict) and tokens_uuid in entry:
            tokens = np.asarray(entry[tokens_uuid], dtype=np.int64)
            if max_length is not None:
                out = np.zeros((max_length,), np.int64)
                n = min(len(tokens), max_length)
                out[:n] = tokens[:n]
                tokens = out
            obs[instruction_sensor_uuid] = tokens
    return observations


def batch_obs(
    observations: List[Dict],
    ignore_keys: Optional[Set[str]] = None,
) -> Dict[str, Any]:
    """list of per-lane obs dicts -> dict of stacked numpy arrays; string
    entries (env_name) stay python lists (reference utils.py:57-92)."""
    if ignore_keys is None:
        ignore_keys = {"env_name"}
    batch: Dict[str, List] = defaultdict(list)
    for obs in observations:
        for sensor, value in obs.items():
            if isinstance(value, np.ndarray) and value.dtype == np.uint32:
                value = value.astype(np.int32)
            batch[sensor].append(value)

    out: Dict[str, Any] = {}
    for sensor, values in batch.items():
        if sensor in ignore_keys or isinstance(values[0], str):
            out[sensor] = values
        else:
            out[sensor] = np.stack([np.asarray(v) for v in values], axis=0)
    return out


# -- wire format for the host->device sensor upload ---------------------------
# Two reductions of what crosses to the card each step, both lossless for
# the task:
#   * only keys the device step reads are uploaded
#     (policy.device_obs_keys | transform.device_obs_keys: MapCMA with GT
#     semantics never reads rgb, with predicted semantics never
#     semantic12);
#   * normalized [0,1] float32 depth travels as uint16 and is expanded on
#     the card (<= 7.7e-6 quantization = 0.08 mm at the 10 m depth range,
#     against the mapper's 0.05 m cells).

DEPTH_WIRE_SCALE = 65535.0

# wire keys the device step reads on the host (per-lane scalars, and the
# instruction tokens or RxR features, which the per-episode cache compares
# on the host and uploads only on a change); every other wire key is
# uploaded, rgb and semantic12 as uint8
HOST_OBS_KEYS = frozenset({"world_robot_pose", "world_robot_orientation",
                           "scene_center", "instruction", "rxr_instruction"})


def encode_wire_obs(dobs: Dict[str, Any], depth_uint16: bool = True) -> Dict:
    """Host side: shrink arrays before they are uploaded."""
    if not depth_uint16:
        return dobs
    d = dobs.get("depth")
    if d is not None and getattr(d, "dtype", None) == np.float32:
        dobs = dict(dobs)
        dobs["depth"] = (
            np.clip(d, 0.0, 1.0) * DEPTH_WIRE_SCALE + 0.5
        ).astype(np.uint16)
    return dobs


def decode_wire_obs(obs: Dict[str, Any]) -> Dict:
    """DEVICE side: expand wire dtypes back. Mirrors encode_wire_obs with
    a float32 multiply by 1/65535 (not a divide); a float32 depth passes
    through untouched."""
    import torch

    d = obs.get("depth")
    if d is not None and d.dtype == torch.uint16:
        obs = dict(obs)
        obs["depth"] = d.float() * (1.0 / DEPTH_WIRE_SCALE)
    return obs


def _declared_obs_keys(obj) -> Optional[Set[str]]:
    """``obj.device_obs_keys`` if its CLASS declares it, else None.

    The declaration check is on the class so that an exception raised
    *inside* the property propagates: a faulty property must not be
    mistaken for "declares nothing", which would silently turn off the
    upload filter and upload every frame."""
    if not hasattr(type(obj), "device_obs_keys"):
        return None
    keys = obj.device_obs_keys  # exceptions propagate
    return None if keys is None else set(keys)


def wire_obs_keys(policy, transform) -> Optional[Set[str]]:
    """Union of the obs keys the fused act executable reads, or None when
    either side doesn't declare its needs (None = upload everything, the
    reference's deliberate behavior, common/utils.py:95-135).
    Instruction keys always pass: the per-episode cache consumes and
    strips them (models/instruction_encoder.py::InstructionCache)."""
    pk = _declared_obs_keys(policy)
    if pk is None:
        return None
    keys = set(pk)
    if transform is not None:
        tk = _declared_obs_keys(transform)
        if tk is None:
            return None
        keys |= tk
    keys |= {"instruction", "rxr_instruction"}
    return keys
