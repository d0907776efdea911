"""The port's MapCMA policy against the JAX package's over several steps:
``act_iterative`` (and ``act``) logits and RNN states allclose at
float32 ``rtol=1e-5, atol=1e-5``, actions identical. Each side carries
its own RNN state from step to step; masks reset lanes on the way."""

import jax
import numpy as np
import pytest
import torch

from ivlnce_tpu.config import get_config as jax_config
from ivlnce_tpu.models import instruction_encoder as JIE
from ivlnce_tpu.models.policy import MapCMAPolicy as JaxPolicy
from ivlnce_tpu_torch.config import get_config as torch_config
from ivlnce_tpu_torch.models.convert import params_from_jax
from ivlnce_tpu_torch.models.policy import MapCMAPolicy as TorchPolicy
from tests.test_torch_train import one_torch_thread  # noqa: F401  (autouse)

CONFIG = "configs/fake/map_cma_eval_iterative.yaml"
HIDDEN = 64
DEPTH_HW = 64
MAP_HW = 64
TOL = dict(rtol=1e-5, atol=1e-5)
B = 3


@pytest.fixture(scope="module")
def pair():
    opts = ["MODEL.STATE_ENCODER.hidden_size", HIDDEN]
    info = {"depth_hw": DEPTH_HW, "map_hw": MAP_HW}
    jpol = JaxPolicy.from_config(jax_config(CONFIG, opts), info)
    params = jax.device_get(jpol.init_params(jax.random.PRNGKey(1)))
    tpol = TorchPolicy.from_config(torch_config(CONFIG, opts), info)
    tpol.load_state_dict(params_from_jax(params))
    return jpol, params, tpol.eval()


def _t(a):
    return torch.from_numpy(np.array(a))


def _observations(rng):
    tokens = rng.integers(1, 32, (B, 200)).astype(np.int32)
    tokens[:, 20:] = 0
    tokens[1, 9:] = 0
    return {
        "instruction": tokens,
        "depth": rng.uniform(0, 1, (B, DEPTH_HW, DEPTH_HW, 1)).astype(
            np.float32),
        "occupancy_map": rng.integers(0, 2, (B, MAP_HW, MAP_HW)).astype(
            np.uint8),
        "semantic_map": rng.integers(0, 13, (B, MAP_HW, MAP_HW)).astype(
            np.uint8),
    }


def _compare(jout, tout):
    np.testing.assert_allclose(tout.logits.numpy(), np.asarray(jout.logits),
                               **TOL)
    np.testing.assert_allclose(tout.rnn_states.numpy(),
                               np.asarray(jout.rnn_states), **TOL)
    np.testing.assert_array_equal(tout.actions.numpy(),
                                  np.asarray(jout.actions))


# per step: agent-episode, sim-episode, tour and action masks
MASKS = [
    ([0, 0, 0], [0, 0, 0], [0, 0, 0], [1, 1, 1]),
    ([1, 1, 1], [1, 1, 1], [1, 1, 1], [1, 1, 1]),
    ([1, 0, 1], [1, 0, 1], [1, 1, 1], [1, 1, 1]),
    ([1, 1, 1], [1, 1, 1], [1, 1, 1], [1, 0, 1]),
    ([0, 1, 1], [0, 1, 1], [0, 1, 1], [1, 1, 1]),
]


def test_act_iterative_matches_jax_over_steps(pair, rng):
    jpol, params, tpol = pair
    j_rnn = np.zeros((B, 2, HIDDEN), np.float32)
    t_rnn = torch.zeros(B, 2, HIDDEN)
    prev = np.zeros((B, 1), np.int64)
    for agent, sim, tour, action in MASKS:
        obs = _observations(rng)
        masks = [np.asarray(m, np.float32).reshape(B, 1)
                 for m in (agent, sim, tour, action)]
        jout = jpol.act_iterative(params, obs, j_rnn, prev, *masks)
        with torch.no_grad():
            tout = tpol.act_iterative(
                {k: _t(v) for k, v in obs.items()}, t_rnn, _t(prev),
                *(_t(m) for m in masks))
        _compare(jout, tout)
        j_rnn, t_rnn = np.asarray(jout.rnn_states), tout.rnn_states
        prev = np.asarray(jout.actions).astype(np.int64)


def test_act_matches_jax(pair, rng):
    jpol, params, tpol = pair
    obs = _observations(rng)
    rnn = rng.normal(0, 0.5, (B, 2, HIDDEN)).astype(np.float32)
    prev = rng.integers(0, 4, (B, 1))
    masks = np.array([[1.0], [0.0], [1.0]], np.float32)
    jout = jpol.act(params, obs, rnn, prev, masks)
    with torch.no_grad():
        tout = tpol.act({k: _t(v) for k, v in obs.items()}, _t(rnn),
                        _t(prev), _t(masks))
    _compare(jout, tout)


def test_cached_instruction_features_match_jax(pair, rng):
    """The trainers encode the instruction once per episode and feed the
    features to every step; the port's cache input equals the JAX one."""
    jpol, params, tpol = pair
    obs = _observations(rng)
    feats = JIE.apply_instruction_encoder(
        params["instruction_encoder"], jpol.model_config.INSTRUCTION_ENCODER,
        obs)
    cached = dict(obs, instruction_features=np.asarray(feats))
    del cached["instruction"]
    rnn = np.zeros((B, 2, HIDDEN), np.float32)
    prev = np.zeros((B, 1), np.int64)
    ones = np.ones((B, 1), np.float32)
    jout = jpol.act_iterative(params, cached, rnn, prev, ones, ones, ones,
                              ones)
    with torch.no_grad():
        tfeats = tpol.net.instruction_encoder(
            {"instruction": _t(obs["instruction"])})
        np.testing.assert_allclose(tfeats.numpy(), np.asarray(feats), **TOL)
        tcached = {k: _t(v) for k, v in cached.items()}
        tcached["instruction_features"] = tfeats
        tout = tpol.act_iterative(tcached, _t(rnn), _t(prev),
                                  *(_t(ones),) * 4)
    _compare(jout, tout)
