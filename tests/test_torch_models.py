"""The port's MapCMA building blocks (ivlnce_tpu_torch/models) against the
JAX package's, on weights carried over by ``params_from_jax``.

Tolerance: float32, ``rtol=1e-5, atol=1e-5`` unless a test states a
looser bound and its reason. Inputs are made with numpy from a seed."""

import math

import jax
import numpy as np
import pytest
import torch

from ivlnce_tpu.config import get_config as jax_config
from ivlnce_tpu.models import cma as JC
from ivlnce_tpu.models import instruction_encoder as JIE
from ivlnce_tpu.models import map_encoder as JME
from ivlnce_tpu.models import resnet as JRN
from ivlnce_tpu.models import rnn as JR
from ivlnce_tpu.models.policy import MapCMAPolicy as JaxPolicy
from ivlnce_tpu_torch.config import get_config as torch_config
from ivlnce_tpu_torch.models import nn as TNN
from ivlnce_tpu_torch.models import rnn as TR
from ivlnce_tpu_torch.models.convert import params_from_jax
from ivlnce_tpu_torch.models.policy import MapCMAPolicy as TorchPolicy
from tests.test_torch_train import one_torch_thread  # noqa: F401  (autouse)

CONFIG = "configs/fake/map_cma_eval_iterative.yaml"
HIDDEN = 64
DEPTH_HW = 64
MAP_HW = 64
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def pair():
    """(JAX policy, its params, port policy with the same weights)."""
    opts = ["MODEL.STATE_ENCODER.hidden_size", HIDDEN]
    info = {"depth_hw": DEPTH_HW, "map_hw": MAP_HW}
    jpol = JaxPolicy.from_config(jax_config(CONFIG, opts), info)
    params = jax.device_get(jpol.init_params(jax.random.PRNGKey(0)))
    tpol = TorchPolicy.from_config(torch_config(CONFIG, opts), info)
    tpol.load_state_dict(params_from_jax(params))
    return jpol, params, tpol.eval()


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(ours, ref, **tol):
    np.testing.assert_allclose(
        ours.detach().numpy(), np.asarray(ref), **(tol or TOL))


def test_params_from_jax_fills_every_parameter(pair):
    _, params, tpol = pair
    state = params_from_jax(params)
    assert set(state) == set(tpol.state_dict())
    for name, value in tpol.state_dict().items():
        assert tuple(state[name].shape) == tuple(value.shape), name


def test_depth_encoder_matches_jax(pair, rng):
    """The GroupNorm ResNet-50 with its spatial embedding."""
    _, params, tpol = pair
    depth = rng.uniform(0, 1, (2, DEPTH_HW, DEPTH_HW, 1)).astype(np.float32)
    ref = JRN.apply_vln_depth_encoder(params["depth_encoder"], depth)
    with torch.no_grad():
        ours = tpol.net.depth_encoder(_t(depth))
    assert ours.shape == tuple(ref.shape)
    _close(ours, ref)


def test_map_encoder_matches_jax(pair, rng):
    _, params, tpol = pair
    occ = rng.integers(0, 2, (3, MAP_HW, MAP_HW)).astype(np.uint8)
    sem = rng.integers(0, 13, (3, MAP_HW, MAP_HW)).astype(np.uint8)
    ref = JME.apply_map_encoder(params["map_encoder"], occ, sem, 13)
    with torch.no_grad():
        ours = tpol.net.map_encoder(_t(occ), _t(sem))
    assert ours.shape == tuple(ref.shape)
    _close(ours, ref)


def test_instruction_encoder_matches_jax(pair, rng):
    """bi-LSTM over padded tokens, an empty row included."""
    jpol, params, tpol = pair
    tokens = rng.integers(1, 32, (4, 200)).astype(np.int64)
    for row, length in enumerate((20, 9, 1, 0)):
        tokens[row, length:] = 0
    ref = JIE.apply_instruction_encoder(
        params["instruction_encoder"], jpol.model_config.INSTRUCTION_ENCODER,
        {"instruction": tokens.astype(np.int32)})
    with torch.no_grad():
        ours = tpol.net.instruction_encoder({"instruction": _t(tokens)})
    assert ours.shape == tuple(ref.shape)
    _close(ours, ref)
    assert (ours[3] == 0).all() and (ours[1, :, 9:] == 0).all()


def test_bi_lstm_final_state_matches_jax(rng):
    lstm = torch.nn.LSTM(8, 6, bidirectional=True, batch_first=True)
    xs = rng.normal(size=(3, 7, 8)).astype(np.float32)
    lengths = np.array([7, 3, 0], np.int32)
    sd = {k: v.numpy() for k, v in lstm.state_dict().items()}

    def cell(sfx):
        return {"w_ih": sd[f"weight_ih_l0{sfx}"],
                "w_hh": sd[f"weight_hh_l0{sfx}"],
                "b_ih": sd[f"bias_ih_l0{sfx}"],
                "b_hh": sd[f"bias_hh_l0{sfx}"]}

    ref_out, ref_final = JR.bi_lstm_padded(cell(""), cell("_reverse"), xs,
                                           lengths)
    with torch.no_grad():
        out, final = TR.bi_lstm_padded(lstm, _t(xs), _t(lengths).long())
    _close(out, ref_out)
    _close(final, ref_final)


@pytest.mark.parametrize("masks", [[1.0, 1.0, 1.0], [1.0, 0.0, 1.0],
                                   [0.0, 0.0, 0.0]])
def test_masked_gru_step_matches_jax(pair, rng, masks):
    _, params, tpol = pair
    enc = tpol.net.state_encoder
    x = rng.normal(size=(3, enc.rnn.input_size)).astype(np.float32)
    h = rng.normal(size=(3, HIDDEN)).astype(np.float32)
    m = np.asarray(masks, np.float32)
    ref = JR.masked_gru_step(params["state_encoder"], x, h, m)
    with torch.no_grad():
        ours = enc(_t(x), _t(h), _t(m))
    _close(ours, ref)
    if m.sum() == 3:
        _close(ours, JR.gru_cell(params["state_encoder"], x, h))


def test_attention_matches_jax(rng):
    q = rng.normal(size=(3, 16)).astype(np.float32)
    k = rng.normal(size=(3, 16, 11)).astype(np.float32)
    v = rng.normal(size=(3, 24, 11)).astype(np.float32)
    mask = np.zeros((3, 11), bool)
    mask[1, 4:] = True
    scale = 1.0 / math.sqrt(16)
    for m in (None, mask):
        ref = JC._attn(q, k, v, scale, m)
        ours = TNN.attend(_t(q), _t(k), _t(v), scale,
                          None if m is None else _t(m))
        _close(ours, ref)


def test_one_hot_matches_jax():
    labels = np.array([[0, 3, 12, 13, 200]], np.uint8)
    ref = jax.nn.one_hot(labels.astype(np.int32), 13)
    _close(TNN.one_hot(_t(labels), 13), ref)
