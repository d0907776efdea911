"""The port's LatentCMA against the JAX package's on the same seeded
numpy inputs and the same weights (``params_from_jax``), float32 at
``rtol=atol=1e-5``: the torchvision RGB trunks at 224^2 with random
BatchNorm statistics, the RxR instruction encoder, ``act_iterative`` over
steps with a tour boundary for the tour-memory variants, and ``act``.
Then the converter's coverage and the action sampler."""

import jax
import numpy as np
import pytest
import torch

from ivlnce_tpu.config import get_config as jax_config
from ivlnce_tpu.models import instruction_encoder as JIE
from ivlnce_tpu.models import resnet as JRN
from ivlnce_tpu.models.policy import LatentCMAPolicy as JaxPolicy
from ivlnce_tpu_torch.config import get_config as torch_config
from ivlnce_tpu_torch.models import instruction_encoder as TIE
from ivlnce_tpu_torch.models.convert import params_from_jax
from ivlnce_tpu_torch.models.policy import LatentCMAPolicy as TorchPolicy
from ivlnce_tpu_torch.models.policy import sample_actions
from ivlnce_tpu_torch.models.resnet import TorchVisionResNetSpatial
from tests.test_torch_train import one_torch_thread  # noqa: F401  (autouse)

CONFIG = "configs/fake/map_cma_eval_iterative.yaml"
HIDDEN = 64
DEPTH_HW = 64
RGB_HW = 224  # the trunk's 7x7 output pools to 4x4 in overlapping bins
TOL = dict(rtol=1e-5, atol=1e-5)
B = 3

VARIANTS = {
    "plain": {},
    "tour_memory": {"tour_memory": True},
    "pool": {"tour_memory_variant": True},
    "pool_end": {"tour_memory_variant": True, "memory_at_end": True},
    "pool_disabled": {"tour_memory_variant": True,
                      "disable_tour_memory": True},
    "ablate_rgb": {"ablate_rgb": True},
}
TRUNKS = ("TorchVisionResNet50", "TorchVisionResNet18")


def _opts(flags, cnn_type="TorchVisionResNet50"):
    opts = ["MODEL.policy_name", "LatentCMAPolicy",
            "MODEL.STATE_ENCODER.hidden_size", HIDDEN,
            "MODEL.RGB_ENCODER.cnn_type", cnn_type]
    for k, v in flags.items():
        opts += [f"MODEL.{k}", v]
    return opts


def randomize_norms(tree, rng):
    """BatchNorm leaves with statistics far from a fresh init's (mean 0,
    var 1, scale 1, bias 0), which would hide a wrong leaf mapping."""
    if not isinstance(tree, dict):
        return tree
    if set(tree) == {"scale", "bias", "mean", "var"}:
        c = tree["mean"].shape
        return {
            "scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
            "bias": rng.normal(0, 0.1, c).astype(np.float32),
            "mean": rng.normal(0, 0.2, c).astype(np.float32),
            "var": rng.uniform(0.5, 2.0, c).astype(np.float32),
        }
    return {k: randomize_norms(v, rng) for k, v in tree.items()}


def _pair(flags, cnn_type="TorchVisionResNet50", seed=1):
    """JAX policy and jitted act functions, its weights with random norm
    statistics, and the port's policy loaded from them."""
    opts = _opts(flags, cnn_type)
    info = {"depth_hw": DEPTH_HW}
    jpol = JaxPolicy.from_config(jax_config(CONFIG, opts), info)
    params = jax.device_get(jpol.init_params(jax.random.PRNGKey(seed)))
    params = randomize_norms(params, np.random.default_rng(seed))
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
        "rgb": rng.integers(0, 256, (B, RGB_HW, RGB_HW, 3)).astype(np.uint8),
    }


def _compare(jout, tout):
    np.testing.assert_allclose(tout.logits.numpy(), np.asarray(jout.logits),
                               **TOL)
    np.testing.assert_allclose(tout.rnn_states.numpy(),
                               np.asarray(jout.rnn_states), **TOL)
    np.testing.assert_array_equal(tout.actions.numpy(),
                                  np.asarray(jout.actions))


@pytest.mark.parametrize("cnn_type", TRUNKS)
def test_rgb_encoder_matches_jax_at_224(cnn_type):
    rng = np.random.default_rng(4)
    init, apply = {
        "TorchVisionResNet50": (JRN.init_torchvision_resnet50_spatial,
                                JRN.apply_torchvision_resnet50_spatial),
        "TorchVisionResNet18": (JRN.init_torchvision_resnet18_spatial,
                                JRN.apply_torchvision_resnet18_spatial),
    }[cnn_type]
    params, shape = init(jax.random.PRNGKey(2))
    params = randomize_norms(jax.device_get(params), rng)
    rgb = rng.integers(0, 256, (1, RGB_HW, RGB_HW, 3)).astype(np.uint8)
    want = np.asarray(jax.jit(apply)(params, rgb))
    enc = TorchVisionResNetSpatial(cnn_type)
    state = {k[len("net.rgb_encoder."):]: v
             for k, v in params_from_jax({"rgb_encoder": params}).items()}
    enc.load_state_dict(state)
    enc.train()  # the trunk keeps its running statistics regardless
    with torch.no_grad():
        got = enc(_t(rgb)).numpy()
    assert got.shape == want.shape == (1,) + tuple(shape)
    assert enc.output_shape == tuple(shape)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, **TOL)


def test_rxr_instruction_encoder_matches_jax():
    """Ragged feature lengths, an all-zero row and a zero row inside a
    sequence (lengths count the non-zero rows, as the JAX package's)."""
    rng = np.random.default_rng(5)
    cfg = _opts({}) + ["MODEL.INSTRUCTION_ENCODER.sensor_uuid",
                       "rxr_instruction",
                       "MODEL.INSTRUCTION_ENCODER.embedding_size", 768,
                       "MODEL.INSTRUCTION_ENCODER.final_state_only", False]
    jcfg = jax_config(CONFIG, cfg).MODEL.INSTRUCTION_ENCODER
    tcfg = torch_config(CONFIG, cfg).MODEL.INSTRUCTION_ENCODER
    feats = rng.normal(0, 1, (4, 48, 768)).astype(np.float32)
    for row, n in enumerate((48, 17, 0, 30)):
        feats[row, n:] = 0
    feats[3, 5] = 0  # inside the sequence: the length counts 29 rows
    params = jax.device_get(
        JIE.init_instruction_encoder(jax.random.PRNGKey(6), jcfg))
    assert "embedding" not in params
    want = np.asarray(JIE.apply_instruction_encoder(
        params, jcfg, {"rxr_instruction": feats}))
    enc = TIE.InstructionEncoder(tcfg)
    state = {k[len("net.instruction_encoder."):]: v for k, v in
             params_from_jax({"instruction_encoder": params}).items()}
    enc.load_state_dict(state)
    assert enc.embedding_layer is None
    with torch.no_grad():
        got = enc({"rxr_instruction": _t(feats)}).numpy()
    assert got.shape == (4, 2 * tcfg.hidden_size, 48)
    assert (got[2] == 0).all() and (got[1, :, 17:] == 0).all()
    np.testing.assert_allclose(got, want, **TOL)


# per step: agent-episode, sim-episode, tour and action masks; the tour
# ends after step 2 for lanes 0 and 2 (an agent episode for lane 1)
MASKS = [
    ([0, 0, 0], [0, 0, 0], [0, 0, 0], [1, 1, 1]),
    ([1, 1, 1], [1, 1, 1], [1, 1, 1], [1, 1, 1]),
    ([0, 0, 0], [0, 0, 0], [0, 1, 0], [1, 1, 1]),
    ([1, 1, 1], [1, 1, 1], [1, 1, 1], [1, 0, 1]),
    ([0, 1, 1], [0, 1, 1], [1, 1, 1], [1, 1, 1]),
]


@pytest.mark.parametrize("variant", VARIANTS)
def test_act_iterative_matches_jax_over_steps(variant):
    rng = np.random.default_rng(7)
    jpol, params, tpol = _pair(VARIANTS[variant])
    layers = 3 if VARIANTS[variant].get("tour_memory_variant") else 2
    assert tpol.num_recurrent_layers == jpol.num_recurrent_layers == layers
    act = jax.jit(jpol.act_iterative)
    j_rnn = np.zeros((B, layers, HIDDEN), np.float32)
    t_rnn = torch.zeros(B, layers, HIDDEN)
    prev = np.zeros((B, 1), np.int64)
    for agent, sim, tour, action in MASKS:
        obs = _observations(rng)
        masks = [np.asarray(m, np.float32).reshape(B, 1)
                 for m in (agent, sim, tour, action)]
        jout = act(params, obs, j_rnn, prev, *masks)
        with torch.no_grad():
            tout = tpol.act_iterative(
                {k: _t(v) for k, v in obs.items()}, t_rnn, _t(prev),
                *(_t(m) for m in masks))
        _compare(jout, tout)
        j_rnn, t_rnn = np.asarray(jout.rnn_states), tout.rnn_states
        prev = np.asarray(jout.actions).astype(np.int64)
    if layers == 3:
        assert np.abs(j_rnn[:, 2]).max() > 0  # the memory slot is live


def test_act_matches_jax_with_episodic_masks():
    rng = np.random.default_rng(8)
    jpol, params, tpol = _pair(VARIANTS["pool_end"])
    obs = _observations(rng)
    rnn = rng.normal(0, 0.5, (B, 3, HIDDEN)).astype(np.float32)
    prev = rng.integers(0, 4, (B, 1))
    masks = np.array([[1.0], [0.0], [1.0]], np.float32)
    jout = jax.jit(jpol.act)(params, obs, rnn, prev, masks)
    with torch.no_grad():
        tout = tpol.act({k: _t(v) for k, v in obs.items()}, _t(rnn),
                        _t(prev), _t(masks))
    _compare(jout, tout)


@pytest.mark.parametrize("cnn_type", TRUNKS)
@pytest.mark.parametrize("variant", ("plain", "tour_memory", "pool",
                                     "pool_end"))
def test_params_from_jax_fills_every_parameter(variant, cnn_type):
    opts = _opts(VARIANTS[variant], cnn_type)
    jpol = JaxPolicy.from_config(jax_config(CONFIG, opts),
                                 {"depth_hw": DEPTH_HW})
    params = jax.device_get(jpol.init_params(jax.random.PRNGKey(0)))
    state = params_from_jax(params)
    tpol = TorchPolicy.from_config(torch_config(CONFIG, opts),
                                   {"depth_hw": DEPTH_HW})
    want = tpol.state_dict()
    assert set(state) == set(want)  # every parameter and buffer, no more
    for k, v in want.items():
        assert state[k].shape == v.shape, k
    assert ("net.out_layer.0.weight" in state) == (variant == "pool_end")


@pytest.fixture(scope="module")
def small_policy():
    opts = _opts({}, "TorchVisionResNet18")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        policy = TorchPolicy.from_config(torch_config(CONFIG, opts),
                                         {"depth_hw": DEPTH_HW})
    return policy.eval()


def _sampled_actions(policy, seed, steps=6):
    rng = np.random.default_rng(9)
    gen = torch.Generator().manual_seed(seed)
    obs = _observations(rng)
    obs["rgb"] = obs["rgb"][:, :64, :64]
    obs = {k: _t(v) for k, v in obs.items()}
    rnn = policy.initial_rnn_states(B, "cpu")
    prev = torch.zeros(B, 1, dtype=torch.int64)
    ones = torch.ones(B, 1)
    out = []
    with torch.no_grad():
        for _ in range(steps):
            step = policy.act_iterative(obs, rnn, prev, ones, ones, ones,
                                        ones, generator=gen)
            rnn, prev = step.rnn_states, step.actions
            out.append(step.actions.ravel().tolist())
    return out


def test_sampler_repeats_with_its_seed(small_policy):
    assert (_sampled_actions(small_policy, 11)
            == _sampled_actions(small_policy, 11))


def test_sampler_differs_across_seeds(small_policy):
    draws = {str(_sampled_actions(small_policy, s)) for s in range(4)}
    assert len(draws) > 1


def test_sampler_picks_a_dominant_logit():
    gen = torch.Generator().manual_seed(0)
    logits = torch.zeros(1000, 4)
    logits[:, 2] = 50.0
    logits[::2, 1] = 3.0
    assert (sample_actions(logits, gen) == 2).all()
