"""The port's ``TPU.compute_dtype bfloat16`` against the JAX package's, on
the same inputs (numpy, from a seed) and the same weights
(``params_from_jax``; the JAX parameters go through ``jax.device_put``,
as the JAX trainer keeps them: with host numpy parameters JAX's bfloat16
map encoder promotes its BatchNorm to float32 and its convolution
refuses the mixed dtypes).

The two packages round bfloat16 in different places (XLA takes the
norms' statistics and applies them in bfloat16; torch computes a norm in
float32 and rounds its output), so they do not agree bit for bit. Each
case is held against the JAX package's own bfloat16 error. With e_J,
e_P and e_X the largest |difference| over the largest |JAX float32
output| of JAX bfloat16 against JAX float32, the port's bfloat16 against
JAX float32, and the port's bfloat16 against JAX bfloat16, every case
requires

    e_P <= 1.5 e_J,    e_X <= 2 e_J,    e_P >= 0.1 e_J;

the last bound fails a port that computed the part in float32. Measured
on a CPU (e_J, e_P, e_X): the depth encoder (hidden 64, 64^2,
B=2) 0.0484, 0.0448, 0.0552; the map encoder (64^2 maps) 0.0069,
0.0062, 0.0079; the RGB trunks at 224^2 (B=2) ResNet-50 0.0039, 0.0035,
0.0047 and ResNet-18 0.0028, 0.0019, 0.0030; RedNet at reduced layer
counts (64^2, B=2) 0.0119, 0.0092, 0.0090; one policy step (B=3), logits
and RNN states, MapCMA 0.0033, 0.0040, 0.0058 and 0.0258, 0.0115,
0.0187, LatentCMA 0.0031, 0.0030, 0.0034 and 0.0146, 0.0105, 0.0143.
From the JAX package's own initial weights (``init_params``, seed 0)
the depth encoder gave 0.0352, 0.0232, 0.0347 and the map encoder
0.0054, 0.0039, 0.0074; there, over seeds 1-3, a step's e_P / e_J ranged
0.33-1.37 and e_X / e_J 0.67-1.72: the maxima of a few values are
noisy. Random-weight logits
sit near ties and the two packages round differently, so actions are
not compared; RedNet's labels are, wherever JAX float32's top-2 margin
exceeds 4 e_J of the largest |score|.

What bfloat16 leaves in float32 is held exactly: the trainers' frozen
encoder features (``_encode_feats``, float32 in the JAX package's
collection too), the state_dict, and a DAgger train step (its map
encoder trains in float32 and reads stored features)."""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivlnce_tpu.config import get_config as jax_config
from ivlnce_tpu.models import map_encoder as JME
from ivlnce_tpu.models import nn as JNN
from ivlnce_tpu.models import rednet as RD
from ivlnce_tpu.models import resnet as JRN
from ivlnce_tpu.models.policy import LatentCMAPolicy as JaxLatent
from ivlnce_tpu.models.policy import MapCMAPolicy as JaxMap
from ivlnce_tpu_torch.config import get_config as torch_config
from ivlnce_tpu_torch.models.checkpoint_io import jax_params_from_state_dict
from ivlnce_tpu_torch.models import rednet as TR
from ivlnce_tpu_torch.models.convert import (
    params_from_jax,
    rednet_params_from_jax,
)
from ivlnce_tpu_torch.models.policy import LatentCMAPolicy as TorchLatent
from ivlnce_tpu_torch.models.policy import MapCMAPolicy as TorchMap
from ivlnce_tpu_torch.models.resnet import TorchVisionResNetSpatial
from tests.test_torch_latent import randomize_norms
from tests.test_torch_rednet import _randomize_norms, _reduce

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = "configs/fake/map_cma_eval_iterative.yaml"
HIDDEN = 64
HW = 64
RGB_HW = 224
B = 3
BF16 = ["TPU.compute_dtype", "bfloat16"]
BF = torch.bfloat16
FAMILIES = {
    "MapCMA": (JaxMap, TorchMap, []),
    "LatentCMA": (JaxLatent, TorchLatent,
                  ["MODEL.policy_name", "LatentCMAPolicy",
                   "MODEL.tour_memory_variant", True]),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Other test processes share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a))


def _errors(jax32, jax16, port16) -> dict:
    """e_J, e_P and e_X (module docstring)."""
    j32, j16, p16 = (np.asarray(x, np.float64) for x in (
        jax32, np.asarray(jax16, np.float32), port16.float().numpy()))
    scale = np.abs(j32).max()
    return {"e_J": np.abs(j16 - j32).max() / scale,
            "e_P": np.abs(p16 - j32).max() / scale,
            "e_X": np.abs(p16 - j16).max() / scale}


def _assert_bf16_rule(jax32, jax16, port16, what=""):
    e = _errors(jax32, jax16, port16)
    assert e["e_J"] > 0, (what, e)
    assert 0.1 * e["e_J"] <= e["e_P"] <= 1.5 * e["e_J"], (what, e)
    assert e["e_X"] <= 2 * e["e_J"], (what, e)
    return e


def _pair(family, seed=1):
    """(JAX float32 policy, JAX bfloat16 policy, the JAX parameters on the
    device, the port's bfloat16 and float32 policies with those weights).
    The weights are the port's seeded ones as the JAX package's tree (the
    JAX package's eager ``init_params`` took 16 s on a CPU), with random
    BatchNorm statistics."""
    jcls, tcls, extra = FAMILIES[family]
    opts = ["MODEL.STATE_ENCODER.hidden_size", HIDDEN] + extra
    info = {"depth_hw": HW, "map_hw": HW}
    j32 = jcls.from_config(jax_config(CONFIG, opts), info)
    j16 = jcls.from_config(jax_config(CONFIG, opts + BF16), info)
    ports = []
    for o in (opts + BF16, opts):
        torch.manual_seed(seed)
        ports.append(tcls.from_config(torch_config(CONFIG, o), info).eval())
    params = jax.tree_util.tree_map(
        np.array, jax_params_from_state_dict(ports[1].state_dict()))
    params = randomize_norms(params, np.random.default_rng(seed))
    for policy in ports:
        policy.load_state_dict(params_from_jax(params))
    return j32, j16, jax.device_put(params), ports[0], ports[1]


@pytest.fixture(scope="module")
def map_pair():
    return _pair("MapCMA")


@pytest.fixture(scope="module")
def latent_pair():
    return _pair("LatentCMA")


def _observations(family, rng, b=B):
    tokens = rng.integers(1, 32, (b, 200)).astype(np.int32)
    tokens[:, 20:] = 0
    obs = {"instruction": tokens,
           "depth": rng.uniform(0, 1, (b, HW, HW, 1)).astype(np.float32)}
    if family == "MapCMA":
        obs["occupancy_map"] = rng.integers(0, 2, (b, HW, HW)).astype(
            np.uint8)
        obs["semantic_map"] = rng.integers(0, 13, (b, HW, HW)).astype(
            np.uint8)
    else:
        obs["rgb"] = rng.integers(0, 256, (b, RGB_HW, RGB_HW, 3)).astype(
            np.uint8)
    return obs


# -- the encoders ----------------------------------------------------------------
def test_depth_encoder_bf16_matches_jax(map_pair):
    """The depth cast ahead of the pool; the spatial embedding rounded."""
    _, _, params, port, _ = map_pair
    depth = np.random.default_rng(0).uniform(0, 1, (2, HW, HW, 1)).astype(
        np.float32)
    p = params["depth_encoder"]
    want = jax.jit(JRN.apply_vln_depth_encoder)(p, depth)
    jax16 = jax.jit(lambda p, d: JRN.apply_vln_depth_encoder(
        p, d, dtype=jnp.bfloat16))(p, depth)
    with torch.no_grad():
        got = port.net.depth_encoder(_t(depth), BF)
    assert got.dtype == torch.float32 and got.shape == want.shape
    _assert_bf16_rule(want, jax16, got, "depth encoder")
    # the spatial embedding channels: the float32 weights rounded to bf16
    emb = port.net.depth_encoder.spatial_embeddings.weight
    np.testing.assert_array_equal(
        got[0, -emb.shape[1]:].reshape(emb.shape[1], -1).t().numpy(),
        emb.detach().to(BF).float().numpy())


def test_map_encoder_bf16_matches_jax(map_pair):
    """Eval in bfloat16; a training forward stays float32, bit for bit."""
    _, _, params, port, _ = map_pair
    rng = np.random.default_rng(1)
    occ = rng.integers(0, 2, (3, HW, HW)).astype(np.uint8)
    sem = rng.integers(0, 13, (3, HW, HW)).astype(np.uint8)
    p = params["map_encoder"]
    want = JME.apply_map_encoder(p, occ, sem, 13)
    jax16 = jax.jit(lambda p, o, s: JME.apply_map_encoder(
        p, o, s, 13, dtype=jnp.bfloat16))(p, occ, sem)
    enc = port.net.map_encoder
    with torch.no_grad():
        got = enc(_t(occ), _t(sem), dtype=BF)
        train16 = enc(_t(occ), _t(sem), training=True, dtype=BF)
        train32 = enc(_t(occ), _t(sem), training=True)
    _assert_bf16_rule(want, jax16, got, "map encoder")
    assert train16.dtype == torch.float32
    assert torch.equal(train16, train32)


@pytest.mark.parametrize("cnn_type", ["TorchVisionResNet50",
                                      "TorchVisionResNet18"])
def test_rgb_trunk_bf16_matches_jax(cnn_type):
    """The frozen BatchNorm trunk in bfloat16 on rgb / 255, float32
    before the 4x4 pool; the spatial embedding stays float32."""
    init, apply = {
        "TorchVisionResNet50": (JRN.init_torchvision_resnet50_spatial,
                                JRN.apply_torchvision_resnet50_spatial),
        "TorchVisionResNet18": (JRN.init_torchvision_resnet18_spatial,
                                JRN.apply_torchvision_resnet18_spatial),
    }[cnn_type]
    rng = np.random.default_rng(4)
    params, _ = init(jax.random.PRNGKey(2))
    params = randomize_norms(jax.device_get(params), rng)
    rgb = rng.integers(0, 256, (2, RGB_HW, RGB_HW, 3)).astype(np.uint8)
    on_device = jax.device_put(params)
    want = jax.jit(apply)(on_device, rgb)
    jax16 = jax.jit(lambda p, r: apply(p, r, dtype=jnp.bfloat16))(
        on_device, rgb)
    enc = TorchVisionResNetSpatial(cnn_type).eval()
    enc.load_state_dict({k[len("net.rgb_encoder."):]: v for k, v in
                         params_from_jax({"rgb_encoder": params}).items()})
    with torch.no_grad():
        got = enc(_t(rgb), BF)
    _assert_bf16_rule(want, jax16, got, cnn_type)
    emb = enc.spatial_embeddings.weight.shape[1]
    np.testing.assert_array_equal(got[:, -emb:].numpy(),
                                  np.asarray(want)[:, -emb:])


def _jax_scores(params, rgb_uint8, depth, dtype):
    """The JAX package's ``predict_semantics`` (rednet.py:236-260) up to
    the scores."""
    compute = dtype or jnp.float32
    if dtype is not None:
        params = JNN.cast_tree(params, dtype)
    rgb = RD.bilinear_resize(rgb_uint8.astype(compute) / 255.0,
                             depth.shape[1:3])
    rgb = (rgb - RD.RGB_MEAN.astype(compute)) / RD.RGB_STD.astype(compute)
    d = (depth[..., None].astype(compute) - RD.DEPTH_MEAN) / RD.DEPTH_STD
    return RD.apply_rednet(params, rgb, d.astype(compute))


def test_rednet_bf16_matches_jax():
    """RedNet at reduced layer counts (as ``test_torch_rednet.py`` builds
    it): its scores by the rule, its labels where JAX float32 is sure."""
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        np.asarray, jax.device_get(RD.init_rednet(jax.random.PRNGKey(0))))
    _randomize_norms(params, rng)
    layers, trans = (1, 1, 1, 1), (1, 2, 1, 1)
    params = _reduce(params, layers, trans)
    model = TR.RedNet(layers=layers, trans_layers=trans).eval()
    model.load_state_dict(rednet_params_from_jax(params))
    rng = np.random.default_rng(2)
    rgb = rng.integers(0, 256, (2, 96, 96, 3)).astype(np.uint8)
    depth = rng.uniform(0, 1, (2, HW, HW)).astype(np.float32)
    on_device = jax.device_put(params)
    want = np.asarray(jax.jit(lambda p, r, d: _jax_scores(p, r, d, None))(
        on_device, rgb, depth))
    jax16 = jax.jit(lambda p, r, d: _jax_scores(p, r, d, jnp.bfloat16))(
        on_device, rgb, depth)
    jax_labels = np.asarray(jax.jit(lambda p, r, d: RD.predict_semantics(
        p, r, d, dtype=jnp.bfloat16))(on_device, rgb, depth))
    np.testing.assert_array_equal(jax_labels,
                                  np.argmax(np.asarray(jax16, np.float32), -1))
    from ivlnce_tpu_torch.models.nn import apply_cast

    with torch.no_grad():
        inputs = TR.normalize_inputs(_t(rgb), _t(depth), BF)
        assert all(x.dtype == BF for x in inputs)
        scores = apply_cast(model, BF, *inputs)
        labels = TR.predict_semantics(model, _t(rgb), _t(depth), BF)
    assert scores.dtype == BF
    e = _assert_bf16_rule(want, jax16, scores, "RedNet")
    np.testing.assert_array_equal(labels.numpy(),
                                  torch.argmax(scores, -1).numpy())
    top = np.sort(want, -1)[..., -2:]
    sure = top[..., 1] - top[..., 0] > 4 * e["e_J"] * np.abs(want).max()
    assert sure.mean() > 0.5
    np.testing.assert_array_equal(labels.numpy()[sure],
                                  np.argmax(want, -1)[sure])


# -- one policy step ----------------------------------------------------------------
@pytest.mark.parametrize("family", FAMILIES)
def test_policy_step_bf16_matches_jax(family, map_pair, latent_pair):
    j32, j16, params, port, _ = (map_pair if family == "MapCMA"
                                 else latent_pair)
    rng = np.random.default_rng(1)
    obs = _observations(family, rng)
    layers = j32.num_recurrent_layers
    rnn = rng.normal(0, 0.5, (B, layers, HIDDEN)).astype(np.float32)
    prev = rng.integers(0, 4, (B, 1))
    masks = [np.ones((B, 1), np.float32)] * 4
    want = jax.jit(j32.act_iterative)(params, obs, rnn, prev, *masks)
    jax16 = jax.jit(j16.act_iterative)(params, obs, rnn, prev, *masks)
    with torch.no_grad():
        got = port.act_iterative({k: _t(v) for k, v in obs.items()}, _t(rnn),
                                 _t(prev), *(_t(m) for m in masks))
    _assert_bf16_rule(want.logits, jax16.logits, got.logits, "logits")
    _assert_bf16_rule(want.rnn_states, jax16.rnn_states, got.rnn_states,
                      "rnn states")
    assert got.rnn_states.dtype == torch.float32


# -- what stays float32 ------------------------------------------------------------
@pytest.mark.parametrize("family", FAMILIES)
def test_encode_feats_stay_float32(family, map_pair, latent_pair):
    """DAgger collection stores the frozen encoders' float32 features under
    bfloat16, as the JAX package's ``encode_feats`` does (no dtype): bit
    for bit the float32 policy's."""
    from ivlnce_tpu_torch.trainers.dagger_trainer import DaggerTrainer

    *_, port16, port32 = map_pair if family == "MapCMA" else latent_pair
    obs = {k: _t(v) for k, v in
           _observations(family, np.random.default_rng(5), 2).items()}
    feats = {}
    for name, policy in (("bf16", port16), ("f32", port32)):
        config = torch_config(CONFIG, FAMILIES[family][2])
        trainer = types.SimpleNamespace(config=config, policy=policy)
        with torch.no_grad():
            feats[name] = DaggerTrainer._encode_feats(trainer, obs)
    keys = {"depth_features"} | ({"rgb_features"} if family == "LatentCMA"
                                 else set())
    assert set(feats["bf16"]) == set(feats["f32"]) == keys
    for k in keys:
        assert feats["bf16"][k].dtype == torch.float32
        assert torch.equal(feats["bf16"][k], feats["f32"][k]), k


@pytest.mark.parametrize("inference", [False, True])
@pytest.mark.parametrize("family", FAMILIES)
def test_state_dict_is_float32_and_follows_loads(family, inference):
    """A bfloat16 policy's state_dict equals the float32 one's in keys,
    dtypes and values, before and after a bfloat16 step; after a
    ``load_state_dict`` or an in-place update of the weights its next
    step uses the new weights (the cast copy is made anew). Also for
    policies built and loaded under ``torch.inference_mode``, as the
    evals build theirs (inference tensors keep no version counter)."""
    _, tcls, extra = FAMILIES[family]
    opts = ["MODEL.STATE_ENCODER.hidden_size", HIDDEN] + extra
    info = {"depth_hw": HW, "map_hw": HW}
    policies = {}
    for name, o in (("bf16", opts + BF16), ("f32", opts),
                    ("other", opts + BF16)):
        torch.manual_seed(1 if name != "other" else 2)
        with torch.inference_mode(inference):
            policies[name] = tcls.from_config(torch_config(CONFIG, o),
                                              info).eval()
    rng = np.random.default_rng(6)
    obs = {k: _t(v) for k, v in _observations(family, rng, 2).items()}
    rnn = policies["f32"].initial_rnn_states(2, "cpu")
    prev = torch.zeros(2, 1, dtype=torch.int64)
    m = torch.ones(2, 1)

    def step(policy):
        with torch.inference_mode():
            return policy.act_iterative(obs, rnn, prev, m, m, m, m).logits

    def assert_same_state(a, b):
        sa, sb = a.state_dict(), b.state_dict()
        assert list(sa) == list(sb)
        for k in sa:
            assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]), k

    assert_same_state(policies["bf16"], policies["f32"])
    before = step(policies["bf16"])
    assert_same_state(policies["bf16"], policies["f32"])
    assert not torch.equal(before, step(policies["f32"]))
    with torch.inference_mode(inference):
        policies["bf16"].load_state_dict(policies["other"].state_dict())
    assert torch.equal(step(policies["bf16"]), step(policies["other"]))
    if inference:
        with torch.inference_mode():
            policies["bf16"].load_state_dict(policies["f32"].state_dict())
    else:  # in place, as an optimizer step: the version counters move
        with torch.no_grad():
            for p, q in zip(policies["bf16"].parameters(),
                            policies["f32"].parameters()):
                p.copy_(q)
    assert torch.equal(step(policies["bf16"]), before)


def test_train_step_under_bf16_equals_float32(tmp_path):
    """A MapCMA DAgger train step (trainable map encoder, stored depth
    features, progress monitor) under bfloat16: the loss terms and every
    gradient equal the float32 step's, the map encoder's gradients are
    float32, and after an Adam step the optimizer state and the saved
    checkpoint hold float32 tensors equal to the float32 run's."""
    from tests.test_torch_train import _opts, _torch_loss, _train_batch
    from ivlnce_tpu_torch.models.il_update import make_optimizer
    from ivlnce_tpu_torch.trainers.base_trainer import (
        load_checkpoint,
        save_checkpoint,
    )

    config_path = "configs/fake/map_cma_train_tf.yaml"
    runs = {}
    for name, extra in (("bf16", BF16), ("f32", [])):
        config = torch_config(config_path, _opts() + extra)
        torch.manual_seed(1)
        policy = TorchMap.from_config(config, {"depth_hw": HW,
                                               "map_hw": HW}).eval()
        assert policy.net.compute_dtype == (BF if extra else None)
        batch = _train_batch(policy)
        tour = np.ones_like(batch[3], np.float32)
        terms = _torch_loss(policy, batch, tour)
        terms[0].backward()
        optimizer = make_optimizer(policy, config)
        grads = {k: p.grad.clone() for k, p in policy.named_parameters()
                 if p.grad is not None}
        optimizer.step()
        path = str(tmp_path / f"{name}.pth")
        save_checkpoint(policy, config, path,
                        optim_state=optimizer.state_dict())
        runs[name] = ([float(x.detach()) for x in terms[:3]], grads,
                      load_checkpoint(path))
    (loss16, grads16, ckpt16), (loss32, grads32, ckpt32) = (
        runs["bf16"], runs["f32"])
    assert loss16 == loss32
    assert list(grads16) == list(grads32)
    assert any(k.startswith("net.map_encoder.") for k in grads16)
    for k in grads32:
        assert grads16[k].dtype == torch.float32
        assert torch.equal(grads16[k], grads32[k]), k
    for k, v in ckpt32["state_dict"].items():
        assert ckpt16["state_dict"][k].dtype == v.dtype
        assert torch.equal(ckpt16["state_dict"][k], v), k
    state16 = ckpt16["optim_state"]["state"]
    for i, s in ckpt32["optim_state"]["state"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            assert state16[i][k].dtype == torch.float32
            assert torch.equal(state16[i][k], s[k]), (i, k)


# -- the eval end to end ------------------------------------------------------------
def test_bf16_iterative_eval_through_run_exp(tmp_path, monkeypatch):
    """``run_exp(..., "eval", device="cpu")`` of the MapCMA iterative
    config under bfloat16 and under float32 (2 lanes, 64^2 sensors,
    4-step episodes, ``test_torch_eval.py``'s two tours of two episodes):
    both finish; K1 and K2 (their plain versions here) run once per
    policy step in each; the stats JSONs have the same keys and episode
    count."""
    import json

    from ivlnce_tpu_torch.ops import scatter as S
    from ivlnce_tpu_torch.run import run_exp
    from ivlnce_tpu_torch.trainers.base_trainer import save_checkpoint
    from tests.test_torch_eval import _tiny_dataset

    os.chdir(REPO)
    ds = str(tmp_path / "ds")
    _tiny_dataset(ds)
    calls = {"accumulate": 0, "rasterize": 0}
    for op in calls:
        plain = getattr(S, f"{op}_plain")

        def counted(*args, _op=op, _plain=plain, **kwargs):
            calls[_op] += 1
            return _plain(*args, **kwargs)
        monkeypatch.setattr(S, f"{op}_plain", counted)
    opts = ["MODEL.STATE_ENCODER.hidden_size", HIDDEN,
            "NUM_ENVIRONMENTS", 2, "EVAL.EPISODE_COUNT", 2,
            "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", 4,
            "TPU.world_grid_cells", 256,
            "TASK_CONFIG.DATASET.DATA_PATH",
            os.path.join(ds, "{split}", "{split}.json.gz"),
            "TASK_CONFIG.DATASET.TOURS_FILE", os.path.join(ds, "tours.json"),
            "TASK_CONFIG.TASK.NDTW.GT_PATH",
            os.path.join(ds, "{split}", "{split}_gt.json.gz"),
            "EVAL.ITERATIVE_GT_PATHS", os.path.join(ds, "gt_ndtw.json")]
    for s in ("DEPTH_SENSOR", "RGB_SENSOR"):
        opts += [f"TASK_CONFIG.SIMULATOR.{s}.HEIGHT", HW,
                 f"TASK_CONFIG.SIMULATOR.{s}.WIDTH", HW]
    config = torch_config(CONFIG, opts)
    torch.manual_seed(3)
    ckpt = str(tmp_path / "ckpt.0.pth")
    save_checkpoint(TorchMap.from_config(config, {"depth_hw": HW,
                                                  "map_hw": HW}),
                    config, ckpt)
    runs = {}
    for name, extra in (("bf16", BF16), ("f32", [])):
        out = tmp_path / name
        out.mkdir()
        for k in calls:
            calls[k] = 0
        trainer = run_exp(CONFIG, "eval", opts + extra + [
            "EVAL_CKPT_PATH_DIR", ckpt,
            "CHECKPOINT_FOLDER", str(out / "ckpts"),
            "TENSORBOARD_DIR", str(out / "tb"),
            "RESULTS_DIR", str(out / "results"),
            "LOG_FILE", str(out / "log")], device="cpu")
        assert trainer.policy.net.compute_dtype == (BF if extra else None)
        steps = trainer.policy_steps
        assert steps > 0
        assert calls == {"accumulate": steps, "rasterize": steps}
        with open(out / "results" /
                  "iterative_stats_ckpt_0_val_seen.json") as f:
            stats = json.load(f)
        assert all(np.isfinite(v) for v in stats.values())
        runs[name] = (stats, trainer.episodes_evaluated)
    assert set(runs["bf16"][0]) == set(runs["f32"][0])
    assert runs["bf16"][1] == runs["f32"][1] > 0


@pytest.mark.parametrize("config_path", [
    "configs/fake/map_cma_train_tf.yaml",  # iterative_collection_dagger
    "configs/fake/latent_cma_train.yaml",  # dagger
    "configs/fake/tour_cma_train.yaml",  # iterative_dagger
])
def test_trainers_train_under_bf16(config_path, tmp_path):
    """Each trainer's ``train()`` through ``run_exp`` under bfloat16 (64^2
    sensors, hidden 64, two collected episodes of at most 4 steps): it
    finishes with finite losses, stores float32 frozen-encoder features
    and writes a checkpoint of float32 tensors."""
    import math
    import random

    from ivlnce_tpu_torch.run import run_exp
    from ivlnce_tpu_torch.trainers.base_trainer import load_checkpoint
    from ivlnce_tpu_torch.trainers.trajectory_store import TrajectoryStore

    os.chdir(REPO)
    opts = BF16 + ["MODEL.STATE_ENCODER.hidden_size", HIDDEN,
                   "CHECKPOINT_FOLDER", str(tmp_path / "ckpts"),
                   "TENSORBOARD_DIR", str(tmp_path / "tb"),
                   "RESULTS_DIR", str(tmp_path / "results"),
                   "LOG_FILE", str(tmp_path / "train.log"),
                   "IL.batch_size", 2, "IL.epochs", 1,
                   "IL.DAGGER.update_size", 2,
                   "IL.DAGGER.lmdb_features_dir", str(tmp_path / "traj"),
                   "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", 4]
    for s in ("DEPTH_SENSOR", "RGB_SENSOR"):
        opts += [f"TASK_CONFIG.SIMULATOR.{s}.HEIGHT", HW,
                 f"TASK_CONFIG.SIMULATOR.{s}.WIDTH", HW]
    random.seed(0)
    np.random.seed(0)
    trainer = run_exp(config_path, "train", opts, device="cpu")
    assert trainer.policy.net.compute_dtype == BF
    assert trainer.losses and all(math.isfinite(x) for step in trainer.losses
                                  for x in step)
    with TrajectoryStore(str(tmp_path / "traj")) as store:
        first = int(isinstance(store.get(0), dict))  # a tours index
        obs = store.get(first)[0]
    assert obs["depth_features"].dtype == np.float32  # lmdb_fp16 off
    ckpts = sorted((tmp_path / "ckpts").glob("ckpt.*.pth"))
    state = load_checkpoint(str(ckpts[-1]))["state_dict"]
    assert {v.dtype for v in state.values() if v.is_floating_point()} == {
        torch.float32}
