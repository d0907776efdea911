"""The port's RedNet and predicted-semantics mappers against the JAX
package's.

Weights come from the JAX package's ``init_rednet`` (running statistics
and affine terms of every norm redrawn from a numpy seed, so the norms
matter) and reach the port through ``rednet_params_from_jax``. Both sides
run in float32 with the same convolution arithmetic up to summation
order: logits agree to rtol = atol = 1e-5, the resize to 1e-6. Labels are
compared where JAX's top-2 logit margin exceeds 1e-4, so a near tie that
either side may break differently is not counted; the maps are compared
exactly with the labels fed equal to both mappers."""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ivlnce_tpu.mapping.obs_transforms as JOT
from ivlnce_tpu.models import rednet as RD
from ivlnce_tpu_torch.mapping import obs_transforms as TOT
from ivlnce_tpu_torch.models import rednet as TR
from ivlnce_tpu_torch.models.convert import rednet_params_from_jax
from ivlnce_tpu_torch.ops.geometry import MapDims as TDims
from tests.test_torch_known_maps import make_params, make_transforms
from tests.test_torch_train import one_torch_thread  # noqa: F401  (autouse)

MARGIN = 1e-4


def _randomize_norms(tree, rng):
    for v in tree.values():
        if isinstance(v, dict) and "mean" in v:
            v["mean"] = rng.normal(0, 0.1, v["mean"].shape).astype(np.float32)
            v["var"] = rng.uniform(0.5, 1.5, v["var"].shape).astype(np.float32)
            v["scale"] = rng.uniform(0.5, 1.5, v["scale"].shape).astype(
                np.float32)
            v["bias"] = rng.normal(0, 0.1, v["bias"].shape).astype(np.float32)
        elif isinstance(v, dict):
            _randomize_norms(v, rng)


def _reduce(tree, layers, trans_layers):
    """The JAX tree with fewer blocks per stage: encoder stages keep their
    first blocks, decoder stages their first identity blocks and the last
    (up) block."""
    out = dict(tree)
    for si, k in enumerate(layers):
        for suffix in ("", "_d"):
            name = f"layer{si + 1}{suffix}"
            out[name] = {str(i): tree[name][str(i)] for i in range(k)}
    for di, k in enumerate(trans_layers):
        stage = tree[f"deconv{di + 1}"]
        last = str(len(stage) - 1)
        out[f"deconv{di + 1}"] = {
            **{str(i): stage[str(i)] for i in range(k - 1)},
            str(k - 1): stage[last],
        }
    return out


@pytest.fixture(scope="module")
def full_weights():
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        np.asarray, jax.device_get(RD.init_rednet(jax.random.PRNGKey(0))))
    _randomize_norms(params, rng)
    model = TR.RedNet().eval()
    model.load_state_dict(rednet_params_from_jax(params))
    return params, model


def _reduced(full_weights, layers=(1, 1, 1, 1), trans=(1, 2, 1, 1)):
    params = _reduce(full_weights[0], layers, trans)
    model = TR.RedNet(layers=layers, trans_layers=trans).eval()
    model.load_state_dict(rednet_params_from_jax(params))
    return params, model


def test_rednet_logits_match_jax(full_weights):
    """Full width, 64x64, B=1."""
    params, model = full_weights
    rng = np.random.default_rng(1)
    rgb = rng.normal(size=(1, 64, 64, 3)).astype(np.float32)
    depth = rng.normal(size=(1, 64, 64, 1)).astype(np.float32)
    ref = np.asarray(jax.jit(RD.apply_rednet)(params, rgb, depth))
    with torch.no_grad():
        got = model(torch.from_numpy(rgb), torch.from_numpy(depth)).numpy()
    assert got.shape == (1, 64, 64, 13)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_reduced_rednet_matches_jax(full_weights):
    params, model = _reduced(full_weights)
    assert len(model.layer3) == 1 and len(model.deconv2) == 2
    rng = np.random.default_rng(2)
    rgb = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    depth = rng.normal(size=(2, 32, 32, 1)).astype(np.float32)
    ref = np.asarray(jax.jit(RD.apply_rednet)(params, rgb, depth))
    with torch.no_grad():
        got = model(torch.from_numpy(rgb), torch.from_numpy(depth)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("src,dst", [((48, 40), (64, 64)),
                                     ((96, 112), (64, 64)),
                                     ((224, 224), (256, 256))])
def test_bilinear_resize_matches_jax(src, dst):
    """Upsampling (plain bilinear) and downsampling (antialiased)."""
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 1, (2,) + src + (3,)).astype(np.float32)
    ref = np.asarray(RD.bilinear_resize(jnp.asarray(x), dst))
    got = TR.bilinear_resize(torch.from_numpy(x), dst).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def _jax_scores(params, rgb_uint8, depth):
    """predict_semantics' normalization, then the scores."""
    rgb = RD.bilinear_resize(rgb_uint8.astype(jnp.float32) / 255.0,
                             depth.shape[1:3])
    rgb = (rgb - RD.RGB_MEAN) / RD.RGB_STD
    d = (depth[..., None] - RD.DEPTH_MEAN) / RD.DEPTH_STD
    return RD.apply_rednet(params, rgb, d)


def _decided(scores):
    """Pixels whose top-2 logit margin exceeds MARGIN."""
    top2 = np.sort(np.asarray(scores), axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0] > MARGIN


@pytest.mark.parametrize("rgb_hw", [48, 96])
def test_predict_semantics_matches_jax(full_weights, rgb_hw):
    """RGB upsampled (48 -> 64) and downsampled (96 -> 64) to the depth."""
    params, model = full_weights
    rng = np.random.default_rng(rgb_hw)
    rgb = rng.integers(0, 256, (2, rgb_hw, rgb_hw, 3)).astype(np.uint8)
    depth = rng.uniform(0, 1, (2, 64, 64)).astype(np.float32)
    ref = np.asarray(jax.jit(RD.predict_semantics)(params, rgb, depth))
    decided = _decided(jax.jit(_jax_scores)(params, rgb, depth))
    with torch.no_grad():
        got = TR.predict_semantics(model, torch.from_numpy(rgb),
                                   torch.from_numpy(depth))
    assert got.dtype == torch.uint8 and got.shape == (2, 64, 64)
    assert decided.mean() > 0.99
    np.testing.assert_array_equal(got.numpy()[decided], ref[decided])
    assert len(np.unique(ref)) > 1


def test_predicted_mapper_steps_match_jax(full_weights, monkeypatch):
    """Two PredictedSemanticsIterativeMapper steps of the port against
    the JAX mapper fed JAX's RedNet labels: the port's own labels agree
    where decided, and with the labels fed equal the maps are equal."""
    params, model = _reduced(full_weights)
    hw = 32
    jp, tp = make_params(hw=hw)
    jt = JOT.GTSemanticsIterativeMapper(
        jp.camera, JOT.MapDims(3.2, 3.2, 0.1), grid_cells=jp.grid_cells,
        window_cells=jp.window_cells)
    tt = TOT.PredictedSemanticsIterativeMapper(
        tp.camera, TDims(3.2, 3.2, 0.1), torch.device("cpu"),
        grid_cells=tp.grid_cells, window_cells=tp.window_cells, rednet=model)
    assert "rgb" in tt.device_obs_keys
    assert "semantic12" not in tt.device_obs_keys
    j_step = jax.jit(jt.make_device_step())
    t_step = tt.make_device_step()
    predict = TR.predict_semantics
    fed = {}

    def fed_labels(m, rgb, depth, dtype=None):
        own = predict(m, rgb, depth, dtype)
        fed["own"] = own
        return torch.from_numpy(fed["jax"].copy())

    monkeypatch.setattr(TR, "predict_semantics", fed_labels)
    rng = np.random.default_rng(9)
    pose = np.array([[0.0, 1.25, 0.0], [0.5, 1.25, -0.4]], np.float32)
    orient = np.array([[0.0, 0.2], [0.0, -1.3]], np.float32)
    masks = np.zeros(2, np.float32)
    for t in range(2):
        rgb = rng.integers(0, 256, (2, hw, hw, 3)).astype(np.uint8)
        depth = rng.uniform(0.05, 0.6, (2, hw, hw, 1)).astype(np.float32)
        fed["jax"] = np.asarray(jax.jit(RD.predict_semantics)(
            params, rgb, depth[..., 0]))
        decided = _decided(jax.jit(_jax_scores)(params, rgb, depth[..., 0]))
        tt.host_prepare({}, masks)
        jt.host_prepare({}, masks)
        jobs = {"depth": depth, "semantic12": fed["jax"][..., None],
                "world_robot_pose": pose, "world_robot_orientation": orient}
        jt.state, jocc, jsem = j_step(
            jt.state, {k: jnp.asarray(v) for k, v in jobs.items()},
            jnp.asarray(masks), {})
        tobs = {"depth": torch.from_numpy(depth), "rgb": torch.from_numpy(rgb),
                "world_robot_pose": pose, "world_robot_orientation": orient}
        with torch.no_grad():
            tt.state, tocc, tsem = t_step(tt.state, tobs, masks, tt.rednet)
        assert decided.mean() > 0.99
        np.testing.assert_array_equal(fed["own"].numpy()[decided],
                                      fed["jax"][decided])
        np.testing.assert_array_equal(tocc.numpy(), np.asarray(jocc))
        np.testing.assert_array_equal(tsem.numpy(), np.asarray(jsem))
        assert int(tocc.numpy().sum()) > 0
        pose = pose + np.float32(0.2)
        masks = np.ones(2, np.float32)


def test_predicted_known_mapper_matches_jax(tmp_path):
    """PredictedSemanticsKnownMapper preloads the clouds it finds in its
    maps location (here .npz files written by the test) and reads no RGB."""
    from tests.test_torch_known_maps import SEQUENCE, write_scenes

    rng = np.random.default_rng(4)
    write_scenes(str(tmp_path), rng)
    jt, tt = make_transforms(str(tmp_path),
                             jax_cls=JOT.PredictedSemanticsKnownMapper,
                             torch_cls=TOT.PredictedSemanticsKnownMapper)
    assert tt.maps_location == str(tmp_path)
    assert tt.device_obs_keys == jt.device_obs_keys
    assert "rgb" not in tt.device_obs_keys
    j_step = jax.jit(jt.make_device_step())
    t_step = tt.make_device_step()
    hw = 16
    pose = np.array([[0.0, 1.25, 0.0], [0.8, 1.25, -0.6],
                     [-1.2, 1.25, 0.7]], np.float32)
    orient = np.zeros((3, 2), np.float32)
    for names, masks, _ in SEQUENCE[:4]:
        obs = {"env_name": names, "world_robot_pose": pose}
        masks = np.array(masks, np.float32)
        jt.host_prepare(dict(obs), masks)
        tt.host_prepare(dict(obs), masks)
        depth = rng.uniform(0.05, 0.6, (3, hw, hw, 1)).astype(np.float32)
        jt.state, jocc, jsem = j_step(
            jt.state, {"depth": jnp.asarray(depth),
                       "world_robot_pose": jnp.asarray(pose),
                       "world_robot_orientation": jnp.asarray(orient)},
            jnp.asarray(masks), {})
        tt.state, tocc, tsem = t_step(
            tt.state, {"depth": torch.from_numpy(depth),
                       "world_robot_pose": pose,
                       "world_robot_orientation": orient}, masks, None)
        np.testing.assert_array_equal(tocc.numpy(), np.asarray(jocc))
        np.testing.assert_array_equal(tsem.numpy(), np.asarray(jsem))
        pose = pose + np.float32(0.1)
    assert int(tocc.numpy().sum()) > 0


def test_predicted_mapper_from_config_uses_a_seeded_rednet():
    """No reference checkpoint in the repository: a RedNet from a seeded
    generator, in eval mode, the same on every build; known-map mode builds
    none; with ``TPU.compute_dtype bfloat16`` the same weights label a
    frame in bfloat16."""
    from ivlnce_tpu_torch.config import get_config

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    os.chdir(repo)
    assert not os.path.exists(TOT.REDNET_CHECKPOINT)
    config = get_config("configs/fake/map_cma_eval_iterative.yaml", [
        "RL.POLICY.OBS_TRANSFORMS.ENABLED_TRANSFORMS",
        "['PredictedSemanticsIterativeMapper']"])
    (a,) = TOT.get_active_obs_transforms(config, torch.device("cpu"))
    b = TOT.PredictedSemanticsIterativeMapper.from_config(
        config, torch.device("cpu"))
    assert isinstance(a, TOT.PredictedSemanticsIterativeMapper)
    assert not a.rednet.training
    for (ka, va), (kb, vb) in zip(a.rednet.state_dict().items(),
                                  b.rednet.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    assert TOT.PredictedSemanticsKnownMapper.from_config(
        config, torch.device("cpu")).rednet is None
    config.defrost()
    config.TPU.compute_dtype = "bfloat16"
    config.TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.HEIGHT = 32
    config.TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.WIDTH = 32
    c = TOT.PredictedSemanticsIterativeMapper.from_config(
        config, torch.device("cpu"))
    assert math.isfinite(float(next(a.rednet.parameters()).detach().sum()))
    # bfloat16: the same float32 weights; the device step labels a frame
    # with RedNet run in bfloat16
    assert c.compute_dtype == torch.bfloat16
    for (ka, va), (kc, vc) in zip(a.rednet.state_dict().items(),
                                  c.rednet.state_dict().items()):
        assert ka == kc and vc.dtype == va.dtype and torch.equal(va, vc)
    seen = []
    hook = c.rednet.conv1.register_forward_pre_hook(
        lambda m, inp: seen.append(inp[0].dtype))
    rng = np.random.default_rng(11)
    depth = rng.uniform(0.05, 0.6, (1, 32, 32, 1)).astype(np.float32)
    rgb = rng.integers(0, 256, (1, 48, 48, 3)).astype(np.uint8)
    masks = np.zeros(1, np.float32)
    c.host_prepare({}, masks)
    with torch.no_grad():
        _, occ, sem = c.make_device_step()(
            c.state, {"depth": torch.from_numpy(depth),
                      "rgb": torch.from_numpy(rgb),
                      "world_robot_pose": np.array([[0.0, 1.25, 0.0]],
                                                   np.float32),
                      "world_robot_orientation": np.zeros((1, 2),
                                                          np.float32)},
            masks, c.rednet)
    hook.remove()
    assert seen == [torch.bfloat16]
    assert sem.dtype == torch.uint8 and int(occ.sum()) > 0
