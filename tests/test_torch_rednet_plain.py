"""The port's RedNet (``ivlnce_tpu_torch/models/rednet.py``) against the
benchmark's plain reference (``portbench/reference/rednet.py``), on the
CPU with seeded weights (``portbench/harness.py::seed_weights``: norms'
statistics far from a fresh init's): scores, labels and the input
preparation; the FLOP count of ``portbench/flops_rednet.py``; and the
spans and counter of ``predict_semantics`` inside a predicted-semantics
policy step. Imports no JAX."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from ivlnce_tpu_torch.models import rednet as TR
from ivlnce_tpu_torch.utils import profiling
from portbench import flops_rednet, harness
from portbench.reference import rednet as RR

SCORE_RTOL = 1e-5  # of the largest |score|: float32 in different orders
# labels are compared where the top-2 margin exceeds ten times the score
# tolerance: a flip there needs an error five times over it
MARGIN_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _frames(seed, batch, rgb_side, depth_side):
    g = torch.Generator().manual_seed(seed)
    rgb = torch.randint(0, 256, (batch, rgb_side, rgb_side, 3),
                        generator=g).to(torch.uint8)
    depth = torch.rand(batch, depth_side, depth_side, generator=g)
    return rgb, depth


@pytest.mark.parametrize("layers,trans_layers,side,seed", [
    (TR.LAYERS, TR.TRANS_LAYERS, 64, 3),
    ((1, 1, 1, 1), (1, 1, 1, 1), 32, 4),
])
def test_port_rednet_matches_the_plain_reference(layers, trans_layers, side,
                                                 seed):
    model = TR.RedNet(layers=layers, trans_layers=trans_layers).eval()
    harness.seed_weights(model, seed)
    rgb, depth = _frames(seed, 2, side * 7 // 8, side)
    with torch.no_grad():
        got = model(*TR.normalize_inputs(rgb, depth)).permute(0, 3, 1, 2)
    want = RR.scores(model.state_dict(), rgb, depth, layers, trans_layers)
    assert got.shape == want.shape == (2, 13, side, side)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= SCORE_RTOL * scale
    top = want.topk(2, dim=1).values
    sure = (top[:, 0] - top[:, 1]) > MARGIN_RTOL * scale
    assert float(sure.float().mean()) > 0.9
    assert torch.equal(got.argmax(1)[sure], want.argmax(1)[sure])
    labels = TR.predict_semantics(model, rgb, depth)
    assert torch.equal(labels.long()[sure], want.argmax(1)[sure])


@pytest.mark.parametrize("rgb_side,depth_side", [(56, 64), (64, 64)])
def test_input_preparations_agree(rgb_side, depth_side):
    rgb, depth = _frames(5, 3, rgb_side, depth_side)
    port_rgb, port_depth = TR.normalize_inputs(rgb, depth)
    ref_rgb, ref_depth = RR.prepare(rgb, depth)
    assert float((port_rgb.permute(0, 3, 1, 2) - ref_rgb).abs().max()) \
        <= 1e-6
    assert float((port_depth.permute(0, 3, 1, 2) - ref_depth).abs().max()) \
        <= 1e-6


def _hooked_flops(model, side):
    """Two per multiply-add of every (transposed) convolution, counted
    from the shapes a forward pass meets."""
    macs = 0

    def count(mod, inp, out):
        nonlocal macs
        k = mod.kernel_size[0] * mod.kernel_size[1]
        if isinstance(mod, torch.nn.ConvTranspose2d):
            macs += inp[0].numel() * mod.out_channels * k
        else:
            macs += out.numel() * mod.in_channels * k

    hooks = [m.register_forward_hook(count) for m in model.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
    with torch.no_grad():
        model(torch.zeros(1, side, side, 3), torch.zeros(1, side, side, 1))
    for h in hooks:
        h.remove()
    return 2 * macs


def test_rednet_flops_from_the_widths():
    assert flops_rednet.rednet_flops(256) == 38_721_814_528
    layers, trans = (1, 2, 1, 1), (1, 2, 1, 2)
    model = TR.RedNet(layers=layers, trans_layers=trans).eval()
    assert flops_rednet.rednet_flops(32, 13, layers, trans) == \
        _hooked_flops(model, 32)


def test_reference_and_counts_import_no_port_and_no_jax():
    code = ("import sys, portbench.reference.rednet, portbench.flops_rednet; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'ivlnce_tpu', 'ivlnce_tpu_torch')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=harness.ROOT).stdout
    assert out.strip() == "[]"


LANES = 3


@pytest.fixture(scope="module")
def predicted_trainer(tmp_path_factory):
    """A MapCMA trainer with the predicted-semantics mapper (the full
    RedNet) at 64² sensors."""
    from ivlnce_tpu_torch.config import get_config
    from ivlnce_tpu_torch.run import register_all
    from ivlnce_tpu_torch.trainers.base_trainer import BaseVLNCETrainer

    register_all()
    root = tmp_path_factory.mktemp("rednet_spans")
    opts = ["TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.HEIGHT", 64,
            "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.WIDTH", 64,
            "TASK_CONFIG.SIMULATOR.RGB_SENSOR.HEIGHT", 56,
            "TASK_CONFIG.SIMULATOR.RGB_SENSOR.WIDTH", 56,
            "MODEL.STATE_ENCODER.hidden_size", 64,
            "RL.POLICY.OBS_TRANSFORMS.ENABLED_TRANSFORMS",
            ["PredictedSemanticsIterativeMapper"],
            "TPU.world_grid_cells", 256, "NUM_ENVIRONMENTS", LANES,
            "CHECKPOINT_FOLDER", str(root / "ckpts"),
            "RESULTS_DIR", str(root / "results")]
    config = get_config("configs/fake/map_cma_eval_iterative.yaml", opts)
    t = BaseVLNCETrainer(config, "cpu")
    t._setup_obs_transforms(config)
    t._initialize_policy(config, None)
    assert t.obs_transforms[0].rednet is not None
    # a step outside any capture: the next capture's tables start afresh
    _step(t, np.random.default_rng(2), profile=False)
    return t


def _step(trainer, rng, profile: bool):
    ones = np.ones((LANES, 1), np.uint8)
    batch = {
        "depth": rng.random((LANES, 64, 64, 1), dtype=np.float32),
        "rgb": rng.integers(0, 256, (LANES, 56, 56, 3), np.uint8),
        "world_robot_pose": np.stack(
            [rng.random(LANES), np.full(LANES, 1.25), rng.random(LANES)], 1),
        "world_robot_orientation": np.stack(
            [np.zeros(LANES), rng.random(LANES)], 1),
        "instruction": rng.integers(1, 30, (LANES, 12)).astype(np.int64),
    }
    rnn = trainer.policy.initial_rnn_states(LANES, "cpu")
    prev = np.zeros((LANES, 1), np.int64)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.inference_mode():
        if not profile:
            trainer._policy_step(batch, ones * 0, rnn, prev,
                                 (ones, ones, ones * 0, ones))
            return None
        with torch.profiler.profile(activities=acts) as prof:
            trainer._policy_step(batch, ones * 0, rnn, prev,
                                 (ones, ones, ones * 0, ones))
    return prof


def _ranges(prof, name):
    return [(e.time_range.start, e.time_range.end)
            for e in prof.events() if e.name == name]


def test_rednet_spans_inside_semantics_within_one_policy_step(
        predicted_trainer):
    prof = _step(predicted_trainer, np.random.default_rng(0), profile=True)
    (step,) = _ranges(prof, "policy_step")
    (semantics,) = _ranges(prof, "semantics")
    assert step[0] <= semantics[0] and semantics[1] <= step[1]
    order = []
    for name in ("rednet_inputs", "rednet", "rednet_labels"):
        (found,) = _ranges(prof, name)
        assert semantics[0] <= found[0] and found[1] <= semantics[1], name
        order.append(found)
    assert order[0][1] <= order[1][0] and order[1][1] <= order[2][0]
    got = profiling.traced()
    assert got["counts"]["rednet_frames"] == LANES
    assert got["host_us"]["semantics"] >= got["host_us"]["rednet"] > 0


def test_rednet_frames_counts_only_under_a_capture(predicted_trainer):
    rng = np.random.default_rng(1)
    for _ in range(2):
        before = profiling.traced()["counts"].get("rednet_frames")
        _step(predicted_trainer, rng, profile=False)
        assert profiling.traced()["counts"].get("rednet_frames") == before
        _step(predicted_trainer, rng, profile=True)  # a capture restarts
        assert profiling.traced()["counts"]["rednet_frames"] == LANES
