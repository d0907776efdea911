"""The port's host-side eval surface against the JAX package's: video
frames (``utils/viz.py``), the top-down map measure on FakeSim
(``tasks/maps.py`` through ``TOP_DOWN_MAP_VLNCE``), with ``cv2`` and with
its fallbacks (``cv2`` set to None in both packages' modules, as on a
machine without it); the spans and the host-phase report
(``utils/profiling.py``, as ``tests/test_profiling.py`` holds the JAX
package's timers); the on-demand trace; and both policies built for
bfloat16."""

import os
import pickle

import numpy as np
import pytest
import torch

from ivlnce_tpu.config.task_default import get_extended_config as jax_task
from ivlnce_tpu.envs.fake_sim import FakeSim as JaxFakeSim
from ivlnce_tpu.tasks import maps as jax_maps
from ivlnce_tpu.tasks import measures as jax_measures
from ivlnce_tpu.utils import viz as jax_viz
from ivlnce_tpu_torch.config.task_default import (
    get_extended_config as torch_task,
)
from ivlnce_tpu_torch.envs.fake_sim import FakeSim as TorchFakeSim
from ivlnce_tpu_torch.tasks import maps as torch_maps
from ivlnce_tpu_torch.tasks import measures as torch_measures
from ivlnce_tpu_torch.utils import profiling
from ivlnce_tpu_torch.utils import viz as torch_viz
from tests.test_torch_train import one_torch_thread  # noqa: F401  (autouse)

SIDES = {
    "jax": (jax_task, JaxFakeSim, jax_measures, jax_viz),
    "torch": (torch_task, TorchFakeSim, torch_measures, torch_viz),
}


@pytest.fixture(params=["cv2", "no_cv2"])
def cv2_mode(request, monkeypatch):
    """Both packages with cv2, or both with their cv2-free fallbacks."""
    if request.param == "no_cv2":
        for module in (jax_maps, jax_viz, torch_maps, torch_viz):
            monkeypatch.setattr(module, "cv2", None)
    return request.param


class _Goal:
    position = [3.0, 0.0, 3.0]


class _Ep:
    scene_id = "topdown_scene"
    start_position = [0.0, 0.0, 0.0]
    goals = [_Goal()]
    reference_path = [[0.0, 0.0, 0.0], [1.5, 0.0, 1.5], [3.0, 0.0, 3.0]]


def _graphs_file(tmp_path):
    """An MP3D connectivity graph along the agent's forward line."""
    import networkx as nx

    g = nx.Graph()
    for i, z in enumerate([0.0, -1.0, -2.0, -3.0]):
        g.add_node(f"n{i}", position=np.array([0.0, 0.0, z], np.float32))
    for i in range(3):
        g.add_edge(f"n{i}", f"n{i + 1}")
    path = os.path.join(tmp_path, "graphs.pkl")
    with open(path, "wb") as f:
        pickle.dump({"topdown_scene": g}, f)
    return path


def _walk(side, graphs_file, steps=8):
    """TOP_DOWN_MAP_VLNCE over a FakeSim walk; the metric after each
    step."""
    task, fake_sim, measures, _ = SIDES[side]
    cfg = task()
    cfg.defrost()
    cfg.TASK.TOP_DOWN_MAP_VLNCE.GRAPHS_FILE = graphs_file
    cfg.freeze()
    sim = fake_sim(scene_id="topdown_scene")
    sim.set_agent_state([0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 1.0])
    sim.reset()
    m = measures.TopDownMapVLNCE(sim=sim, config=cfg.TASK.TOP_DOWN_MAP_VLNCE)
    ms = measures.Measurements([m])
    m.reset_metric(_Ep(), ms)
    metrics = [m.get_metric()]
    for step in range(steps):
        sim.step(1 if step % 3 else 2)
        m.update_metric(_Ep(), ms)
        metrics.append(m.get_metric())
    return metrics, m._nearest_node


def _assert_same(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


def test_topdown_map_matches_jax(cv2_mode, tmp_path):
    graphs = _graphs_file(tmp_path)
    jax_metrics, jax_node = _walk("jax", graphs)
    torch_metrics, torch_node = _walk("torch", graphs)
    _assert_same(torch_metrics, jax_metrics)
    assert torch_node == jax_node
    last = torch_metrics[-1]
    assert last["fog_of_war_mask"].sum() > 0
    # the MP3D nodes are drawn with cv2; its fallback skips the drawing
    drawn = (last["map"] == torch_maps.MAP_MP3D_WAYPOINT).any()
    assert drawn == (cv2_mode == "cv2")


def test_video_frames_match_jax(cv2_mode, tmp_path):
    """The eval loop's frame: sensors, top-down map, instruction text and
    the egocentric map panels, stacked."""
    rng = np.random.default_rng(4)
    metrics, _ = _walk("jax", "")
    info = {"top_down_map_vlnce": metrics[-1]}
    obs = {
        "rgb": rng.integers(0, 256, (48, 48, 3)).astype(np.uint8),
        "depth": rng.random((48, 48, 1), np.float32),
    }
    occ = rng.integers(0, 2, (64, 64)).astype(np.uint8)
    sem = rng.integers(0, 14, (64, 64)).astype(np.uint8)
    frames = {}
    for side, (_, _, _, viz) in SIDES.items():
        frame = viz.observations_to_image(obs, info)
        frame = viz.append_text_to_image(
            frame, "walk past the sofa and stop at the red chair")
        panels = viz.append_image_horizontally([
            viz.visualize_ego_occupancy_map(occ),
            viz.visualize_ego_semantic_map(sem),
        ])
        frames[side] = viz.append_image_vertically([frame, panels])
    np.testing.assert_array_equal(frames["torch"], frames["jax"])
    assert frames["torch"].shape[1] >= 2 * 4 * 64
    assert frames["torch"].shape[0] >= 48 + 4 * 64


def test_generate_video_writes_what_jax_writes(tmp_path):
    frames = [np.random.default_rng(i).integers(0, 255, (32, 32, 3))
              .astype(np.uint8) for i in range(5)]

    class _TB:
        def add_video_from_np_images(self, *a, **k):
            pass

    for side, (_, _, _, viz) in SIDES.items():
        viz.generate_video(["disk"], str(tmp_path / side), frames, "ep1", 0,
                           {"spl": 0.5}, _TB())
    names = sorted(os.listdir(tmp_path / "torch"))
    assert names == sorted(os.listdir(tmp_path / "jax"))
    assert len(names) == 1 and names[0].startswith("episode=ep1-ckpt=0")


# -- spans and the host-phase report (tests/test_profiling.py's cases) -----
def test_wall_range_disabled_is_noop(monkeypatch):
    """A span without ``IVLNCE_PHASE_TIMES`` and outside a capture
    records nothing (the JAX package's ``wall_range`` case)."""
    monkeypatch.setattr(profiling, "_PHASES_ON", False)
    profiling.reset_phases()
    with profiling.span("x"):
        pass
    assert profiling.phase_report() == ""
    assert profiling._depth == 0


def test_wall_range_accumulates_and_reports(monkeypatch):
    monkeypatch.setattr(profiling, "_PHASES_ON", True)
    profiling.reset_phases()
    for _ in range(3):
        with profiling.span("alpha"):
            pass
    with profiling.span("beta"):
        pass
    report = profiling.phase_report()
    assert "alpha=" in report and "/3" in report
    assert "beta=" in report and "%" in report
    profiling.reset_phases()
    assert profiling.phase_report() == ""


def test_wall_range_counts_exceptions(monkeypatch):
    monkeypatch.setattr(profiling, "_PHASES_ON", True)
    profiling.reset_phases()
    with pytest.raises(RuntimeError):
        with profiling.span("boom"):
            raise RuntimeError
    assert "boom=" in profiling.phase_report()
    assert profiling._depth == 0
    profiling.reset_phases()


def test_nested_spans_count_once_in_the_phase_report(monkeypatch):
    """Only the outermost span adds its wall time to the report, so the
    report's shares add up to the loop's time once."""
    monkeypatch.setattr(profiling, "_PHASES_ON", True)
    profiling.reset_phases()
    for _ in range(2):
        with profiling.span("outer"):
            with profiling.span("inner"):
                with profiling.span("innermost"):
                    pass
            with profiling.span("inner"):
                pass
    assert set(profiling._phase_times) == {"outer"}
    assert profiling._phase_counts == {"outer": 2}
    assert "inner" not in profiling.phase_report()
    profiling.reset_phases()


def test_spans_and_counts_under_a_capture(monkeypatch):
    """Under a ``torch.profiler`` capture every span is a range of the
    trace and adds its host time, children included, to ``traced()``;
    ``count`` adds there too. Outside a capture neither records, and the
    tables restart with the next capture."""
    monkeypatch.setattr(profiling, "_PHASES_ON", False)
    with profiling.span("before"):
        profiling.count("rows", 5)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(2):
            with profiling.span("outer"):
                with profiling.span("inner"):
                    torch.ones(4).sum()
                profiling.count("rows", 3)
    with profiling.span("after"):
        profiling.count("rows", 7)
    got = profiling.traced()
    assert set(got["host_us"]) == {"outer", "inner"}
    assert got["host_us"]["outer"] >= got["host_us"]["inner"] > 0
    assert got["counts"] == {"rows": 6}
    names = [e.name for e in prof.events()]
    assert names.count("outer") == 2 and names.count("inner") == 2
    with torch.profiler.profile(activities=acts):
        with profiling.span("next"):
            pass
    assert set(profiling.traced()["host_us"]) == {"next"}
    assert profiling.traced()["counts"] == {}


def test_phase_times_are_read_from_the_environment_at_import():
    import subprocess
    import sys

    code = ("from ivlnce_tpu_torch.utils import profiling\n"
            "print(profiling._PHASES_ON)\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    got = {}
    for value in ("1", ""):
        env = dict(os.environ, IVLNCE_PHASE_TIMES=value)
        proc = subprocess.run([sys.executable, "-c", code], cwd=repo,
                              env=env, capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode == 0, proc.stderr
        got[value] = proc.stdout.strip()
    assert got == {"1": "True", "": "False"}


def test_trace_window_writes_a_chrome_trace(tmp_path, monkeypatch):
    import json

    from ivlnce_tpu_torch.config import get_config

    monkeypatch.delenv("IVLNCE_PROFILE_DIR", raising=False)
    assert not profiling.maybe_start_trace(get_config(), "cpu")  # no dir
    config = get_config(None, ["TPU.profile_dir", str(tmp_path / "prof")])
    assert profiling.maybe_start_trace(config, "cpu")
    assert not profiling.maybe_start_trace(config, "cpu")  # already open
    for _ in range(3):
        with profiling.span("policy_step"):
            torch.ones(4).sum()
    path = profiling.maybe_stop_trace()
    assert profiling.maybe_stop_trace() is None
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert sum(e.get("name") == "policy_step" for e in events) == 3
    # the environment variable wins over the config
    monkeypatch.setenv("IVLNCE_PROFILE_DIR", str(tmp_path / "env"))
    assert profiling.profile_dir_from(config) == str(tmp_path / "env")


# -- bfloat16 -------------------------------------------------------------------
@pytest.mark.parametrize("policy_name", ["MapCMAPolicy", "LatentCMAPolicy"])
def test_policies_build_bfloat16(policy_name):
    """``TPU.compute_dtype bfloat16`` builds both policies with float32
    weights; their encoders' convolutions then see bfloat16 inputs and
    weights, and the features come back float32, within bfloat16's
    rounding of the float32 ones (``tests/test_torch_bf16.py`` holds them
    against the JAX package)."""
    from ivlnce_tpu_torch.config import get_config
    from ivlnce_tpu_torch.run import register_all
    from ivlnce_tpu_torch.utils.registry import registry

    register_all()
    config = get_config(None, ["TPU.compute_dtype", "bfloat16",
                               "MODEL.STATE_ENCODER.hidden_size", "64"])
    policy = registry.get_policy(policy_name).from_config(
        config, {"depth_hw": 64, "map_hw": 64}).eval()
    assert policy.net.compute_dtype == torch.bfloat16
    assert {v.dtype for v in policy.state_dict().values()
            if v.is_floating_point()} == {torch.float32}
    rng = np.random.default_rng(0)
    inputs = {"depth_encoder": (torch.from_numpy(
        rng.uniform(0, 1, (2, 64, 64, 1)).astype(np.float32)),)}
    if policy_name == "MapCMAPolicy":
        inputs["map_encoder"] = tuple(torch.from_numpy(
            rng.integers(0, k, (2, 64, 64)).astype(np.uint8)) for k in (2, 13))
    else:
        inputs["rgb_encoder"] = (torch.from_numpy(
            rng.integers(0, 256, (2, 64, 64, 3)).astype(np.uint8)),)
    for name, args in inputs.items():
        encoder = getattr(policy.net, name)
        seen = set()
        hooks = [m.register_forward_pre_hook(
            lambda m, inp: seen.add((inp[0].dtype, m.weight.dtype)))
            for m in encoder.modules() if isinstance(m, torch.nn.Conv2d)]
        with torch.no_grad():
            want = encoder(*args)
            seen.clear()
            got = encoder(*args, dtype=torch.bfloat16)
        for hook in hooks:
            hook.remove()
        assert seen == {(torch.bfloat16, torch.bfloat16)}, name
        assert got.dtype == torch.float32 and got.shape == want.shape
        err = float((got - want).abs().max() / want.abs().max())
        assert 1e-4 < err < 0.1, (name, err)
