"""The port's iterative evaluation against the JAX package's, end to end
(the scenario of tests/test_e2e_trainers.py's iterative eval: FakeSim,
2 lanes, 64x64 depth): the same checkpoint weights on both sides, every
step's actions identical, and the stats JSON (success, SPL, nDTW, ...)
and tour-nDTW equal.

The dataset is cut to one tour of two episodes per lane, so each lane
crosses an episode boundary inside its tour with a persistent map. Both
sides compute tour-nDTW with their native C++ DTW, built from the same
source, so the values are equal (``tests/test_torch_dtw.py`` holds the
numpy DTWs too)."""

import glob
import gzip
import json
import os
import pickle
import random
import shutil

import jax
import numpy as np
import pytest
import torch

import ivlnce_tpu.envs.env  # noqa: F401  (registration side effects)
import ivlnce_tpu.mapping.obs_transforms  # noqa: F401
import ivlnce_tpu.models  # noqa: F401
import ivlnce_tpu.tasks  # noqa: F401
import ivlnce_tpu.trainers  # noqa: F401
from ivlnce_tpu.config import get_config as jax_config
from ivlnce_tpu.utils.registry import registry as jax_registry
from ivlnce_tpu_torch.config import get_config as torch_config
from ivlnce_tpu_torch.run import register_all
from ivlnce_tpu_torch.utils.registry import registry as torch_registry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = "configs/fake/map_cma_eval_iterative.yaml"
FAKE = os.path.join(REPO, "data", "datasets", "fake")
# two tours of two episodes whose starts lie close together, so the
# oracle's walks between episodes stay short; with their ids in the
# fake dataset's tour-nDTW ground truth (gt_ndtw.json)
TOURS = {"fakeval_seen0": [["1", "2"]], "fakeval_seen1": [["14", "15"]]}
TOUR_GT_IDS = ("0", "3")


@pytest.fixture
def one_torch_thread():
    """The eval runs thousands of tiny ops: with one intra-op thread they
    do not contend with other test processes for the cores (several
    workers each spinning a full thread pool ran this test 8x slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tiny_dataset(root):
    """val_seen cut to the TOURS episodes, with their GT files."""
    keep = {e for tours in TOURS.values() for t in tours for e in t}
    os.makedirs(os.path.join(root, "val_seen"), exist_ok=True)
    with gzip.open(os.path.join(FAKE, "val_seen", "val_seen.json.gz"),
                   "rt") as f:
        data = json.load(f)
    data["episodes"] = [e for e in data["episodes"]
                        if str(e["episode_id"]) in keep]
    with gzip.open(os.path.join(root, "val_seen", "val_seen.json.gz"),
                   "wt") as f:
        json.dump(data, f)
    with gzip.open(os.path.join(FAKE, "val_seen", "val_seen_gt.json.gz"),
                   "rt") as f:
        gt = json.load(f)
    with gzip.open(os.path.join(root, "val_seen", "val_seen_gt.json.gz"),
                   "wt") as f:
        json.dump({k: v for k, v in gt.items() if k in keep}, f)
    with open(os.path.join(root, "tours.json"), "w") as f:
        json.dump({"val_seen": TOURS}, f)
    with open(os.path.join(FAKE, "gt_ndtw.json")) as f:
        tour_gt = json.load(f)
    with open(os.path.join(root, "gt_ndtw.json"), "w") as f:
        json.dump({"val_seen": {
            str(i): [p for p in tour_gt["val_seen"][k]
                     if p["episode_id"] in keep]
            for i, k in enumerate(TOUR_GT_IDS)}}, f)


def _configure(config, root, side):
    config = config.clone()
    config.defrost()
    out = os.path.join(root, side)
    config.NUM_ENVIRONMENTS = 2
    config.CHECKPOINT_FOLDER = os.path.join(out, "ckpts")
    config.TENSORBOARD_DIR = os.path.join(out, "tb")
    config.RESULTS_DIR = os.path.join(out, "results")
    config.LOG_FILE = os.path.join(out, "log")
    config.EVAL_CKPT_PATH_DIR = os.path.join(out, "ckpts", "ckpt.0.pth")
    config.EVAL.EPISODE_COUNT = 2
    config.EVAL.ITERATIVE_GT_PATHS = os.path.join(root, "gt_ndtw.json")
    config.MODEL.STATE_ENCODER.hidden_size = 64
    config.TPU.world_grid_cells = 256
    t = config.TASK_CONFIG
    t.ENVIRONMENT.MAX_EPISODE_STEPS = 6
    t.DATASET.DATA_PATH = os.path.join(root, "{split}", "{split}.json.gz")
    t.DATASET.TOURS_FILE = os.path.join(root, "tours.json")
    t.TASK.NDTW.GT_PATH = os.path.join(root, "{split}", "{split}_gt.json.gz")
    for sensor in (t.SIMULATOR.DEPTH_SENSOR, t.SIMULATOR.RGB_SENSOR):
        sensor.HEIGHT = 64
        sensor.WIDTH = 64
    config.freeze()
    os.makedirs(config.CHECKPOINT_FOLDER, exist_ok=True)
    return config


def _load(results, pattern):
    files = glob.glob(os.path.join(results, pattern))
    assert len(files) == 1, (pattern, files)
    with open(files[0]) as f:
        return json.load(f)


def test_iterative_eval_matches_jax(tmp_path, one_torch_thread):
    os.chdir(REPO)
    root = str(tmp_path)
    _tiny_dataset(os.path.join(root, "ds"))
    ds = os.path.join(root, "ds")
    jcfg = _configure(jax_config(CONFIG), ds, "jax")
    register_all()
    tcfg = _configure(torch_config(CONFIG), ds, "torch")
    tcfg.defrost()
    tcfg.TPU.profile_dir = os.path.join(root, "trace")
    tcfg.freeze()

    info = {"depth_hw": 64, "map_hw": 64}
    jpol = jax_registry.get_policy("MapCMAPolicy").from_config(jcfg, info)
    params = jax.device_get(jpol.init_params(jax.random.PRNGKey(3)))
    with open(jcfg.EVAL_CKPT_PATH_DIR, "wb") as f:
        pickle.dump({"params": params, "config": jcfg.to_dict()}, f)
    # the port evaluates the JAX package's pickle itself
    shutil.copy(jcfg.EVAL_CKPT_PATH_DIR, tcfg.EVAL_CKPT_PATH_DIR)

    actions = {"jax": [], "torch": []}
    jt = jax_registry.get_trainer(jcfg.TRAINER_NAME)(jcfg)
    j_step = jt._policy_step

    def jax_step(*args, **kwargs):
        out, batch = j_step(*args, **kwargs)
        actions["jax"].append(np.asarray(out.actions).ravel().tolist())
        return out, batch

    jt._policy_step = jax_step
    random.seed(0)  # the vector env shuffles scenes over lanes
    jt.eval()

    tt = torch_registry.get_trainer(tcfg.TRAINER_NAME)(tcfg, "cpu")
    t_step = tt._policy_step

    def torch_step(*args, **kwargs):
        acts, rnn = t_step(*args, **kwargs)
        actions["torch"].append(acts.ravel().tolist())
        return acts, rnn

    tt._policy_step = torch_step
    random.seed(0)
    tt.eval()

    assert len(actions["torch"]) > 10
    assert actions["torch"] == actions["jax"]
    pattern = "iterative_stats_ckpt_0_val_seen.json"
    jstats = _load(jcfg.RESULTS_DIR, pattern)
    tstats = _load(tcfg.RESULTS_DIR, pattern)
    assert tstats == jstats
    for key in ("success", "spl", "ndtw", "tndtw"):
        assert np.isfinite(tstats[key]), key
    for pattern in ("iterative_all_stats_ckpt_0_val_seen.json",
                    "dtw_data_ckpt_0_val_seen.json"):
        assert _load(tcfg.RESULTS_DIR, pattern) == _load(jcfg.RESULTS_DIR,
                                                         pattern)
    all_stats = _load(tcfg.RESULTS_DIR,
                      "iterative_all_stats_ckpt_0_val_seen.json")
    assert sum(len(v) for v in all_stats.values()) == 4
    # TPU.profile_dir: one trace of policy steps 3 to 22
    assert tt.policy_steps > 23
    traces = glob.glob(os.path.join(tcfg.TPU.profile_dir, "*.json"))
    assert len(traces) == 1, traces
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert sum(e.get("name") == "policy_step"
               and e.get("cat") == "user_annotation" for e in events) == 20


@pytest.mark.parametrize("device", [None, "cuda"])
def test_trainer_refuses_cuda_without_a_card(tmp_path, device):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    register_all()
    cfg = _configure(torch_config(CONFIG), str(tmp_path), "torch")
    trainer_cls = torch_registry.get_trainer(cfg.TRAINER_NAME)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainer_cls(cfg, device)
