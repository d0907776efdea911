"""The port's episodic evaluation and its LatentCMA tour evaluation
against the JAX package's, end to end (FakeSim, 2 lanes, 64x64 sensors,
the same checkpoint weights on both sides): every step's actions
identical and the stats JSONs equal, for

(a) MapCMA episodic (configs/fake/map_cma_eval_episodic.yaml: the
    GT-semantics mapper with K1/K2's plain versions, the map restarted at
    every episode);
(b) LatentCMA on RxR's precomputed instruction features
    (configs/fake/rxr_eval.yaml);
(c) the LatentCMA tour eval with ``tour_memory_variant`` and
    ``memory_at_end`` through ``iterative_dagger`` (tour-nDTW, per-tour
    stats and DTW data too, with the native DTW on both sides).

``random`` is seeded before each eval: the vector env shuffles scenes
over lanes with it."""

import os
import pickle
import random

import jax
import numpy as np
import torch

import ivlnce_tpu.envs.env  # noqa: F401  (registration side effects)
import ivlnce_tpu.mapping.obs_transforms  # noqa: F401
import ivlnce_tpu.models  # noqa: F401
import ivlnce_tpu.tasks  # noqa: F401
import ivlnce_tpu.trainers  # noqa: F401
from ivlnce_tpu.config import get_config as jax_config
from ivlnce_tpu.utils import viz as jax_viz
from ivlnce_tpu.utils.registry import registry as jax_registry
from ivlnce_tpu_torch.config import get_config as torch_config
from ivlnce_tpu_torch.models.convert import params_from_jax
from ivlnce_tpu_torch.run import register_all
from ivlnce_tpu_torch.utils import viz as torch_viz
from ivlnce_tpu_torch.utils.registry import registry as torch_registry
from tests.test_torch_eval import (  # noqa: F401 (a fixture)
    CONFIG,
    _configure,
    _load,
    _tiny_dataset,
    one_torch_thread,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPISODIC = "configs/fake/map_cma_eval_episodic.yaml"
RXR = "configs/fake/rxr_eval.yaml"
LATENT_TOUR = ["MODEL.policy_name", "LatentCMAPolicy",
               "RL.POLICY.OBS_TRANSFORMS.ENABLED_TRANSFORMS", "[]",
               "TRAINER_NAME", "iterative_dagger",
               "MODEL.tour_memory_variant", "True",
               "MODEL.memory_at_end", "True"]


def _rxr_configure(config, root, side):
    config = config.clone()
    config.defrost()
    out = os.path.join(root, side)
    config.NUM_ENVIRONMENTS = 2
    config.CHECKPOINT_FOLDER = os.path.join(out, "ckpts")
    config.TENSORBOARD_DIR = os.path.join(out, "tb")
    config.RESULTS_DIR = os.path.join(out, "results")
    config.LOG_FILE = os.path.join(out, "log")
    config.EVAL_CKPT_PATH_DIR = os.path.join(out, "ckpts", "ckpt.0.pth")
    config.MODEL.STATE_ENCODER.hidden_size = 64
    # all four episodes (two languages), two per lane
    config.EVAL.LANGUAGES = ["*"]
    t = config.TASK_CONFIG
    t.ENVIRONMENT.MAX_EPISODE_STEPS = 6
    for sensor in (t.SIMULATOR.DEPTH_SENSOR, t.SIMULATOR.RGB_SENSOR):
        sensor.HEIGHT = 64
        sensor.WIDTH = 64
    config.freeze()
    os.makedirs(config.CHECKPOINT_FOLDER, exist_ok=True)
    return config


def _eval_pair(tmp_path, monkeypatch, config_path, opts, configure, seed,
               episode_count=None, videos=False):
    """Both evals from one checkpoint of weights from ``seed`` (chosen so
    that the random policy takes more than one kind of action); returns
    the two configs and trainers, the port's actions per step and its
    video frames by episode. With
    ``videos``, both evals write ``VIDEO_OPTION ['disk']`` videos and the
    frames each passes to ``generate_video`` must be identical."""
    os.chdir(REPO)
    root = str(tmp_path)
    ds = os.path.join(root, "ds")
    _tiny_dataset(ds)  # two episodes per lane
    register_all()
    cfgs = {}
    for side, get in (("jax", jax_config), ("torch", torch_config)):
        cfg = configure(get(config_path, opts), ds, side)
        cfg.defrost()
        cfg.IL.DAGGER.lmdb_features_dir = os.path.join(root, side, "traj")
        if episode_count is not None:
            cfg.EVAL.EPISODE_COUNT = episode_count
        if videos:
            cfg.VIDEO_OPTION = ["disk"]
            cfg.VIDEO_DIR = os.path.join(root, side, "videos")
        cfg.freeze()
        cfgs[side] = cfg
    jcfg, tcfg = cfgs["jax"], cfgs["torch"]

    info = {"depth_hw": 64, "map_hw": 64}
    jpol = jax_registry.get_policy(jcfg.MODEL.policy_name).from_config(
        jcfg, info)
    params = jax.device_get(jpol.init_params(jax.random.PRNGKey(seed)))
    with open(jcfg.EVAL_CKPT_PATH_DIR, "wb") as f:
        pickle.dump({"params": params, "config": jcfg.to_dict()}, f)
    torch.save({"state_dict": params_from_jax(params),
                "config": tcfg.to_dict()}, tcfg.EVAL_CKPT_PATH_DIR)

    actions = {"jax": [], "torch": []}
    frames = {"jax": {}, "torch": {}}
    for side, module in (("jax", jax_viz), ("torch", torch_viz)):
        def capture(*args, _side=side, _write=module.generate_video,
                    **kwargs):
            frames[_side][kwargs["episode_id"]] = list(kwargs["images"])
            return _write(*args, **kwargs)

        monkeypatch.setattr(module, "generate_video", capture)
    # the JAX trainer's own initialisation (eager, tens of seconds for the
    # ResNet-50s) takes these weights, which the checkpoint overwrites
    monkeypatch.setattr(type(jpol), "init_params", lambda self, key: params)
    jt = jax_registry.get_trainer(jcfg.TRAINER_NAME)(jcfg)
    j_step = jt._policy_step

    def jax_step(*args, **kwargs):
        out, batch = j_step(*args, **kwargs)
        actions["jax"].append(np.asarray(out.actions).ravel().tolist())
        return out, batch

    jt._policy_step = jax_step
    random.seed(0)
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
    assert actions["torch"] == actions["jax"]
    assert len(actions["torch"]) >= 4
    assert len({a for step in actions["torch"] for a in step}) > 1
    assert frames["torch"].keys() == frames["jax"].keys()
    for ep, images in frames["jax"].items():
        assert len(frames["torch"][ep]) == len(images), ep
        for t_img, j_img in zip(frames["torch"][ep], images):
            np.testing.assert_array_equal(t_img, j_img)
    if videos:
        assert len(frames["torch"]) == len(os.listdir(tcfg.VIDEO_DIR))
    return jcfg, tcfg, jt, tt, actions["torch"], frames["torch"]


def _assert_stats_equal(jcfg, tcfg, pattern):
    jstats = _load(jcfg.RESULTS_DIR, pattern)
    tstats = _load(tcfg.RESULTS_DIR, pattern)
    assert tstats == jstats
    for key in ("success", "spl", "ndtw", "distance_to_goal"):
        assert np.isfinite(tstats[key]), key
    return tstats


def test_mapcma_episodic_eval_matches_jax(tmp_path, monkeypatch,
                                          one_torch_thread):
    # EVAL.EPISODE_COUNT 3 of the 4 episodes; each lane's second episode
    # runs over a map restarted at the boundary. Videos on both sides:
    # every frame, the top-down map and the egocentric map panels
    # included, identical
    jcfg, tcfg, _, tt, _, frames = _eval_pair(
        tmp_path, monkeypatch, EPISODIC, None, _configure, 5,
        episode_count=3, videos=True)
    _assert_stats_equal(jcfg, tcfg, "stats_ckpt_0_val_seen.json")
    assert type(tt.obs_transforms[0]).__name__ == (
        "GTSemanticsIterativeMapper")
    for images in frames.values():
        top = images[0][:64]
        # the 64-px RGB and depth views, then the top-down map beside them
        assert (top != 255).any(axis=(0, 2))[128:].any()
        # the occupancy and semantic panels (4x the 64-cell map) below
        assert images[0].shape[0] >= 64 + 4 * 64


def test_rxr_episodic_eval_matches_jax(tmp_path, monkeypatch,
                                       one_torch_thread):
    jcfg, tcfg, jt, tt, steps, _ = _eval_pair(tmp_path, monkeypatch, RXR,
                                              None, _rxr_configure, 3)
    _assert_stats_equal(jcfg, tcfg, "stats_ckpt_0_val_seen.json")
    assert tt._txt_cache_tokens.shape[1:] == (512, 768)
    assert jt._txt_cache_tokens.shape == tt._txt_cache_tokens.shape
    encoder = tt.policy.net.instruction_encoder
    assert encoder.embedding_layer is None
    assert not any("embedding_layer" in k for k in tt.policy.state_dict())
    assert encoder.encoder_rnn.input_size == 768
    # encoded at the start and again only when a lane's episode changes
    # or a lane pauses, not at every step
    assert 1 < tt.instruction_encodes <= 4 < len(steps)


def test_latent_tour_eval_matches_jax(tmp_path, monkeypatch,
                                      one_torch_thread):
    jcfg, tcfg, _, tt, _, _ = _eval_pair(tmp_path, monkeypatch, CONFIG,
                                         LATENT_TOUR, _configure, 1)
    assert tt.obs_transforms == []
    assert tt.policy.num_recurrent_layers == 3
    stats = _assert_stats_equal(jcfg, tcfg,
                                "iterative_stats_ckpt_0_val_seen.json")
    assert np.isfinite(stats["tndtw"])
    for pattern in ("iterative_all_stats_ckpt_0_val_seen.json",
                    "dtw_data_ckpt_0_val_seen.json"):
        assert _load(tcfg.RESULTS_DIR, pattern) == _load(jcfg.RESULTS_DIR,
                                                         pattern)
