"""The port's DAgger training end to end on the CPU, through its entry
point (``ivlnce_tpu_torch.run.run_exp(..., "train", device="cpu")``), for
both training configs at 64x64 sensors (the scale of
``tests/test_e2e_trainers.py``): MapCMA teacher forcing with the
iterative-collection trainer and its GT-semantics mapper, and LatentCMA
with the ``dagger`` trainer. Each run writes a trajectory store, a
``ckpt.0.pth`` holding the optimizer state, epoch and step, and finite
losses; the port's iterative eval then evaluates that checkpoint and
writes its stats."""

import glob
import json
import math
import os
import random

import pytest
import torch

from ivlnce_tpu_torch.run import run_exp
from ivlnce_tpu_torch.trainers.base_trainer import load_checkpoint
from ivlnce_tpu_torch.trainers.trajectory_store import TrajectoryStore
from tests.test_torch_eval import _tiny_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {
    "map_cma": "configs/fake/map_cma_train_tf.yaml",
    "latent_cma": "configs/fake/latent_cma_train.yaml",
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Thousands of small ops: with one intra-op thread they do not
    contend with the other test processes for the cores (six workers
    each spinning a full thread pool ran these files over 10x slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sensor_opts():
    opts = []
    for sensor in ("DEPTH_SENSOR", "RGB_SENSOR"):
        for side in ("HEIGHT", "WIDTH"):
            opts += [f"TASK_CONFIG.SIMULATOR.{sensor}.{side}", "64"]
    return opts


@pytest.fixture(scope="module", params=list(CONFIGS))
def trained(request, tmp_path_factory):
    """One collect + train cycle of the config, then an iterative eval of
    its checkpoint on a cut val_seen (one two-episode tour per lane)."""
    os.chdir(REPO)
    name = request.param
    root = tmp_path_factory.mktemp(name)
    opts = [
        "NUM_ENVIRONMENTS", "2",
        "CHECKPOINT_FOLDER", str(root / "ckpts"),
        "TENSORBOARD_DIR", str(root / "tb"),
        "RESULTS_DIR", str(root / "results"),
        "LOG_FILE", str(root / "train.log"),
        "IL.DAGGER.update_size", "3",
        "IL.DAGGER.lmdb_features_dir", str(root / "traj.lmdb"),
        "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", "12",
        *_sensor_opts(),
    ]
    random.seed(0)
    trainer = run_exp(CONFIGS[name], "train", opts, device="cpu")

    ds = str(root / "ds")
    _tiny_dataset(ds)
    eval_opts = [
        "NUM_ENVIRONMENTS", "2",
        "TRAINER_NAME", "iterative_dagger",
        "ENV_NAME", "VLNCEIterativeEnv",
        "TASK_CONFIG.ENVIRONMENT.ITERATIVE.ENABLED", "True",
        "EVAL_CKPT_PATH_DIR", str(root / "ckpts" / "ckpt.0.pth"),
        "CHECKPOINT_FOLDER", str(root / "eval_ckpts"),
        "TENSORBOARD_DIR", str(root / "eval_tb"),
        "RESULTS_DIR", str(root / "results"),
        "LOG_FILE", str(root / "eval.log"),
        "EVAL.ITERATIVE_GT_PATHS", os.path.join(ds, "gt_ndtw.json"),
        "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", "6",
        "TASK_CONFIG.DATASET.DATA_PATH",
        os.path.join(ds, "{split}", "{split}.json.gz"),
        "TASK_CONFIG.DATASET.TOURS_FILE", os.path.join(ds, "tours.json"),
        "TASK_CONFIG.TASK.NDTW.GT_PATH",
        os.path.join(ds, "{split}", "{split}_gt.json.gz"),
        *_sensor_opts(),
    ]
    random.seed(0)
    evaluator = run_exp(CONFIGS[name], "eval", eval_opts, device="cpu")
    return name, root, trainer, evaluator


def test_training_writes_a_store_checkpoint_and_losses(trained):
    name, root, trainer, _ = trained
    with TrajectoryStore(str(root / "traj.lmdb")) as store:
        # lanes that end an episode in the same step are all stored
        records = store.count()
        assert 3 <= records <= 4
        obs, prev, oracle = store.get(0)
        assert len(prev) == len(oracle) > 0
        assert "depth_features" in obs and "depth" not in obs
        if name == "map_cma":
            assert {"occupancy_map", "semantic_map"} <= set(obs)
            assert "rgb" not in obs and "rgb_features" not in obs
        else:
            assert "rgb_features" in obs and "rgb" not in obs
            assert "occupancy_map" not in obs
    # batches of 2, the last one dropped when incomplete
    assert len(trainer.losses) == trainer.train_steps == records // 2
    for loss, action, aux in trainer.losses:
        assert math.isfinite(loss) and math.isfinite(action)
        assert math.isfinite(aux)
        assert abs(loss - (action + aux)) <= 1e-6 * abs(loss)
    assert (trainer.losses[0][2] > 0) == (name == "map_cma")
    ckpt = load_checkpoint(str(root / "ckpts" / "ckpt.0.pth"))
    assert (ckpt["dagger_it"], ckpt["epoch"], ckpt["step_id"]) == (
        0, 0, trainer.train_steps)
    assert ckpt["optim_state"]["state"]
    policy_name = trainer.config.MODEL.policy_name
    assert ckpt["config"]["MODEL"]["policy_name"] == policy_name
    state = trainer.policy.state_dict()
    for k, v in ckpt["state_dict"].items():
        assert torch.equal(v, state[k]), k
    assert glob.glob(str(root / "tb" / "events.out.tfevents.*"))
    # every collection step ran the mapper once (K1, K2's plain versions)
    assert trainer.collection_steps > 0
    assert bool(trainer.obs_transforms) == (name == "map_cma")


def test_the_ports_eval_reads_the_trained_checkpoint(trained):
    name, root, trainer, evaluator = trained
    with open(root / "results" / "iterative_stats_ckpt_0_val_seen.json") as f:
        stats = json.load(f)
    assert stats and all(math.isfinite(v) for v in stats.values())
    assert evaluator.episodes_evaluated >= 2
    assert type(evaluator.policy).__name__ == type(trainer.policy).__name__
    state = trainer.policy.state_dict()
    for k, v in evaluator.policy.state_dict().items():
        assert torch.equal(v, state[k]), k
