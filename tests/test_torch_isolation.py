"""The port stands alone: it imports neither JAX nor the JAX package, it
refuses to fall back to the CPU when a card was asked for, and its kernel
wrappers take the plain PyTorch version only for CPU tensors."""

import ast
import os
import pkgutil
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import ivlnce_tpu_torch
from ivlnce_tpu_torch.ops import geometry as G
from ivlnce_tpu_torch.ops import kernels
from ivlnce_tpu_torch.ops import scatter as S
from ivlnce_tpu_torch.utils.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "ivlnce_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "optax", "orbax", "flax", "ivlnce_tpu")


def _port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(ivlnce_tpu_torch.__path__,
                                              "ivlnce_tpu_torch.")
    )


def test_every_module_imports_without_jax_or_the_jax_package():
    blocker = "; ".join(f"sys.modules[{m!r}] = None"
                        for m in FORBIDDEN[:-1])
    code = (
        "import importlib, sys\n"
        f"{blocker}\n"
        f"for name in {_port_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'ivlnce_tpu'\n"
        "             or m.startswith('ivlnce_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def _imported_names(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_source_names_a_forbidden_import():
    """Also the imports inside functions, which importing cannot reach."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for path in files:
        for name in _imported_names(path):
            top = name.split(".")[0]
            assert top not in FORBIDDEN, f"{path} imports {name}"


@pytest.mark.parametrize("device", [None, "cuda", "cuda:0"])
def test_device_resolver_refuses_a_missing_card(device):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(device)


def test_device_resolver_gives_the_cpu_when_asked():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("mps")


def test_entry_point_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run(
        [sys.executable, "-m", "ivlnce_tpu_torch.run", "--run-type", "eval",
         "--exp-config", "configs/fake/map_cma_eval_iterative.yaml",
         "LOG_FILE", os.devnull],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr


def test_entry_point_refuses_a_missing_card_to_train():
    """``--run-type train`` too: no card and no ``--device cpu``."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run(
        [sys.executable, "-m", "ivlnce_tpu_torch.run", "--run-type", "train",
         "--exp-config", "configs/fake/map_cma_train_tf.yaml",
         "LOG_FILE", os.devnull],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr


def test_inference_run_type_reaches_the_trainer(tmp_path, monkeypatch):
    """``--run-type inference`` is accepted and calls the trainer's
    ``inference()``, which raises ``NotImplementedError`` as the JAX
    package's does."""
    from ivlnce_tpu_torch import run
    from ivlnce_tpu_torch.trainers.base_trainer import BaseVLNCETrainer

    called = []
    inference = BaseVLNCETrainer.inference

    def recording(self):
        called.append(type(self).__name__)
        return inference(self)

    monkeypatch.setattr(BaseVLNCETrainer, "inference", recording)
    assert "inference" in run.RUN_TYPES
    config = os.path.join(REPO, "configs/fake/map_cma_eval_iterative.yaml")
    opts = ["LOG_FILE", str(tmp_path / "log")]
    for key in ("CHECKPOINT_FOLDER", "RESULTS_DIR", "TENSORBOARD_DIR"):
        opts += [key, str(tmp_path / key.lower())]
    with pytest.raises(NotImplementedError):
        run.run_exp(config, "inference", opts, device="cpu")
    assert called == ["IterativeCollectionDaggerTrainer"]
    with pytest.raises(ValueError, match="unknown run type"):
        run.run_exp(config, "serve", opts, device="cpu")


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def _small_step(rng, b=2, hw=8, g=64):
    from ivlnce_tpu_torch.mapping import mapper as M
    from ivlnce_tpu_torch.mapping.camera import CameraParameters

    params = M.MapperParams(CameraParameters(1.2, (hw, hw), 0.1), 3.2, 3.2,
                            0.1, grid_cells=g, window_cells=48)
    state = M.init_state(b, g, "cpu")
    depth = torch.from_numpy(rng.uniform(0, 0.5, (b, hw, hw)).astype(
        np.float32))
    sem = torch.from_numpy(rng.integers(0, 13, (b, hw, hw)).astype(np.uint8))
    pose = np.array([[0.0, 1.25, 0.0]] * b, np.float32)
    inp = M.step_inputs(params, state, depth, sem, pose,
                        np.zeros(b, np.float32), np.zeros(b, np.float32),
                        np.ones(b, np.float32))
    consts = (M.FRAME_DEPTH_MIN, M.FRAME_DEPTH_MAX, M.DEPTH_SCALE_METERS,
              params.half_res)
    return params, state, inp, consts


def test_wrappers_take_the_plain_version_on_cpu_tensors(rng):
    params, state, inp, consts = _small_step(rng)
    plain = (state.word.clone(), state.aux.clone(), state.dropped.clone())
    before = (S.launches.accumulate, S.launches.rasterize)
    S.accumulate(state.word, state.aux, state.dropped, inp.depth,
                 inp.semantics, inp.lane_acc, inp.origin, inp.rays_x,
                 inp.rays_y, *consts)
    S.accumulate_plain(*plain, inp.depth, inp.semantics, inp.lane_acc,
                       inp.origin, inp.rays_x, inp.rays_y, *consts)
    for a, b in zip((state.word, state.aux, state.dropped), plain):
        assert torch.equal(a, b)
    rargs = (inp.start, inp.origin, inp.lane_ras, params.window_cells,
             params.map_dims, params.half_res)
    occ, sem = S.rasterize(state.word, state.aux, *rargs)
    occ_p, sem_p = S.rasterize_plain(state.word, state.aux, *rargs)
    assert torch.equal(occ, occ_p) and torch.equal(sem, sem_p)
    assert int(occ.sum()) > 0
    # the counters count kernel launches only
    assert (S.launches.accumulate, S.launches.rasterize) == before


def test_wrappers_check_their_arguments(rng):
    params, state, inp, consts = _small_step(rng)
    with pytest.raises(TypeError, match="depth"):
        S.accumulate(state.word, state.aux, state.dropped, inp.depth.double(),
                     inp.semantics, inp.lane_acc, inp.origin, inp.rays_x,
                     inp.rays_y, *consts)
    with pytest.raises(ValueError, match="contiguous"):
        S.rasterize(state.word.transpose(1, 2), state.aux, inp.start,
                    inp.origin, inp.lane_ras, params.window_cells,
                    params.map_dims, params.half_res)
    with pytest.raises(ValueError, match="window"):
        S.rasterize(state.word, state.aux, inp.start, inp.origin,
                    inp.lane_ras, 2048, params.map_dims, params.half_res)


def test_known_load_launcher_runs_plain_on_cpu_tensors(rng):
    """K3's launcher on CPU tensors runs the plain version, builds nothing
    and counts no launch; a tensor of another device or dtype raises
    before anything is built."""
    from ivlnce_tpu_torch.mapping import mapper as M

    xyz = torch.from_numpy(rng.uniform(-0.3, 0.3, (1, 8, 3)).astype(
        np.float32))
    args = (torch.tensor([1], dtype=torch.int32),
            torch.tensor([[-8, -8]], dtype=torch.int32), xyz,
            torch.from_numpy(rng.integers(0, 13, (1, 8)).astype(np.uint8)),
            torch.tensor([8], dtype=torch.int32), 0.05)
    states = [M.init_state(2, 16, "cpu") for _ in range(2)]
    before = S.launches.known_load
    S.known_load(states[0].word, states[0].aux, states[0].dropped, *args)
    S.known_load_plain(states[1].word, states[1].aux, states[1].dropped,
                       *args)
    assert torch.equal(states[0].word, states[1].word)
    assert torch.equal(states[0].aux, states[1].aux)
    assert int((states[0].word[1] != S.EMPTY_WORD).sum()) > 0
    meta = M.init_state(2, 16, "meta")
    with pytest.raises(ValueError, match="unsupported device"):
        S.known_load(meta.word, meta.aux, meta.dropped, *args)
    with pytest.raises(TypeError, match="rows"):
        S.known_load(states[0].word, states[0].aux, states[0].dropped,
                     args[0].long(), *args[1:])
    assert kernels._lib is None
    assert S.launches.known_load == before


def test_kernel_build_needs_nvcc_and_happens_only_when_called():
    assert kernels._lib is None  # nothing was built at import
    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is installed here")
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.build()


def test_float_keys_round_trip_and_keep_order(rng):
    x = np.concatenate([rng.normal(size=500).astype(np.float32) * 100,
                        np.array([-np.inf, np.inf, 0.0, -0.0], np.float32)])
    t = torch.from_numpy(x)
    keys = S.sortable_from_float(t)
    assert torch.equal(S.float_from_sortable(keys).view(torch.int32),
                       t.view(torch.int32))
    # ordered by key, the floats never decrease (-0.0 keys below 0.0)
    order = np.argsort(keys.numpy(), kind="stable")
    assert (np.diff(x[order]) >= 0).all()
    assert G.f32_reciprocal(0.05) == float(np.float32(1) / np.float32(0.05))


TRAINERS = ("dagger", "iterative_collection_dagger", "iterative_dagger")


def _trainer(name, tmp_path, *opts,
             config_path="configs/fake/map_cma_eval_iterative.yaml"):
    from ivlnce_tpu_torch.config import get_config
    from ivlnce_tpu_torch.run import register_all
    from ivlnce_tpu_torch.utils.registry import registry

    register_all()
    config = get_config(
        config_path,
        ["TRAINER_NAME", name,
         "CHECKPOINT_FOLDER", str(tmp_path / "ckpts"),
         "RESULTS_DIR", str(tmp_path / "results"), *opts])
    return registry.get_trainer(config.TRAINER_NAME)(config, "cpu")


@pytest.mark.parametrize("name", TRAINERS)
def test_trainer_names_resolve_to_eval_trainers(name, tmp_path):
    from ivlnce_tpu_torch.trainers.base_trainer import BaseVLNCETrainer
    from ivlnce_tpu_torch.utils.registry import registry

    trainer = _trainer(name, tmp_path)
    assert isinstance(trainer, BaseVLNCETrainer)
    # the base class itself is registered under no name
    assert type(trainer) is not BaseVLNCETrainer
    assert registry.get_trainer(name) is type(trainer)


# what each trainer's train() refuses before any collection: more than
# one device
REFUSALS = {
    "dagger": (("TPU.data_parallel_devices", "2"), "one device"),
    "iterative_collection_dagger": (("TPU.data_parallel_devices", "2"),
                                    "one device"),
    "iterative_dagger": (("TPU.data_parallel_devices", "2"), "one device"),
}


@pytest.mark.parametrize("name", TRAINERS)
def test_training_waits_for_its_slice(name, tmp_path, monkeypatch):
    from ivlnce_tpu_torch.trainers.dagger_trainer import DaggerTrainer

    def no_collection(self, *args, **kwargs):
        raise AssertionError("collection ran before the refusal")

    monkeypatch.setattr(DaggerTrainer, "_update_dataset", no_collection)
    opts, message = REFUSALS[name]
    trainer = _trainer(name, tmp_path, *opts, "IL.DAGGER.lmdb_features_dir",
                       str(tmp_path / "traj.lmdb"))
    with pytest.raises(NotImplementedError, match=message):
        trainer.train()
    assert not os.path.exists(tmp_path / "traj.lmdb")


def test_eval_writes_one_video_per_episode(tmp_path, caplog):
    """A port eval with ``VIDEO_OPTION ['disk']`` (the MapCMA episodic
    eval, 64x64 sensors, hidden 64, 4-step episodes) writes one video per
    evaluated episode."""
    import re

    from ivlnce_tpu_torch.trainers.base_trainer import save_checkpoint
    from ivlnce_tpu_torch.utils.registry import registry

    ckpt = str(tmp_path / "ckpts" / "ckpt.0.pth")
    opts = ["VIDEO_OPTION", "['disk']", "VIDEO_DIR", str(tmp_path / "videos"),
            "TENSORBOARD_DIR", str(tmp_path / "tb"),
            "EVAL_CKPT_PATH_DIR", ckpt, "NUM_ENVIRONMENTS", "2",
            "EVAL.EPISODE_COUNT", "2", "MODEL.STATE_ENCODER.hidden_size",
            "64", "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", "4"]
    for sensor in ("DEPTH_SENSOR", "RGB_SENSOR"):
        for side in ("HEIGHT", "WIDTH"):
            opts += [f"TASK_CONFIG.SIMULATOR.{sensor}.{side}", "64"]
    trainer = _trainer("dagger", tmp_path, *opts,
                       config_path="configs/fake/map_cma_eval_episodic.yaml")
    torch.manual_seed(0)
    policy = registry.get_policy("MapCMAPolicy").from_config(
        trainer.config, {"depth_hw": 64, "map_hw": 64})
    save_checkpoint(policy, trainer.config, ckpt)
    with caplog.at_level("INFO", logger="ivlnce_tpu_torch"):
        trainer.eval()
    episodes = int(re.search(r"Episodes evaluated: (\d+)",
                             caplog.text).group(1))
    videos = sorted(os.listdir(tmp_path / "videos"))
    assert episodes >= 2
    assert len(videos) == episodes
    assert len({v.split("-ckpt=")[0] for v in videos}) == episodes
    assert all(v.startswith("episode=") for v in videos)


@pytest.mark.parametrize("module", (
    "models/resnet.py", "models/instruction_encoder.py", "models/cma.py",
    "models/policy.py", "models/convert.py", "trainers/base_trainer.py",
    "trainers/dagger_trainer.py",
    "trainers/iterative_collection_dagger_trainer.py",
    "trainers/iterative_dagger_trainer.py", "trainers/tour_dataset.py",
    "run.py",
    "envs/habitat_backend.py", "tasks/maps.py", "utils/viz.py",
    "utils/profiling.py", "models/checkpoint_io.py",
    "mapping/obs_transforms.py",
    # the training slice
    "trainers/trajectory_store.py",
    "utils/prefetch.py", "utils/tb.py", "models/map_encoder.py",
    "models/rnn.py",
))
def test_latent_and_episodic_modules_stand_alone(module):
    """The modules of the LatentCMA and episodic evals, each on its own:
    no import of JAX or of the JAX package, at module level or inside a
    function."""
    path = os.path.join(PORT, module)
    name = "ivlnce_tpu_torch." + module[:-3].replace("/", ".")
    assert name in _port_modules()  # so the import test covers it too
    for imported in _imported_names(path):
        assert imported.split(".")[0] not in FORBIDDEN, imported
