"""The port's tour-BPTT training (the ``iterative_dagger`` trainer)
against the JAX package's, on the CPU:

(a) ``to_constant_bin_number`` and ``TourSampler``: with
    ``rng=RandomState(s)`` the port's sampler gives the JAX sampler's
    batches after ``np.random.seed(s)`` (the cases of
    ``tests/test_tour_sampler.py`` and seeded tour-length maps, with and
    without ``drop_last``); ``TourTrajectoryDataset.batches()`` of both
    packages give equal arrays from one store;
(b) the carried RNN state over three consecutive sampler batches, for
    each memory setting (none, ``tour_memory``, ``tour_memory_variant``):
    the port's ``_update_agent_iterative`` at ``IL.lr 0`` against the JAX
    trainer's, loss terms within 1e-5 relative, carries within 1e-4 of
    their largest |value|, batch 2's gradients (from the carry) as in
    ``tests/test_torch_train.py``; the carry goes in detached;
(c) ``run_exp(tour_cma_train.yaml, "train", device="cpu")`` at 64x64
    sensors with ``TPU.async_checkpointing True``: the tours index at
    store key 0, one train step per sampler batch, the checkpoint (equal
    to a synchronous save of the same state, read by both packages), a
    second ``train()`` on the stored data without collecting, and a
    checkpoint writer's error raised by ``train()``.

No JAX training loop runs: the JAX side of (b) is three calls of its
trainer's ``_update_agent_iterative``, with an optax transformation that
leaves the weights and keeps the gradients as its state (lr 0)."""

import math
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ivlnce_tpu.trainers  # noqa: F401  (registration side effects)
from ivlnce_tpu.config import get_config as jax_config
from ivlnce_tpu.models import checkpoint_io as jcio
from ivlnce_tpu.trainers import tour_dataset as jtd
from ivlnce_tpu.trainers import trajectory_store as jts
from ivlnce_tpu.utils.registry import registry as jax_registry
from ivlnce_tpu_torch.models.convert import params_from_jax
from ivlnce_tpu_torch.run import run_exp
from ivlnce_tpu_torch.trainers import base_trainer as tbt
from ivlnce_tpu_torch.trainers import tour_dataset as ttd
from ivlnce_tpu_torch.trainers.dagger_trainer import DaggerTrainer
from ivlnce_tpu_torch.trainers.trajectory_store import TrajectoryStore
from ivlnce_tpu_torch.utils.registry import registry as torch_registry
from tests.test_torch_train import (
    GRAD_TOL,
    LATENT_CONFIG,
    LOSS_RTOL,
    _assert_grads_match,
    _assert_tree_equal,
    _feature_shapes,
    _opts,
    _pair,
    _record,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOUR_CONFIG = "configs/fake/tour_cma_train.yaml"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Thousands of small ops: with one intra-op thread they do not
    contend with the other test processes for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- (a) the sampler and the batches ------------------------------------------
def _seeded_tours(seed):
    """Seven tours of 1-6 episodes with distinct store keys."""
    rng = np.random.default_rng(seed)
    tours, key = {}, 1
    for i in range(7):
        n = int(rng.integers(1, 7))
        tours[f"tour{i}"] = list(range(key, key + n))
        key += n
    return tours


# the three cases of tests/test_tour_sampler.py (2 lanes), then seeded
# tour-length maps over 3 lanes
SAMPLER_CASES = {
    "full_batches": ({"t1": [0, 1, 2], "t2": [3, 4, 5]}, 2),
    "short_tail": ({"t1": [0, 1, 2, 3], "t2": [4, 5]}, 2),
    "lane_tours": ({"a": [10, 11, 12], "b": [20, 21, 22]}, 2),
    "seeded_1": (_seeded_tours(1), 3),
    "seeded_2": (_seeded_tours(2), 3),
    "seeded_3": (_seeded_tours(3), 3),
}


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("case", list(SAMPLER_CASES))
def test_sampler_equals_the_jax_packages(case, drop_last):
    tours, lanes = SAMPLER_CASES[case]
    weights = {k: len(v) for k, v in tours.items()}
    assert (ttd.to_constant_bin_number(weights, lanes)
            == jtd.to_constant_bin_number(weights, lanes))
    seed = sorted(SAMPLER_CASES).index(case)
    for shuffle in (False, True):
        np.random.seed(seed)
        want = jtd.TourSampler(tours, lanes, shuffle=shuffle,
                               drop_last=drop_last)
        np.random.seed(seed + 100)  # the port's sampler draws from rng
        got = ttd.TourSampler(tours, lanes, shuffle=shuffle,
                              drop_last=drop_last,
                              rng=np.random.RandomState(seed))
        assert got.batched_idxs == want.batched_idxs
        assert got.get_tour_done_idxs() == want.get_tour_done_idxs()
        assert got.get_num_batches() == want.get_num_batches()
        assert list(got) == want.batched_idxs
    if drop_last:
        assert all(len(b) == lanes for b in got.batched_idxs)
    else:
        assert sorted(sum(got.batched_idxs, [])) == sorted(
            sum(tours.values(), []))
    if case == "lane_tours":
        lane_seqs = {tuple(b[i] for b in got) for i in range(2)}
        assert {tuple(sorted(s)) for s in lane_seqs} == {(10, 11, 12),
                                                        (20, 21, 22)}
        assert got.get_tour_done_idxs() == {
            s[0] for s in lane_seqs}


# three tours over 2 lanes: b (3 episodes of 4 steps) fills lane 0, a and
# c (2 each) share lane 1; drop_last keeps 3 batches of T = 4, the last of
# which starts tour c on lane 1 while lane 0 continues tour b
TOURS = {"b": [1, 2, 3], "a": [4, 5], "c": [6, 7]}
LENGTHS = {1: 4, 2: 4, 3: 4, 4: 3, 5: 2, 6: 4, 7: 3}
LANES = 2


def _tour_store(path, feature_shapes, seed=11):
    """The JAX package's store of the TOURS records, the index at key 0."""
    rng = np.random.default_rng(seed)
    with jts.TrajectoryStore(path, writable=True) as store:
        store.put(0, {"tours_to_idxs": TOURS})
        for k, t in LENGTHS.items():
            store.put(k, _record(rng, t, feature_shapes))
        store.sync()
    return path


def _tour_batches(module, path, sampler):
    dataset = module.TourTrajectoryDataset(path, True, 3.2)
    dataset.set_tour_done_idxs(sampler.get_tour_done_idxs())
    try:
        return list(dataset.batches(sampler))
    finally:
        dataset.close()


def test_tour_batches_equal_the_jax_packages(tmp_path):
    path = _tour_store(str(tmp_path / "traj.lmdb"),
                       {"depth_features": (16, 2, 2)})
    np.random.seed(4)
    want = _tour_batches(jtd, path, jtd.TourSampler(TOURS, LANES))
    got = _tour_batches(ttd, path, ttd.TourSampler(
        TOURS, LANES, rng=np.random.RandomState(4)))
    assert len(want) == 3
    _assert_tree_equal(got, want, "batches")
    tour_masks = got[2][3].reshape(4, LANES)
    assert tour_masks[0].tolist() == [1, 0]  # lane 1 starts tour c


# -- (b) the carry --------------------------------------------------------------
MEMORY = {
    "1_cma": [],
    "2_tour_cma": ["MODEL.tour_memory", True],
    "3_pool_cma": ["MODEL.tour_memory_variant", True],
}


def _keep_gradients():
    """An optax transformation that leaves the weights (lr 0) and keeps
    the last gradients as its state."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g),
    )


@pytest.mark.parametrize("memory", list(MEMORY))
def test_carry_over_three_batches_matches_jax(memory, tmp_path):
    os.chdir(REPO)
    opts = _opts() + MEMORY[memory] + [
        "IL.lr", 0.0, "TPU.data_parallel_devices", 1,
        "CHECKPOINT_FOLDER", str(tmp_path / "ckpts"),
        "IL.DAGGER.lmdb_features_dir", str(tmp_path / "unused.lmdb")]
    tcfg, jpol, params, tpol = _pair(LATENT_CONFIG, opts)
    path = _tour_store(str(tmp_path / "traj.lmdb"), _feature_shapes(tpol))
    batches = _tour_batches(ttd, path, ttd.TourSampler(
        TOURS, LANES, rng=np.random.RandomState(4)))
    assert [b[4].shape for b in batches] == [(4, LANES)] * 3

    jcfg = jax_config(LATENT_CONFIG, opts)
    jtrainer = jax_registry.get_trainer("iterative_dagger")(jcfg)
    jtrainer.policy, jtrainer.params = jpol, jax.device_put(params)
    jtrainer.optimizer = _keep_gradients()
    jtrainer.opt_state = jtrainer.optimizer.init(jtrainer.params)
    jtrainer._jit_cache, jtrainer._txt_cache_tokens = {}, None

    ttrainer = torch_registry.get_trainer("iterative_dagger")(tcfg, "cpu")
    for module in tpol.modules():
        if isinstance(module, torch.nn.RNNBase):
            module.train()
    ttrainer.policy = tpol
    ttrainer.optimizer = tbt.make_optimizer(tpol, tcfg)
    carried_in = []
    update = ttrainer._update_agent

    def spy(*args, rnn_states=None, **kwargs):
        carried_in.append(rnn_states)
        return update(*args, rnn_states=rnn_states, **kwargs)

    ttrainer._update_agent = spy
    jcarry = tcarry = None
    carried_out = []
    for k, batch in enumerate(batches):
        *jterms, jcarry = jtrainer._update_agent_iterative(
            *batch, rnn_states=jcarry)
        *tterms, tcarry = ttrainer._update_agent_iterative(
            *batch, rnn_states=tcarry)
        carried_out.append(tcarry)
        assert not carried_in[-1].requires_grad
        for got, want in zip(tterms, jterms):
            assert abs(got - want) <= LOSS_RTOL * abs(want), (k, got, want)
        want = np.asarray(jcarry)
        err = float(np.abs(tcarry.numpy() - want).max())
        assert err <= GRAD_TOL * float(np.abs(want).max()), (k, err)
        if k == 1:
            _assert_grads_match(tpol, jax.device_get(jtrainer.opt_state))
    # the weights never moved (lr 0 on both sides)
    for name, value in params_from_jax(params).items():
        assert torch.equal(tpol.state_dict()[name], value), name
    # what went into batch 1: a fresh state, batch 0's, or its tour slot
    layers = tpol.num_recurrent_layers
    second, first_out = carried_in[1], carried_out[0]
    assert first_out.abs().sum() > 0
    if memory == "1_cma":
        assert not second.any()
    elif memory == "2_tour_cma":
        assert torch.equal(second, first_out)
    else:
        assert not second[:, :layers - 1].any()
        assert torch.equal(second[:, layers - 1], first_out[:, layers - 1])


# -- (c) end to end -------------------------------------------------------------
def _sensor_opts():
    opts = []
    for sensor in ("DEPTH_SENSOR", "RGB_SENSOR"):
        for side in ("HEIGHT", "WIDTH"):
            opts += [f"TASK_CONFIG.SIMULATOR.{sensor}.{side}", "64"]
    return opts


def _train_opts(root, *extra):
    return [
        "CHECKPOINT_FOLDER", str(root / "ckpts"),
        "TENSORBOARD_DIR", str(root / "tb"),
        "RESULTS_DIR", str(root / "results"),
        "LOG_FILE", str(root / "train.log"),
        "IL.DAGGER.update_size", "3",
        "IL.DAGGER.lmdb_features_dir", str(root / "traj.lmdb"),
        "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", "12",
        "TPU.async_checkpointing", "True",
        *_sensor_opts(), *extra,
    ]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One collect + tour-BPTT train cycle of tour_cma_train.yaml."""
    os.chdir(REPO)
    root = tmp_path_factory.mktemp("tour")
    random.seed(0)
    np.random.seed(0)
    trainer = run_exp(TOUR_CONFIG, "train", _train_opts(root), device="cpu")
    return root, trainer


def test_tour_training_writes_the_index_and_trains_each_batch(trained):
    root, trainer = trained
    with TrajectoryStore(str(root / "traj.lmdb")) as store:
        tours = store.get(0)["tours_to_idxs"]
        records = store.count()
        obs = store.get(1)[0]
    assert sorted(sum(tours.values(), [])) == list(range(1, records))
    assert records - 1 >= 3
    assert {"depth_features", "rgb_features"} <= set(obs)
    assert not {"depth", "rgb"} & set(obs)
    batches = ttd.TourSampler(tours, trainer.config.IL.batch_size,
                              shuffle=False).get_num_batches()
    assert trainer.train_steps == batches * trainer.config.IL.epochs >= 1
    assert len(trainer.losses) == trainer.train_steps
    for loss, action, aux in trainer.losses:
        assert math.isfinite(loss) and math.isfinite(action)
        assert abs(loss - (action + aux)) <= 1e-6 * abs(loss)
    assert trainer.collection_steps > 0 and not trainer.obs_transforms
    assert type(trainer.policy).__name__ == "LatentCMAPolicy"
    assert trainer.policy.num_recurrent_layers == 3  # tour_memory_variant

    path = str(root / "ckpts" / "ckpt.0.pth")
    ckpt = tbt.load_checkpoint(path)
    assert ckpt["optim_state"]["state"]
    assert (ckpt["dagger_it"], ckpt["epoch"], ckpt["step_id"]) == (
        0, 0, trainer.train_steps)
    assert not [f for f in os.listdir(root / "ckpts") if f.endswith(".tmp")]
    # the JAX package's reader gives the same weights
    state = trainer.policy.state_dict()
    jloaded = params_from_jax(jcio.load_reference_policy_checkpoint(path)[
        "params"])
    for k, v in jloaded.items():
        assert torch.equal(v, state[k]), k


def _assert_same(got, want, where="checkpoint"):
    if isinstance(want, torch.Tensor):
        assert isinstance(got, torch.Tensor), where
        assert got.dtype == want.dtype and got.shape == want.shape, where
        assert torch.equal(got, want), where
    elif isinstance(want, dict):
        assert got.keys() == want.keys(), where
        for k in want:
            _assert_same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{where}[{i}]")
    else:
        assert got == want, where


def test_async_checkpoint_equals_a_synchronous_save(trained, tmp_path):
    root, trainer = trained
    tbt.save_checkpoint(trainer.policy, trainer.config,
                        str(tmp_path / "sync.pth"),
                        optim_state=trainer.optimizer.state_dict(),
                        dagger_it=0, epoch=0, step_id=trainer.train_steps)
    _assert_same(torch.load(root / "ckpts" / "ckpt.0.pth"),
                 torch.load(tmp_path / "sync.pth"))


def _preloaded(root, monkeypatch, ckpts):
    """A second run's options on the trained store, with collection
    forbidden."""
    def no_collection(self, *args, **kwargs):
        raise AssertionError("a preloaded run collected")

    monkeypatch.setattr(DaggerTrainer, "_update_dataset", no_collection)
    return _train_opts(root, "IL.DAGGER.preload_lmdb_features", "True",
                       "CHECKPOINT_FOLDER", str(root / ckpts))


def test_preloaded_store_trains_without_collecting(trained, monkeypatch):
    root, first = trained
    opts = _preloaded(root, monkeypatch, "preload_ckpts")
    np.random.seed(0)
    trainer = run_exp(TOUR_CONFIG, "train", opts, device="cpu")
    assert trainer.collection_steps == 0
    assert trainer.train_steps == first.train_steps
    assert os.listdir(root / "preload_ckpts") == ["ckpt.0.pth"]


def test_a_checkpoint_writer_error_is_raised_by_train(trained, monkeypatch):
    root, _ = trained
    opts = _preloaded(root, monkeypatch, "failing_ckpts")

    def failing_save(obj, path, *args, **kwargs):
        raise OSError(f"disk full writing {path}")

    monkeypatch.setattr(tbt.torch, "save", failing_save)
    with pytest.raises(OSError, match="disk full"):
        run_exp(TOUR_CONFIG, "train", opts, device="cpu")
    assert os.listdir(root / "failing_ckpts") == []
