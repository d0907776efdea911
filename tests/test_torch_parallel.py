"""The port's data-parallel IL update (``ivlnce_tpu_torch/parallel/``)
against its one-device update and the JAX package's mesh step, on the
CPU (depth and maps 64x64, hidden 64, T = 3, N = 4):

(a) ``TPU.data_parallel_devices`` resolves as the JAX trainer's
    ``_data_parallel_devices`` does on the 8-device virtual platform
    (tests/conftest.py), the port given eight CPU shards, with one
    warning per distinct lane count on both sides;
(b) ``make_mesh``'s shapes, with a ``model`` axis as JAX lays it out
    (``tests/test_torch_model_axis.py`` holds the model axis itself);
(c) ``sharded_train_step`` over 2 and 4 CPU shards against
    ``train_step``: MapCMA with the progress monitor, the trainable map
    encoder and ``update_map_bn``, Adam with ``custom_lr``'s two groups,
    a batch with 3 padded rows, with ``TPU.train_encode_chunk`` 0 and 5
    (12 rows: three chunks, the last with 3 rows of zero padding). Loss
    terms within 1e-5 relative, every gradient, updated weight and Adam
    moment within 1e-4 of the tensor's largest |value| (those of a
    gradient that is 0 in exact arithmetic, rounding noise, within 1e-5),
    the map BatchNorm statistics within 1e-5, the final RNN states within
    1e-4. In float64: Adam's first step is lr * sign(g), so float32
    rounding in a gradient that is 0 in exact arithmetic (each conv bias
    ahead of the training-mode BatchNorm) moves a weight by lr either
    way; in float64 that noise is below Adam's eps;
(d) the trainers' ``_update_agent`` with ``TPU.data_parallel_devices 4``
    over 4 CPU shards against the JAX trainer's on its 4-device mesh
    (as tests/test_parallel.py builds it), from the same weights, with
    the (T, N) masks and the collate's (T*N, 1): loss terms, gradients,
    updated weights and map BatchNorm statistics. Both sides take a plain
    gradient step (the JAX side keeps the gradients as its optimizer
    state), so the weights differ as the gradients do; Adam against optax
    is held in tests/test_torch_train.py;
(e) two carried ``iterative_dagger`` tour batches of LatentCMA, for each
    memory setting, 2-way against 1-way: loss terms, carries, gradients
    and updated weights.

Float32 cannot decide the map encoder's gradients between the two
packages (tests/test_torch_train.py holds them in float64); (d) skips
them, and holds the gradients that vanish in exact arithmetic to
rounding noise, as that file does."""

import copy
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ivlnce_tpu.config import get_config as jax_config
from ivlnce_tpu.trainers.base_trainer import BaseVLNCETrainer as JaxTrainer
from ivlnce_tpu_torch import parallel
from ivlnce_tpu_torch.config import get_config as torch_config
from ivlnce_tpu_torch.models import il_update
from ivlnce_tpu_torch.models.convert import params_from_jax
from ivlnce_tpu_torch.trainers import base_trainer as tbt
from ivlnce_tpu_torch.utils.registry import registry as torch_registry
from ivlnce_tpu_torch.trainers import tour_dataset as ttd
from tests.test_torch_tour_train import (
    LANES,
    MEMORY,
    TOURS,
    _tour_batches,
    _tour_store,
)
from tests.test_torch_train import (
    BN_TOL,
    GRAD_TOL,
    LATENT_CONFIG,
    LOSS_RTOL,
    MAP_CONFIG,
    MAP_ENCODER,
    _assert_grad_close,
    _feature_shapes,
    _opts,
    _pair,
    _train_batch,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SGD_LR = 1e-3
# episode lengths of the batches' 4 lanes (T = 3): 3 of the 12 rows of
# the first are padding (1s), which enter the map BatchNorm
PADDED, FULL = (3, 2, 3, 1), (3, 3, 3, 3)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(name, got, want, tol=GRAD_TOL):
    """``got`` within ``tol`` of ``want``'s largest |value|."""
    got, want = got.detach().double(), want.detach().double()
    err = float((got - want).abs().max())
    assert err <= tol * float(want.abs().max()), (name, err)


def _map_bn(state):
    """The map BatchNorm running statistics of a state dict."""
    return {k: v for k, v in state.items()
            if k.startswith("net.map_encoder.")
            and k.endswith(("running_mean", "running_var"))}


def _assert_bn_close(got, want):
    for k, v in want.items():
        err = float(((got[k] - v).abs() / (1 + v.abs())).max())
        assert err <= BN_TOL, (k, err)


# -- (a) the device-count rule ------------------------------------------------
WANTS = (-1, 0, 1, 2, 4, 8)
LANE_COUNTS = (3, 4, 5, 13, 16)


@pytest.mark.parametrize("lanes", LANE_COUNTS)
@pytest.mark.parametrize("want", WANTS)
def test_device_count_rule_matches_jax(want, lanes, tmp_path, caplog):
    opts = ["TPU.data_parallel_devices", want,
            "CHECKPOINT_FOLDER", str(tmp_path / "ckpts"),
            "RESULTS_DIR", str(tmp_path / "results"),
            "EVAL.SAVE_RESULTS", False]
    jtrainer = JaxTrainer(jax_config(None, opts))
    ttrainer = tbt.BaseVLNCETrainer(torch_config(None, opts), "cpu",
                                    devices=["cpu"] * 8)
    assert len(jax.devices()) == len(ttrainer.data_devices) == 8
    caplog.set_level(logging.WARNING)
    for _ in range(2):  # the second call warns no more
        got = ttrainer._data_parallel_devices(lanes)
        assert got == jtrainer._data_parallel_devices(lanes)
    warned = {name: [r.getMessage() for r in caplog.records
                     if r.name == name and r.levelno == logging.WARNING]
              for name in ("ivlnce_tpu", "ivlnce_tpu_torch")}
    assert warned["ivlnce_tpu_torch"] == warned["ivlnce_tpu"]
    capped = want not in (0, 1) and got < min(8 if want < 0 else want, 8)
    assert len(warned["ivlnce_tpu"]) == int(capped)
    # the default list: the trainer's device, once on the CPU
    assert tbt.BaseVLNCETrainer(torch_config(None, opts),
                                "cpu").data_devices == [torch.device("cpu")]


# -- (b) the mesh -------------------------------------------------------------
def test_make_mesh_shapes_and_lane_shards():
    mesh = parallel.make_mesh(4, devices=["cpu"] * 8)
    assert mesh.shape == {"data": 4, "model": 1}
    assert mesh.lead == torch.device("cpu")
    assert parallel.make_mesh(devices=["cpu"] * 8).shape["data"] == 8
    assert [s for _, s in parallel.lane_shards(mesh, 8)] == [
        slice(0, 2), slice(2, 4), slice(4, 6), slice(6, 8)]
    with pytest.raises(ValueError, match="do not split"):
        parallel.lane_shards(mesh, 6)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="at least one device"):
            parallel.make_mesh()


@pytest.mark.parametrize("model_parallel", [2, 3])
def test_make_mesh_refuses_a_model_axis(model_parallel):
    """A ``model`` axis is refused only where JAX refuses it: 8 devices
    do not divide into rows of 3; rows of 2 give JAX's (4, 2) grid."""
    if model_parallel == 3:
        with pytest.raises(ValueError, match="8 devices not divisible by "
                           "model_parallel=3"):
            parallel.make_mesh(8, model_parallel=3, devices=["cpu"] * 8)
        return
    mesh = parallel.make_mesh(8, model_parallel=2, devices=["cpu"] * 8)
    assert mesh.shape == {"data": 4, "model": 2}
    assert mesh.grid == ((torch.device("cpu"),) * 2,) * 4


# -- (c) the sharded step against the one-device step -------------------------
def _float64_run(tpol, tcfg, batch, shards):
    """One update of a float64 copy of ``tpol`` on ``batch``: one device
    (``shards`` 1, ``train_step``) or ``shards`` CPU shards. Returns the
    loss terms, the final RNN states, the gradients, the weights and
    buffers, and Adam's state."""
    policy = copy.deepcopy(tpol).double()
    optimizer = il_update.make_optimizer(policy, tcfg)
    obs, prev, masks, corrected, weights = batch
    t, n = corrected.shape
    obs = {k: v.astype(np.float64) if v.dtype.kind == "f" else v
           for k, v in obs.items()}
    masks = masks.reshape(t, n).astype(np.float64)
    args = [obs, prev, masks, masks, corrected, weights.astype(np.float64)]
    if shards == 1:
        step = il_update.train_step
        args = [{k: torch.from_numpy(v) for k, v in obs.items()},
                *map(torch.from_numpy, args[1:])]
    else:
        step = parallel.sharded_train_step(
            parallel.make_mesh(devices=["cpu"] * shards))
    rnn = policy.initial_rnn_states(n, "cpu").double()
    *terms, rnn_out = step(policy, optimizer, *args, rnn, True, 1.0, True)
    grads = {k: p.grad.clone() for k, p in policy.named_parameters()
             if p.grad is not None}
    moments = {(k, m): optimizer.state[p][m]
               for k, p in policy.named_parameters() if p in optimizer.state
               for m in ("exp_avg", "exp_avg_sq")}
    return ([float(x) for x in terms], rnn_out, grads, policy.state_dict(),
            moments)


@pytest.fixture(scope="module", params=[0, 5], ids=["whole", "chunk5"])
def one_device_run(request):
    tcfg, _, _, tpol = _pair(MAP_CONFIG, _opts(chunk=request.param,
                                               custom_lr=True))
    assert tpol.encode_chunk == request.param
    batch = _train_batch(tpol, PADDED)
    assert batch[3].shape == (3, 4)
    return tcfg, tpol, batch, _float64_run(tpol, tcfg, batch, 1)


def assert_same_update(got, want, tpol):
    """``got`` (``_float64_run``'s results) equals the one-device update
    ``want`` of ``tpol`` at (c)'s limits."""
    terms, rnn, grads, state, moments = got
    for g, ref in zip(terms, want[0]):
        assert abs(g - ref) <= LOSS_RTOL * abs(ref), (g, ref)
    assert want[0][2] > 0  # the progress monitor took part
    _close("rnn_states", rnn, want[1])
    assert grads.keys() == want[2].keys()
    assert any(k.startswith(MAP_ENCODER) for k in grads)
    for k, g in grads.items():
        _assert_grad_close(k, g, want[2][k])
    assert moments.keys() == want[4].keys()
    for (k, m), v in moments.items():
        _assert_grad_close(k, v, want[4][k, m])
    moved = 0
    for k, v in state.items():
        if k in grads:
            _close(k, v, want[3][k])
            moved += not torch.equal(v, tpol.state_dict()[k].double())
        elif k not in _map_bn(state):
            assert torch.equal(v, want[3][k]), k
    assert moved == len(grads)
    _assert_bn_close(_map_bn(state), _map_bn(want[3]))
    before = tpol.state_dict()
    assert all(not torch.equal(v, before[k].double())
               for k, v in _map_bn(state).items())


@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_step_equals_the_one_device_step(one_device_run, shards):
    tcfg, tpol, batch, want = one_device_run
    assert_same_update(_float64_run(tpol, tcfg, batch, shards), want, tpol)


# -- (d) the trainer against the JAX trainer on its 4-device mesh -------------
def _sgd_keeping_gradients():
    """optax: a plain gradient step at SGD_LR, the gradients kept as the
    state."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (
            jax.tree_util.tree_map(lambda x: -SGD_LR * x, g), g),
    )


def _dp_opts(tmp_path, want):
    return _opts() + ["TPU.data_parallel_devices", want,
                      "CHECKPOINT_FOLDER", str(tmp_path / "ckpts"),
                      "RESULTS_DIR", str(tmp_path / "results"),
                      "EVAL.SAVE_RESULTS", False]


def _torch_trainer(name, tcfg, tpol, shards):
    trainer = torch_registry.get_trainer(name)(tcfg, "cpu",
                                               devices=["cpu"] * shards)
    policy = copy.deepcopy(tpol).eval()
    for module in policy.modules():
        if isinstance(module, torch.nn.RNNBase):
            module.train()
    trainer.policy = policy
    trainer.optimizer = torch.optim.SGD(policy.parameters(), lr=SGD_LR)
    return trainer


@pytest.fixture(scope="module")
def jax_mesh_updates(tmp_path_factory):
    """The JAX trainer's ``_update_agent`` on its 4-device mesh, from the
    same weights, once for each mask layout (one compiled step)."""
    tmp = tmp_path_factory.mktemp("jax_mesh")
    opts = _dp_opts(tmp, 4)
    tcfg, jpol, params, tpol = _pair(MAP_CONFIG, opts)
    batch = _train_batch(tpol, FULL)
    t, n = batch[3].shape
    assert (t, n) == (3, 4)
    jcfg = jax_config(MAP_CONFIG, opts)
    cache, out = {}, {}
    for layout in ("TN", "TN1"):
        trainer = JaxTrainer(jcfg)
        trainer.policy = jpol
        trainer.params = jax.device_put(params)
        trainer.optimizer = _sgd_keeping_gradients()
        trainer.opt_state = trainer.optimizer.init(trainer.params)
        trainer._jit_cache = cache
        obs, prev, masks, corrected, weights = batch
        masks = masks.reshape(t, n) if layout == "TN" else masks
        terms = trainer._update_agent(obs, prev, masks, corrected, weights)
        assert "train_step_dp4" in cache
        leaves = jax.tree_util.tree_leaves(trainer.params)
        assert len(leaves[0].sharding.device_set) == 4
        out[layout] = (terms, jax.device_get(trainer.params),
                       jax.device_get(trainer.opt_state))
    return tcfg, tpol, batch, out


@pytest.mark.parametrize("layout", ["TN", "TN1"])
def test_update_agent_matches_the_jax_mesh_update(jax_mesh_updates, layout,
                                                  tmp_path, caplog):
    tcfg, tpol, batch, out = jax_mesh_updates
    (jloss, jaction, jaux, jrnn), jparams, jgrads = out[layout]
    trainer = _torch_trainer("dagger", tcfg, tpol, 4)
    caplog.set_level(logging.INFO)
    obs, prev, masks, corrected, weights = batch
    t, n = corrected.shape
    masks = masks.reshape(t, n) if layout == "TN" else masks
    assert masks.shape == ((t, n) if layout == "TN" else (t * n, 1))
    *terms, rnn = trainer._update_agent(obs, prev, masks, corrected,
                                        weights)
    assert isinstance(trainer._train_steps[4], parallel.ShardedTrainStep)
    assert "data-parallel over 4 devices" in caplog.text
    for got, want in zip(terms, (jloss, jaction, jaux)):
        assert abs(got - float(want)) <= LOSS_RTOL * abs(float(want))
    _close("rnn_states", rnn, torch.from_numpy(np.array(jrnn)))
    policy = trainer.policy
    want_grads = params_from_jax(jgrads)
    checked = 0
    for name, p in policy.named_parameters():
        if name.startswith(MAP_ENCODER):
            continue
        g = torch.zeros_like(p) if p.grad is None else p.grad
        _assert_grad_close(name, g, want_grads[name])
        checked += 1
    assert checked > 20
    want = params_from_jax(jparams)
    state = policy.state_dict()
    stats = _map_bn(state)
    for name, v in state.items():
        if name in want and name not in stats:
            _close(name, v, want[name])
    _assert_bn_close(stats, {k: want[k] for k in stats})


# -- (e) the tour carry, 2-way against 1-way ----------------------------------
@pytest.mark.parametrize("memory", list(MEMORY))
def test_two_carried_tour_batches_two_way_equal_one_way(memory, tmp_path):
    os.chdir(REPO)
    runs = {}
    for shards in (1, 2):
        opts = _dp_opts(tmp_path / str(shards), shards) + MEMORY[memory] + [
            "IL.DAGGER.lmdb_features_dir", str(tmp_path / "unused.lmdb")]
        tcfg, _, _, tpol = _pair(LATENT_CONFIG, opts)
        if shards == 1:
            path = _tour_store(str(tmp_path / "traj.lmdb"),
                               _feature_shapes(tpol))
            batches = _tour_batches(ttd, path, ttd.TourSampler(
                TOURS, LANES, rng=np.random.RandomState(4)))[:2]
        trainer = _torch_trainer("iterative_dagger", tcfg, tpol, shards)
        carry, out = None, []
        for batch in batches:
            *terms, carry = trainer._update_agent_iterative(
                *batch, rnn_states=carry)
            grads = {k: p.grad.clone()
                     for k, p in trainer.policy.named_parameters()
                     if p.grad is not None}
            out.append((terms, carry, grads))
        runs[shards] = (out, trainer.policy.state_dict(), trainer)
    assert isinstance(runs[2][2]._train_steps[2], parallel.ShardedTrainStep)
    assert runs[1][2]._train_steps[1] is il_update.train_step
    assert batches[1][3].reshape(-1, LANES)[0].tolist() == [1, 1]
    for (terms, carry, grads), (wterms, wcarry, wgrads) in zip(
            runs[2][0], runs[1][0]):
        for got, want in zip(terms, wterms):
            assert abs(got - want) <= LOSS_RTOL * abs(want), (got, want)
        _close("carry", carry, wcarry)
        assert grads.keys() == wgrads.keys()
        for k, g in grads.items():
            _assert_grad_close(k, g, wgrads[k])
    for k, v in runs[2][1].items():
        _close(k, v, runs[1][1][k])
