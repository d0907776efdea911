"""Resuming and writing training checkpoints in the port, on the CPU:

(a) a JAX trainer's pickle with optax Adam's state (``optax.adam``, and
    ``SEMANTIC_MAP_ENCODER.custom_lr``'s ``multi_transform`` of two),
    written by the JAX trainer's own ``save_checkpoint`` after three
    steps in float64: the port's ``_initialize_training`` with
    ``IL.is_requeue`` gives each parameter optax's moments and count
    exactly, the pickled epoch and step, and one more step on shared
    gradients within ``ADAM_RTOL`` of optax's;
(b) a moment without a parameter, a parameter without a moment and a
    shape that differs each raise, naming the tensor;
(c) ``TPU.async_checkpointing``'s writer: the state is copied when the
    save is asked for, a write's error is raised by the next save or by
    the wait, and no temporary file stays behind.

The port reads the pickle without JAX; the tests use optax to write it."""

import copy
import os
import pickle
import threading

import jax
import numpy as np
import optax
import pytest
import torch

import ivlnce_tpu.trainers  # noqa: F401  (registration side effects)
from ivlnce_tpu.config import get_config as jax_config
from ivlnce_tpu.utils.registry import registry as jax_registry
from ivlnce_tpu_torch.config import get_config as torch_config
from ivlnce_tpu_torch.models import checkpoint_io as tcio
from ivlnce_tpu_torch.models import il_update
from ivlnce_tpu_torch.models.convert import params_from_jax
from ivlnce_tpu_torch.trainers import base_trainer as tbt
from ivlnce_tpu_torch.utils.registry import registry as torch_registry
from tests.test_torch_train import ADAM_RTOL, MAP_CONFIG, _opts, _pair
from tests.test_torch_train import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dirs(tmp_path):
    return ["CHECKPOINT_FOLDER", str(tmp_path / "ckpts"),
            "TENSORBOARD_DIR", str(tmp_path / "tb"),
            "IL.DAGGER.lmdb_features_dir", str(tmp_path / "traj.lmdb")]


def _jax_optimizer(cfg):
    """The JAX trainer's optimizer for ``cfg`` (base_trainer.py:193-211)."""
    if not cfg.MODEL.SEMANTIC_MAP_ENCODER.custom_lr:
        return optax.adam(cfg.IL.lr)
    return optax.multi_transform(
        {"map": optax.adam(cfg.MODEL.SEMANTIC_MAP_ENCODER.lr),
         "regular": optax.adam(cfg.IL.lr)},
        lambda p: {k: ("map" if k == "map_encoder" else "regular")
                   for k in p})


def _adam_states(state, custom_lr):
    if custom_lr:
        return [state.inner_states[label].inner_state[0]
                for label in ("map", "regular")]
    return [state[0]]


def _moments(states, field):
    """One label-merged tree of ``mu`` or ``nu``, in the port's names."""
    tree = {k: v for s in states for k, v in getattr(s, field).items()
            if not isinstance(v, optax.MaskedNode)}
    return params_from_jax(jax.device_get(tree))


def _random_grads(rng, tree):
    """Seeded gradients as training gives them: none reach the frozen
    depth encoder (its features come from the store) nor the map
    BatchNorm statistics (batch statistics in training)."""
    grads = {k: jax.tree_util.tree_map(
        lambda a: rng.normal(0, 1, np.shape(a)), v)
        for k, v in tree.items() if k != "depth_encoder"}
    grads["depth_encoder"] = jax.tree_util.tree_map(np.zeros_like,
                                                    tree["depth_encoder"])
    for blk in grads["map_encoder"]["cnn"].values():
        # batch-statistics BatchNorm: no gradient reaches the statistics
        blk["conv"]["1"]["mean"] *= 0
        blk["conv"]["1"]["var"] *= 0
    return grads


@pytest.mark.parametrize("custom_lr", [False, True])
def test_jax_pickle_resumes_adam(custom_lr, tmp_path, monkeypatch):
    os.chdir(REPO)
    opts = _opts(custom_lr=custom_lr) + _dirs(tmp_path)
    tcfg, _, params, _ = _pair(MAP_CONFIG, opts)
    jcfg = jax_config(MAP_CONFIG, opts)
    optimizer = _jax_optimizer(jcfg)
    rng = np.random.default_rng(9)
    with jax.enable_x64(True):
        # float64 (optax rounds its bias correction in the parameters'
        # dtype); the frozen depth encoder, 24.8 M of the 26.0 M
        # parameters, stays float32: its moments stay 0
        jparams = {k: v if k == "depth_encoder" else jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64), v)
            for k, v in params.items()}
        state = optimizer.init(jparams)
        update = jax.jit(optimizer.update)
        for _ in range(3):
            updates, state = update(_random_grads(rng, jparams), state,
                                    jparams)
            jparams = jax.device_get(optax.apply_updates(jparams, updates))
        # the JAX trainer's own pickle of its params and optax state
        jtrainer = jax_registry.get_trainer(jcfg.TRAINER_NAME)(jcfg)
        jtrainer.params, jtrainer.opt_state = jparams, state
        jtrainer.save_checkpoint("ckpt.2.pth", dagger_it=1, epoch=2,
                                 step_id=7)
    path = str(tmp_path / "ckpts" / "ckpt.2.pth")

    # the port's policy in float64, so the float64 moments load exactly
    policy_cls = torch_registry.get_policy(tcfg.MODEL.policy_name)
    build = policy_cls.from_config
    monkeypatch.setattr(policy_cls, "from_config", classmethod(
        lambda cls, config, info: build(config, info).double()))
    resumed = torch_config(MAP_CONFIG, opts + [
        "IL.load_from_ckpt", True, "IL.is_requeue", True,
        "IL.ckpt_to_load", path])
    trainer = torch_registry.get_trainer(resumed.TRAINER_NAME)(resumed, "cpu")
    trainer._initialize_training(resumed)
    assert (trainer.start_epoch, trainer.step_id) == (3, 7)
    topt = trainer.optimizer
    assert len(topt.param_groups) == (2 if custom_lr else 1)
    adams = _adam_states(state, custom_lr)
    mu, nu = _moments(adams, "mu"), _moments(adams, "nu")
    named = dict(trainer.policy.named_parameters())
    weights = params_from_jax(jparams)
    for name, p in named.items():
        st = topt.state[p]
        assert float(st["step"]) == 3.0, name
        assert torch.equal(st["exp_avg"], mu[name].double()), name
        assert torch.equal(st["exp_avg_sq"], nu[name].double()), name
        assert torch.equal(p.detach(), weights[name].double()), name
    # the map BatchNorm statistics' moments were dropped, not loaded
    assert any(k.endswith("running_mean") for k in mu)

    with jax.enable_x64(True):
        grads = _random_grads(rng, jparams)
        updates, state = update(grads, state, jparams)
        want = params_from_jax(jax.device_get(
            optax.apply_updates(jparams, updates)))
    tgrads = params_from_jax(grads)
    for name, p in named.items():
        # the frozen encoder gets no gradient in the port's training
        p.grad = (None if name.startswith("net.depth_encoder.")
                  else tgrads[name].clone())
    topt.step()
    for name, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=ADAM_RTOL, atol=0, err_msg=name)


def _break_missing(mu, nu):
    del mu["action_distribution"]["linear"]["b"]
    del nu["action_distribution"]["linear"]["b"]
    return KeyError, "action_distribution.linear.bias"


def _break_extra(mu, nu):
    for tree in (mu, nu):
        tree["no_such_layer"] = {"w": np.zeros((3, 4), np.float32)}
    return KeyError, "net.no_such_layer.weight"


def _break_shape(mu, nu):
    for tree in (mu, nu):
        w = tree["action_distribution"]["linear"]["w"]
        tree["action_distribution"]["linear"]["w"] = w[:-1]
    return ValueError, "action_distribution.linear.weight"


@pytest.mark.parametrize("fault", [_break_missing, _break_extra,
                                   _break_shape],
                         ids=["missing", "extra", "shape"])
def test_a_pickle_that_does_not_fit_raises_naming_the_tensor(fault,
                                                             tmp_path):
    tcfg, _, params, tpol = _pair(MAP_CONFIG, _opts())
    state = jax.device_get(optax.adam(1e-3).init(params))
    adam = state[0]
    mu, nu = copy.deepcopy(adam.mu), copy.deepcopy(adam.nu)
    error, name = fault(mu, nu)
    state = (adam._replace(mu=mu, nu=nu), state[1])
    path = str(tmp_path / "ckpt.pkl")
    with open(path, "wb") as f:
        pickle.dump({"optim_state": state}, f,
                    protocol=pickle.HIGHEST_PROTOCOL)
    inert = tcio.load_jax_pickle(path)["optim_state"]
    with pytest.raises(error, match=name.replace(".", r"\.")):
        tcio.adam_state_from_optax(inert, il_update.make_optimizer(tpol, tcfg),
                                   tpol)


# -- (c) the asynchronous writer ----------------------------------------------
def test_async_save_copies_the_state_at_once(tmp_path, monkeypatch):
    """The write waits until the weights changed in place: the file holds
    the state of when the save was asked for."""
    tcfg = torch_config(MAP_CONFIG, _opts() + _dirs(tmp_path) + [
        "TPU.async_checkpointing", True])
    trainer = torch_registry.get_trainer(tcfg.TRAINER_NAME)(tcfg, "cpu")
    trainer.policy = torch.nn.Linear(3, 2)
    trainer.optimizer = torch.optim.Adam(trainer.policy.parameters())
    trainer.policy(torch.ones(1, 3)).sum().backward()
    trainer.optimizer.step()
    before = copy.deepcopy(trainer.policy.state_dict())
    moments = copy.deepcopy(trainer.optimizer.state_dict()["state"])
    gate, save = threading.Event(), torch.save

    def gated(obj, f, *args, **kwargs):
        assert gate.wait(30)
        return save(obj, f, *args, **kwargs)

    monkeypatch.setattr(tbt.torch, "save", gated)
    trainer.save_training_checkpoint("ckpt.0.pth", epoch=0, step_id=1)
    with torch.no_grad():
        for p in trainer.policy.parameters():
            p.add_(1.0)
    trainer.optimizer.step()
    gate.set()
    trainer.checkpoint_writer.wait()
    ckpt = torch.load(tmp_path / "ckpts" / "ckpt.0.pth")
    for k, v in before.items():
        assert torch.equal(ckpt["state_dict"][k], v), k
    for i, st in moments.items():
        for k, v in st.items():
            assert torch.equal(ckpt["optim_state"]["state"][i][k], v), k
    assert ckpt["step_id"] == 1
    assert os.listdir(tmp_path / "ckpts") == ["ckpt.0.pth"]


def test_async_write_error_is_raised_not_dropped(tmp_path, monkeypatch):
    writer = tbt.AsyncCheckpointWriter()
    save = torch.save
    calls = []

    def failing_once(obj, f, *args, **kwargs):
        calls.append(f)
        if len(calls) == 1:
            raise OSError("disk full")
        return save(obj, f, *args, **kwargs)

    monkeypatch.setattr(tbt.torch, "save", failing_once)
    writer.save({"x": torch.ones(2)}, str(tmp_path / "a.pth"))
    with pytest.raises(OSError, match="disk full"):
        writer.save({"x": torch.ones(2)}, str(tmp_path / "b.pth"))
    writer.save({"x": torch.zeros(2)}, str(tmp_path / "c.pth"))
    writer.wait()
    writer.wait()  # nothing pending, no error left
    assert sorted(os.listdir(tmp_path)) == ["c.pth"]
    assert torch.equal(torch.load(tmp_path / "c.pth")["x"], torch.zeros(2))
    monkeypatch.setattr(tbt.torch, "save", lambda *a, **k: 1 / 0)
    writer.save({}, str(tmp_path / "d.pth"))
    with pytest.raises(ZeroDivisionError):
        writer.wait()
