"""The port's tensor-parallel ``model`` axis (``ivlnce_tpu_torch/
parallel/``: ``make_mesh(model_parallel)``, ``param_shardings``,
``parallel/tensor.py``, the ``(data, model)`` IL update and
``dryrun_multichip``) against its one-device forms and the JAX package's
mesh, on the CPU (depth and maps 64^2, hidden 64, T = 3, N = 4, unless
stated):

(a) the rule at full width: the port's ``param_shardings`` picks the
    leaves JAX's picks, over the same logical axis, for MapCMA (53 of 225
    leaves) and LatentCMA (95 of 467) at ``model`` sizes 2 and 4, through
    ``models/convert.py``'s names (JAX's full-width ``init_params`` once
    per family: ``jax.eval_shape`` cannot run it, ``init_batchnorm``
    concretises); on ``tests/test_parallel.py``'s fixed shapes each slice
    of a port tensor equals JAX's shard;
(b) ``make_mesh``'s grids and errors against JAX's, ``lane_shards`` over
    the data rows, and ``gathered_state_dict`` loaded into a one-device
    policy giving its state back exactly;
(c) each split layer (``nn.Linear``, ``nn.Conv1d``, ``nn.Conv2d``, the
    vocabulary-split ``nn.Embedding``, trainable and frozen, the gate-split
    GRU and bi-LSTM) against its whole form, forward and backward, in
    float64 to 1e-12 of the largest |value|;
(d) ``sharded_train_step`` over (1, 2), (2, 2) and (1, 4) CPU meshes
    against ``train_step`` in float64, with ``tests/test_torch_parallel.py``
    (c)'s batch, options and limits (progress monitor, trainable map
    encoder with ``update_map_bn``, ``custom_lr``'s two groups, 3 padded
    rows, ``TPU.train_encode_chunk`` 0 and 5); two carried LatentCMA tour
    batches over (2, 2) against one device;
(e) the port's (4, 2) step against JAX's ``sharded_train_step`` over
    ``make_mesh(8, model_parallel=2)`` (8 virtual devices,
    tests/conftest.py), from the same weights and batch: loss terms, RNN
    states and gradients at ``tests/test_torch_parallel.py`` (d)'s float32
    limits (one JAX compile);
(f) ``dryrun_multichip(8)`` on eight CPU devices: JAX's mesh and loss
    parity; its fused act's actions equal a one-device fused act's with
    the same weights, also in bfloat16."""

import copy
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from ivlnce_tpu.config import get_config as jax_config
from ivlnce_tpu.parallel import make_mesh as jax_make_mesh
from ivlnce_tpu.parallel import param_shardings as jax_param_shardings
from ivlnce_tpu.parallel.train import sharded_train_step as jax_step
from ivlnce_tpu.utils.registry import registry as jax_registry
from ivlnce_tpu_torch import parallel
from ivlnce_tpu_torch.config import get_config as torch_config
from ivlnce_tpu_torch.models import il_update
from ivlnce_tpu_torch.models.convert import params_from_jax
from ivlnce_tpu_torch.models.rnn import bi_lstm_padded
from ivlnce_tpu_torch.parallel import dryrun
from ivlnce_tpu_torch.parallel import tensor as tp
from ivlnce_tpu_torch.run import register_all
from ivlnce_tpu_torch.trainers import tour_dataset as ttd
from ivlnce_tpu_torch.utils.registry import registry as torch_registry
from tests.test_torch_parallel import (
    FULL,
    SGD_LR,
    _close,
    _dp_opts,
    _torch_trainer,
    assert_same_update,
    one_device_run,  # noqa: F401  (module fixture)
)
from tests.test_torch_tour_train import (
    LANES,
    MEMORY,
    TOURS,
    _tour_batches,
    _tour_store,
)
from tests.test_torch_train import (  # noqa: F401  (autouse fixture)
    LATENT_CONFIG,
    LOSS_RTOL,
    MAP_CONFIG,
    MAP_ENCODER,
    _assert_grad_close,
    _feature_shapes,
    _opts,
    _pair,
    _train_batch,
    one_torch_thread,
)

LAYER_TOL = 1e-12  # of the largest |value|, float64


def _cpu_mesh(data, model):
    return parallel.make_mesh(data * model, model_parallel=model,
                              devices=["cpu"] * (data * model))


# -- (a) the rule at full width -----------------------------------------------
def _axis_markers(params, shardings):
    """Each JAX leaf as int16 positions along its sharded axis (-1 where
    it is replicated), in the leaf's own layout."""
    def mark(x, sharding):
        spec = tuple(sharding.spec)
        if "model" not in spec:
            return np.full(x.shape, -1, np.int16)
        axis = spec.index("model")
        shape = [1] * x.ndim
        shape[axis] = x.shape[axis]
        return np.broadcast_to(
            np.arange(x.shape[axis], dtype=np.int16).reshape(shape), x.shape)
    return jax.tree_util.tree_map(mark, jax.device_get(params), shardings)


@pytest.fixture(scope="module", params=["MapCMAPolicy", "LatentCMAPolicy"])
def full_width(request):
    """JAX's full-width parameter tree of one family (depth 256^2, 64^2
    maps, hidden 512, the progress monitor) and the port's policy."""
    name = request.param
    opts = ["MODEL.policy_name", name, "MODEL.PROGRESS_MONITOR.use", True]
    info = {"depth_hw": 256, "map_hw": 64}
    jpol = jax_registry.get_policy(name).from_config(jax_config(None, opts),
                                                     info)
    params = jpol.init_params(jax.random.PRNGKey(0))
    register_all()
    tpol = torch_registry.get_policy(name).from_config(
        torch_config(None, opts), info)
    return name, params, tpol


@pytest.mark.parametrize("model", [2, 4])
def test_the_rule_picks_jaxs_leaves_at_full_width(full_width, model):
    name, params, tpol = full_width
    jmesh = jax_make_mesh(8, model_parallel=model)
    markers = params_from_jax(_axis_markers(
        params, jax_param_shardings(params, jmesh)))
    state = tpol.state_dict()
    rule = parallel.param_shardings(state, _cpu_mesh(8 // model, model))
    want = {k for k, v in markers.items()
            if v.dim() and int(v.reshape(-1)[0]) >= 0}
    got = {k for k, axis in rule.items() if axis is not None}
    assert got == want
    leaves, picked = len(jax.tree_util.tree_leaves(params)), len(got)
    assert (picked, leaves) == {"MapCMAPolicy": (53, 225),
                                "LatentCMAPolicy": (95, 467)}[name]
    for k in got:  # the same logical axis: port axis 0 is JAX's
        assert rule[k] == 0
        v = markers[k]
        assert v.shape == state[k].shape, k
        positions = torch.arange(v.shape[0], dtype=v.dtype)
        assert torch.equal(v, positions.reshape((-1,) + (1,) * (v.dim() - 1))
                           .expand_as(v)), k
    elements = sum(state[k].numel() for k in got)
    assert elements == {"MapCMAPolicy": 13_349_136,
                        "LatentCMAPolicy": 36_419_856}[name]


def test_slices_equal_jaxs_shards_on_fixed_shapes():
    """``tests/test_parallel.py``'s shapes: each port slice j is JAX's
    model shard j, after ``params_from_jax``."""
    rng = np.random.default_rng(0)
    tree = {
        "big_linear": {"w": rng.normal(size=(512, 256))},  # out axis 0
        "conv_hwio": {"w": rng.normal(size=(7, 7, 14, 64))},  # out -1
        "small": {"w": rng.normal(size=(4, 4))},  # under min size
        "bias": {"b": rng.normal(size=(512,))},  # 1-D: replicated
        "odd_out": {"w": rng.normal(size=(513, 256))},  # 513 % 2 != 0
    }
    tree = jax.tree_util.tree_map(lambda x: x.astype(np.float32), tree)
    jmesh = jax_make_mesh(8, model_parallel=2)
    shardings = jax_param_shardings(tree, jmesh)
    placed = jax.device_put(tree, shardings)
    state = params_from_jax(tree)
    mesh = _cpu_mesh(4, 2)
    rule = parallel.param_shardings(state, mesh)
    assert {k for k, a in rule.items() if a is not None} == {
        "net.big_linear.weight", "net.conv_hwio.weight"}
    for name in ("big_linear", "conv_hwio"):
        slices = tp.Slices(state[f"net.{name}.weight"], mesh.grid[0])
        array = placed[name]["w"]
        axis = tuple(array.sharding.spec).index("model")
        for shard in array.addressable_shards:
            j = shard.index[axis].start // (array.shape[axis] // 2)
            want = params_from_jax({name: {"w": np.asarray(shard.data)}})
            assert torch.equal(slices[j], want[f"net.{name}.weight"])


# -- (b) the mesh -------------------------------------------------------------
@pytest.mark.parametrize("n,model", [(8, 1), (8, 2), (8, 4), (8, 8), (8, 3),
                                     (6, 4), (4, 2)])
def test_make_mesh_matches_jax(n, model):
    cards = [f"cuda:{i}" for i in range(8)]  # names only: no card is used
    try:
        jmesh = jax_make_mesh(n, model_parallel=model)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            parallel.make_mesh(n, model_parallel=model, devices=cards)
        assert str(got.value) == str(e)
        return
    mesh = parallel.make_mesh(n, model_parallel=model, devices=cards)
    assert mesh.shape == dict(jmesh.shape)
    ids = [[d.id for d in row] for row in jmesh.devices]
    assert [[d.index for d in row] for row in mesh.grid] == ids
    assert mesh.devices == tuple(row[0] for row in mesh.grid)
    lanes = 2 * mesh.shape["data"]
    assert parallel.lane_shards(mesh, lanes) == [
        (row[0], slice(2 * i, 2 * i + 2)) for i, row in enumerate(mesh.grid)]


def test_gathered_state_dict_round_trips_into_one_device(one_device_run):
    _, tpol, _, _ = one_device_run
    split = parallel.shard_policy(tpol, _cpu_mesh(1, 4))
    assert tp.is_split(split) and not tp.is_split(tpol)
    fresh = copy.deepcopy(tpol)
    with torch.no_grad():
        for t in itertools.chain(fresh.parameters(), fresh.buffers()):
            t.zero_()
    state = parallel.gathered_state_dict(split)
    assert list(state) != list(split.state_dict())  # the names change back
    fresh.load_state_dict(state)
    want = tpol.state_dict()
    assert state.keys() == want.keys()
    for k, v in fresh.state_dict().items():
        assert v.shape == want[k].shape and torch.equal(v, want[k]), k


# -- (c) the layers -----------------------------------------------------------
def _layer(kind):
    """(whole layer, input maker, call) of one kind, each weight the rule
    splits at least 2^15 elements: every weight, but for "gru_ih" (W_ih
    only, as the full width's first GRU) and "lstm_hh" (W_hh only, as
    the instruction encoder's)."""
    if kind == "linear":
        return nn.Linear(256, 128), \
            lambda g: torch.randn(5, 256, generator=g), lambda m, x: m(x)
    if kind == "conv1d":
        return nn.Conv1d(128, 256, 1), \
            lambda g: torch.randn(3, 128, 7, generator=g), lambda m, x: m(x)
    if kind == "conv2d":
        return nn.Conv2d(32, 64, 4, 2, 1, bias=False), \
            lambda g: torch.randn(2, 32, 9, 9, generator=g), \
            lambda m, x: m(x)
    if kind in ("embedding", "frozen_embedding"):
        layer = nn.Embedding(3000, 12, padding_idx=0)
        if kind == "frozen_embedding":
            layer = nn.Embedding.from_pretrained(
                torch.randn(3000, 12), freeze=True, padding_idx=0)

        def ids(g):
            out = torch.randint(0, 3000, (4, 9), generator=g)
            out[:, -2:] = 0  # padding
            return out
        return layer, ids, lambda m, x: m(x)
    if kind.startswith("gru"):
        i, h = (176, 64) if kind == "gru_ih" else (96, 128)
        layer = nn.GRU(i, h)

        def call(m, x):
            out, h_n = m(x, x.new_zeros(1, 5, h) + 0.1)
            return torch.cat([out.flatten(), h_n.flatten()])
        return layer, lambda g: torch.randn(3, 5, i, generator=g), call
    i = 50 if kind == "lstm_hh" else 96
    layer = nn.LSTM(i, 96, bidirectional=True, batch_first=True)
    lengths = torch.tensor([5, 0, 3, 1])

    def call(m, x):
        out, final = bi_lstm_padded(m, x, lengths)
        return torch.cat([out.flatten(), final.flatten()])
    return layer, lambda g: torch.randn(4, 5, i, generator=g), call


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("kind", ["linear", "conv1d", "conv2d", "embedding",
                                  "frozen_embedding", "gru", "gru_ih",
                                  "lstm", "lstm_hh"])
def test_split_layer_equals_its_whole_form(kind, model):
    torch.manual_seed(0)
    g = torch.Generator().manual_seed(1)
    layer, make_input, call = _layer(kind)
    whole = nn.ModuleDict({"layer": layer}).double()
    split = parallel.shard_policy(whole, _cpu_mesh(1, model))
    assert not isinstance(split.layer, type(layer))
    whole_weights = {f"layer.{k}" for m in split.modules()
                     if not isinstance(m, tp.Slices)
                     for k, p in m._parameters.items()
                     if p is not None and p.dim() >= 2}
    assert whole_weights == {
        "gru_ih": {"layer.weight_hh_l0"},
        "lstm_hh": {"layer.weight_ih_l0", "layer.weight_ih_l0_reverse"},
    }.get(kind, set())
    x = make_input(g)
    if x.is_floating_point():
        x = x.double()
    outs, grads, weights = [], [], None
    for module in (whole, split):
        xi = x.clone().requires_grad_(x.is_floating_point())
        out = call(module.layer, xi)
        if weights is None:
            weights = torch.randn(out.shape, generator=g, dtype=out.dtype)
        if out.requires_grad:  # not so for the frozen embedding
            (out * weights).sum().backward()
        outs.append(out.detach())
        grads.append({"input": xi.grad, **tp.gathered(module,
                                                      lambda p: p.grad)})
    scale = float(outs[0].abs().max())
    assert float((outs[1] - outs[0]).abs().max()) <= LAYER_TOL * scale
    assert grads[1].keys() == grads[0].keys()
    for k, want in grads[0].items():
        if want is None:
            assert grads[1][k] is None, k
            continue
        err = float((grads[1][k] - want).abs().max())
        assert err <= LAYER_TOL * float(want.abs().max()), (k, err)
    if kind == "embedding":  # the padding row takes no gradient
        assert float(grads[1]["layer.weight"][0].abs().max()) == 0
    if kind == "frozen_embedding":
        assert set(grads[1]) == {"input"}


# -- (d) the float64 update ---------------------------------------------------
def _split_run(tpol, tcfg, batch, mesh):
    """``tests/test_torch_parallel.py``'s ``_float64_run`` over ``mesh``
    with ``tpol`` split by ``shard_policy``: the loss terms, the final RNN
    states and, under their one-device names, the gradients, the weights
    and buffers, and Adam's moments."""
    policy = parallel.shard_policy(tpol, mesh).double()
    optimizer = il_update.make_optimizer(policy, tcfg)
    map_params = list(policy.net.map_encoder.parameters())
    assert [len(g["params"]) for g in optimizer.param_groups] == [
        len(list(policy.parameters())) - len(map_params), len(map_params)]
    obs, prev, masks, corrected, weights = batch
    t, n = corrected.shape
    obs = {k: v.astype(np.float64) if v.dtype.kind == "f" else v
           for k, v in obs.items()}
    masks = masks.reshape(t, n).astype(np.float64)
    step = parallel.sharded_train_step(mesh)
    rnn = policy.initial_rnn_states(n, "cpu").double()
    *terms, rnn_out = step(policy, optimizer, obs, prev, masks, masks,
                           corrected, weights.astype(np.float64), rnn,
                           True, 1.0, True)
    grads = tp.gathered(policy, lambda p: p.grad)
    moments = {}
    for m in ("exp_avg", "exp_avg_sq"):
        moments.update({(k, m): v for k, v in tp.gathered(
            policy, lambda p: optimizer.state[p][m]
            if p in optimizer.state else None).items()})
    return ([float(x) for x in terms], rnn_out, grads,
            parallel.gathered_state_dict(policy), moments, policy)


@pytest.mark.parametrize("data,model", [(1, 2), (2, 2), (1, 4)])
def test_model_axis_step_equals_the_one_device_step(one_device_run, data,
                                                    model):
    tcfg, tpol, batch, want = one_device_run
    mesh = _cpu_mesh(data, model)
    *got, policy = _split_run(tpol, tcfg, batch, mesh)
    rule = parallel.param_shardings(tpol.state_dict(), mesh)
    split = {k for k, a in rule.items() if a is not None}
    slices = {n for n, m in policy.named_modules()
              if isinstance(m, tp.Slices)}
    assert split <= slices and len(split) > 20
    assert any(k.startswith(MAP_ENCODER) for k in split)
    assert_same_update(got, want, tpol)


def test_two_carried_tour_batches_over_data_and_model(tmp_path):
    """LatentCMA with ``tour_memory_variant``: two sampler batches, the
    carry of the first into the second, over (2, 2) against one device,
    through ``_update_agent_iterative`` (its step replaced by the mesh's:
    no trainer builds a model axis)."""
    runs = {}
    for shards in (1, 2):
        opts = _dp_opts(tmp_path / str(shards), shards) + MEMORY[
            "3_pool_cma"] + ["IL.DAGGER.lmdb_features_dir",
                             str(tmp_path / "unused.lmdb")]
        tcfg, _, _, tpol = _pair(LATENT_CONFIG, opts)
        if shards == 1:
            path = _tour_store(str(tmp_path / "traj.lmdb"),
                               _feature_shapes(tpol))
            batches = _tour_batches(ttd, path, ttd.TourSampler(
                TOURS, LANES, rng=np.random.RandomState(4)))[:2]
        trainer = _torch_trainer("iterative_dagger", tcfg, tpol, shards)
        if shards == 2:
            mesh = _cpu_mesh(2, 2)
            trainer.policy = parallel.shard_policy(trainer.policy, mesh)
            trainer.optimizer = torch.optim.SGD(trainer.policy.parameters(),
                                                lr=SGD_LR)
            trainer._train_steps[2] = parallel.sharded_train_step(mesh)
        carry, out = None, []
        for batch in batches:
            *terms, carry = trainer._update_agent_iterative(
                *batch, rnn_states=carry)
            out.append((terms, carry,
                        tp.gathered(trainer.policy, lambda p: p.grad)))
        runs[shards] = (out, parallel.gathered_state_dict(trainer.policy))
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


# -- (e) against JAX's own model axis -----------------------------------------
@pytest.fixture(scope="module")
def jax_model_axis_step():
    """JAX's ``sharded_train_step`` over its (4, 2) mesh (params and the
    optimizer state model-sharded, lanes data-sharded), once, with an
    optax transformation that keeps the gradients as its state."""
    opts = _opts()
    tcfg, jpol, params, tpol = _pair(MAP_CONFIG, opts)
    batch = _train_batch(tpol, FULL)
    obs, prev, masks, corrected, weights = batch
    t, n = corrected.shape
    keep = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (
            jax.tree_util.tree_map(lambda x: -SGD_LR * x, g), g))
    mesh = jax_make_mesh(8, model_parallel=2)
    assert dict(mesh.shape) == {"data": 4, "model": 2}
    jparams = jax.device_put(params)
    step = jax_step(jpol, keep, mesh, jparams, keep.init(jparams),
                    use_progress=True, alpha=1.0, update_map_bn=False)
    masks = masks.reshape(t, n).astype(np.float32)
    out = step(jparams, keep.init(jparams), obs, prev, masks, masks,
               corrected, weights.astype(np.float32),
               jnp.asarray(jpol.initial_rnn_states(n)))
    _, grads, loss, action, aux, rnn = jax.device_get(out)
    return tcfg, tpol, batch, (loss, action, aux), rnn, grads


def test_model_axis_step_matches_jaxs_mesh_step(jax_model_axis_step):
    tcfg, tpol, batch, jterms, jrnn, jgrads = jax_model_axis_step
    obs, prev, masks, corrected, weights = batch
    t, n = corrected.shape
    mesh = _cpu_mesh(4, 2)
    policy = il_update.train_mode(parallel.shard_policy(tpol, mesh))
    optimizer = torch.optim.SGD(policy.parameters(), lr=SGD_LR)
    masks = masks.reshape(t, n).astype(np.float32)
    *terms, rnn = parallel.sharded_train_step(mesh)(
        policy, optimizer, obs, prev, masks, masks, corrected,
        weights.astype(np.float32), policy.initial_rnn_states(n, "cpu"),
        True, 1.0, False)
    for got, want in zip(terms, jterms):
        assert abs(float(got) - float(want)) <= LOSS_RTOL * abs(float(want))
    _close("rnn_states", rnn, torch.from_numpy(np.array(jrnn)))
    want = params_from_jax(jgrads)
    grads = tp.gathered(policy, lambda p: p.grad)
    checked = 0
    for name, p in tpol.named_parameters():
        if name.startswith(MAP_ENCODER):
            continue  # float32 cannot decide them (module docstring)
        g = grads.get(name, torch.zeros_like(p))
        _assert_grad_close(name, g, want[name])
        checked += 1
    assert checked > 20


# -- (f) the act path ---------------------------------------------------------
def test_dryrun_multichip_needs_a_card_unless_given_cpus():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default devices exist")
    with pytest.raises(ValueError, match="need 4 devices, have 0"):
        dryrun.dryrun_multichip(4)
    with pytest.raises(RuntimeError):
        parallel.make_mesh(devices=["cuda"])


@pytest.fixture(scope="module")
def dryrun8():
    return dryrun.dryrun_multichip(8, devices=["cpu"] * 8)


def _one_device_act(out, policy=None):
    """The fused act of ``out``'s inputs on one device, the weights the
    sharded run stepped to."""
    if policy is None:
        policy = dryrun.make_policy()
        policy.load_state_dict(parallel.gathered_state_dict(
            out["copies"][out["mesh_obj"].grid[0]]))
    mesh = parallel.make_mesh(devices=["cpu"])
    return dryrun.fused_act(mesh, {mesh.grid[0]: policy.eval()},
                            out["inputs"])


def test_dryrun_multichip_matches_jaxs(dryrun8):
    """JAX's run of the same function on its 8 virtual devices
    (``tests/test_parallel.py``) takes the mesh below and passes its loss
    parity; the port's does too."""
    out = dryrun8
    assert out["mesh"] == dict(jax_make_mesh(8, model_parallel=2).shape)
    assert abs(out["loss"] - out["single_device_loss"]) <= 1e-4 * max(
        1.0, abs(out["single_device_loss"]))
    assert out["rnn_out"] == (8, 2, 512) and out["act_actions"] == (8, 1)
    assert abs(out["loss"] - out["action_loss"] - out["aux_loss"]) < 1e-5
    actions, logits = _one_device_act(out)
    assert torch.equal(out["actions"], actions)
    _close("logits", out["logits"], logits)


def test_bfloat16_sharded_act_equals_the_one_device_act(dryrun8):
    out = dryrun8
    config = torch_config(None, ["MODEL.policy_name", "MapCMAPolicy",
                                 "MODEL.PROGRESS_MONITOR.use", True,
                                 "TPU.compute_dtype", "bfloat16"])
    torch.manual_seed(0)
    policy = torch_registry.get_policy("MapCMAPolicy").from_config(
        config, {"depth_hw": dryrun.DEPTH_HW, "map_hw": dryrun.MAP_HW})
    assert policy.net.compute_dtype == torch.bfloat16
    policy.load_state_dict(parallel.gathered_state_dict(
        out["copies"][out["mesh_obj"].grid[0]]))
    mesh = out["mesh_obj"]
    split = parallel.shard_policy(policy, mesh).eval()
    actions, logits = dryrun.fused_act(mesh, {row: split for row in
                                              mesh.grid}, out["inputs"])
    want_actions, want_logits = _one_device_act(out, policy)
    assert torch.equal(actions, want_actions)
    _close("logits", logits, want_logits)
    # the cast copies were made per slice: block j of each split weight
    cast = split.net.depth_encoder.visual_encoder.__dict__["_cast_copy"][3]
    blocks = [m for m in cast.modules() if isinstance(m, tp.Slices)]
    assert blocks and all(p.dtype == torch.bfloat16 for m in blocks
                          for p in m)
