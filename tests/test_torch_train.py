"""The port's DAgger training against the JAX package's, on the CPU:

(a) the trajectory store, written by one package and read by the other,
    over both engines (native C++ and ``_PyStore``) and with float16;
(b) the data recipe: ``IWTrajectoryDataset.batches()`` and
    ``batches_parallel(2)`` of both packages give identical batches from
    the same records and the same ``random`` seed;
(c) one train step with the same weights (``params_from_jax``) and the
    same collated batch: the loss terms within 1e-5 relative, every
    gradient tensor within 1e-4 of its largest |value| (MapCMA with a
    trainable map encoder and the progress monitor, also with
    ``TPU.train_encode_chunk`` smaller than T*N; LatentCMA with
    ``tour_memory_variant``); Adam on shared gradients within 1e-6
    relative (with and without ``custom_lr``'s two groups); the map
    BatchNorm statistics after a step equal JAX's
    ``map_encoder_new_stats`` of the UPDATED weights within 1e-5;
(d) a p = 1 iterative collection at 64x64 sensors: the same records,
    actions and maps, and ``depth_features`` within 1e-5 of their
    largest |value|;
(e) the port's training checkpoint read by the port and by the JAX
    package's loaders, and ``IL.is_requeue`` restoring Adam's state.

JAX's gradients come from ``make_train_step`` itself, given an optax
transformation that returns zero updates and keeps the gradients as its
state."""

import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ivlnce_tpu.envs.env  # noqa: F401  (registration side effects)
import ivlnce_tpu.mapping.obs_transforms  # noqa: F401
import ivlnce_tpu.models  # noqa: F401
import ivlnce_tpu.tasks  # noqa: F401
import ivlnce_tpu.trainers  # noqa: F401
from ivlnce_tpu.config import get_config as jax_config
from ivlnce_tpu.models import checkpoint_io as jcio
from ivlnce_tpu.models.map_encoder import map_encoder_new_stats
from ivlnce_tpu.trainers import dagger_trainer as jdt
from ivlnce_tpu.trainers import trajectory_store as jts
from ivlnce_tpu.trainers.base_trainer import make_train_step
from ivlnce_tpu.utils.registry import registry as jax_registry
from ivlnce_tpu_torch.config import get_config as torch_config
from ivlnce_tpu_torch.models import checkpoint_io as tcio
from ivlnce_tpu_torch.models import il_update
from ivlnce_tpu_torch.models.convert import params_from_jax
from ivlnce_tpu_torch.run import register_all
from ivlnce_tpu_torch.trainers import base_trainer as tbt
from ivlnce_tpu_torch.trainers import dagger_trainer as tdt
from ivlnce_tpu_torch.trainers import trajectory_store as tts
from ivlnce_tpu_torch.utils.registry import registry as torch_registry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAP_CONFIG = "configs/fake/map_cma_train_tf.yaml"
LATENT_CONFIG = "configs/fake/latent_cma_train.yaml"
HIDDEN = 64
HW = 64
MAP_CHANNELS = 8
N = 3
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4  # of each gradient tensor's largest |value|
ADAM_RTOL = 1e-6
BN_TOL = 1e-5
# the stored depth features, of their largest |value|: the float32
# ResNet-50 with GroupNorm over FakeSim's depth frames is accurate to
# 2.4e-5 (the port) and 1.3e-5 (JAX) of its float64 result (largest
# |value| 3.9), so an elementwise rtol = atol = 1e-5 between the two
# float32 results fails on a few of 25,344 values
FEATURE_TOL = 1e-5
# gradients that vanish in exact arithmetic: each conv bias ahead of the
# map encoder's training-mode BatchNorm, and the text keys' bias (a shift
# of every token's logit, which the softmax over tokens removes)
VANISHING = ("text_k.bias",) + tuple(
    f"map_encoder.cnn.{i}.conv.0.bias" for i in range(4))
VANISHING_ABS = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Thousands of small ops: with one intra-op thread they do not
    contend with the other test processes for the cores (six workers
    each spinning a full thread pool ran these files over 10x slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- records ------------------------------------------------------------------
def _record(rng, t, feature_shapes, fp16=False):
    """One seeded episode record as the collection writes it: (obs,
    prev actions, oracle actions), obs with the maps and features."""
    dtype = np.float16 if fp16 else np.float32
    tokens = np.zeros((t, 200), np.int64)
    tokens[:, :12] = rng.integers(1, 32, 12)
    obs = {
        "instruction": tokens,
        "progress": rng.uniform(0, 1, (t,)).astype(dtype),
        "occupancy_map": rng.integers(0, 2, (t, HW, HW)).astype(np.uint8),
        "semantic_map": rng.integers(0, 13, (t, HW, HW)).astype(np.uint8),
    }
    for key, shape in feature_shapes.items():
        obs[key] = rng.normal(0, 1, (t,) + shape).astype(dtype)
    oracle = rng.integers(0, 4, t).astype(np.int64)
    prev = np.concatenate([[0], oracle[:-1]]).astype(np.int64)
    return [obs, prev, oracle]


def _assert_tree_equal(got, want, path="record"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tree_equal(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, path


# -- (a) the store ------------------------------------------------------------
def _engine(module, engine):
    """``module``'s TrajectoryStore on the named engine."""
    def make(self):
        if engine == "python":
            return module._PyStore(self.path, self.writable)
        return module._NativeStore(self.path, self.writable)
    return make


@pytest.mark.parametrize("fp16", [False, True])
@pytest.mark.parametrize("engine", ["native", "python"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_store_reads_back_across_packages(tmp_path, monkeypatch, writer,
                                          engine, fp16):
    """A store written by one package on one engine reads back equal
    through the other package on the other engine."""
    rng = np.random.default_rng(7)
    wmod, rmod = (jts, tts) if writer == "jax" else (tts, jts)
    other = "native" if engine == "python" else "python"
    monkeypatch.setattr(wmod.TrajectoryStore, "_make_engine",
                        _engine(wmod, engine))
    monkeypatch.setattr(rmod.TrajectoryStore, "_make_engine",
                        _engine(rmod, other))
    path = str(tmp_path / "traj.lmdb")
    records = {0: {"tours_to_idxs": {"3": [1, 2], "5": [3]}}}
    records.update({i: _record(rng, 3 + i, {"depth_features": (8, 2, 2)},
                               fp16) for i in (1, 2, 3)})
    with wmod.TrajectoryStore(path, writable=True) as store:
        for k, v in records.items():
            store.put(k, v)
        store.sync()
    with rmod.TrajectoryStore(path) as store:
        assert store.count() == len(records)
        for k, v in records.items():
            _assert_tree_equal(store.get(k), v)
    assert os.path.exists(os.path.join(path, "data.ivts"))


# -- (b) the data recipe ------------------------------------------------------
FEATURES = {"depth_features": (16, 2, 2)}


@pytest.fixture(scope="module")
def seeded_store(tmp_path_factory):
    """Nine records of 2-7 steps (some lengths shared), written by the
    JAX package's store."""
    path = str(tmp_path_factory.mktemp("recipe") / "traj.lmdb")
    rng = np.random.default_rng(11)
    with jts.TrajectoryStore(path, writable=True) as store:
        for i, t in enumerate((5, 2, 7, 3, 5, 4, 6, 2, 5)):
            store.put(i, _record(rng, t, FEATURES))
        store.sync()
    return path


def _batches(module, path, parallel):
    dataset = module.IWTrajectoryDataset(path, True, 3.2, batch_size=2)
    random.seed(5)
    if parallel:
        with dataset.batches_parallel(2) as batches:
            return list(batches)
    return list(dataset.batches())


@pytest.mark.parametrize("parallel", [False, True])
def test_batches_equal_the_jax_packages(seeded_store, parallel):
    want = _batches(jdt, seeded_store, parallel)
    got = _batches(tdt, seeded_store, parallel)
    assert len(want) == 4
    _assert_tree_equal(got, want, "batches")


# -- (c) one train step -------------------------------------------------------
def _opts(chunk=0, custom_lr=False, variant=False):
    opts = ["MODEL.STATE_ENCODER.hidden_size", HIDDEN,
            "MODEL.SEMANTIC_MAP_ENCODER.channels", MAP_CHANNELS,
            "MODEL.PROGRESS_MONITOR.use", True,
            "TPU.train_encode_chunk", chunk,
            "MODEL.SEMANTIC_MAP_ENCODER.custom_lr", custom_lr,
            "MODEL.SEMANTIC_MAP_ENCODER.lr", 1e-3]
    for s in ("DEPTH_SENSOR", "RGB_SENSOR"):
        opts += [f"TASK_CONFIG.SIMULATOR.{s}.HEIGHT", HW,
                 f"TASK_CONFIG.SIMULATOR.{s}.WIDTH", HW]
    if variant:
        opts += ["MODEL.tour_memory_variant", True]
    return opts


def _pair(config_path, opts, seed=1):
    """The port's seeded policy (random map BatchNorm statistics), the
    JAX policy, and the same weights as the JAX package's parameter tree
    (the port's converter; ``params_from_jax`` inverts it)."""
    register_all()
    tcfg = torch_config(config_path, opts)
    info = {"depth_hw": HW, "map_hw": HW}
    torch.manual_seed(seed)
    tpol = torch_registry.get_policy(tcfg.MODEL.policy_name).from_config(
        tcfg, info)
    map_encoder = getattr(tpol.net, "map_encoder", None)
    if map_encoder is not None:
        for block in map_encoder.cnn:
            block.conv[1].running_mean.normal_(0, 0.2)
            block.conv[1].running_var.uniform_(0.5, 2)
    # copies: the converter's arrays share the port's tensors' memory
    params = jax.tree_util.tree_map(
        np.array, tcio.jax_params_from_state_dict(tpol.state_dict()))
    jcfg = jax_config(config_path, opts)
    jpol = jax_registry.get_policy(jcfg.MODEL.policy_name).from_config(
        jcfg, info)
    return tcfg, jpol, params, tpol


def _feature_shapes(tpol):
    shapes = {"depth_features": tpol.net.depth_encoder.output_shape}
    if hasattr(tpol.net, "rgb_encoder"):
        shapes["rgb_features"] = tpol.net.rgb_encoder.output_shape
    return shapes


PADDED, UNPADDED = (4, 2, 3), (4, 4, 4)


def _train_batch(tpol, lengths=PADDED, seed=3):
    """A collated (T, N) batch of seeded records, through the port's
    collate_fn: with ``PADDED`` lengths 3 of its 12 rows are padding
    (1s), which enter the map BatchNorm."""
    rng = np.random.default_rng(seed)
    inflec = np.array([1.0, 3.2])
    samples = [tdt._make_sample(_record(rng, t, _feature_shapes(tpol)),
                                inflec) for t in lengths]
    return tdt.collate_fn(samples)


def _tour_masks(corrected):
    tour = np.ones_like(corrected, np.float32)
    tour[0] = 0
    tour[2, 1] = 0
    return tour


def _jax_grad_step(jpol):
    """make_train_step, jitted, with an optax transformation that leaves
    the weights and returns the gradients as its state."""
    keep = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g),
    )
    step = jax.jit(make_train_step(jpol, keep, True, 1.0,
                                   update_map_bn=False))

    def run(params, batch, tour):
        obs, prev, masks, corrected, weights = batch
        t, n = corrected.shape
        out = step(params, keep.init(params), obs, prev,
                   masks.reshape(t, n).astype(np.float32), tour, corrected,
                   weights.astype(np.float32),
                   jnp.asarray(jpol.initial_rnn_states(n)))
        return jax.device_get(out)
    return run


def _torch_loss(tpol, batch, tour):
    obs, prev, masks, corrected, weights = batch
    t, n = corrected.shape
    tobs = {k: torch.from_numpy(v) for k, v in obs.items()}
    tpol.zero_grad(set_to_none=True)
    return il_update.train_loss(
        tpol, tobs, torch.from_numpy(prev),
        torch.from_numpy(masks.reshape(t, n).astype(np.float32)),
        torch.from_numpy(tour), torch.from_numpy(corrected),
        torch.from_numpy(weights.astype(np.float32)),
        tpol.initial_rnn_states(n, "cpu"), True, 1.0)


def _assert_grad_close(name, got, want):
    """``got`` within GRAD_TOL of ``want``'s largest |value|; a gradient
    that vanishes in exact arithmetic holds rounding noise only, on both
    sides, and is held to VANISHING_ABS."""
    if name.endswith(VANISHING):
        assert float(got.abs().max()) <= VANISHING_ABS, name
        assert float(want.abs().max()) <= VANISHING_ABS, name
        return
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= GRAD_TOL * scale, (name, err, scale)


def _assert_grads_match(tpol, jgrads, skip=()):
    """Every parameter's gradient against the JAX gradient (a missing
    gradient counts as zeros), but for the tensors named by a prefix in
    ``skip``."""
    want = params_from_jax(jgrads)
    checked = 0
    for name, p in tpol.named_parameters():
        if name.startswith(skip):
            continue
        g = torch.zeros_like(p) if p.grad is None else p.grad
        _assert_grad_close(name, g, want[name])
        checked += 1
    assert checked > 20


STEP_CASES = {
    "map_cma": (MAP_CONFIG, {}),
    "map_cma_chunked": (MAP_CONFIG, {"chunk": 5}),
    "latent_tour_memory_variant": (LATENT_CONFIG, {"variant": True}),
}
MAP_ENCODER = "net.map_encoder."


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_loss_and_gradients_match_jax(case):
    """MapCMA with its trainable map encoder (the default) and the
    progress monitor, also with T*N = 12 rows encoded in chunks of 5;
    LatentCMA with its tour memory. Two batches of one shape: records that
    fill T, and records with 3 padded rows (1s, which enter the map
    BatchNorm).

    Float32 cannot decide two groups of MapCMA's gradients, which
    ``test_map_encoder_backward_matches_jax`` holds in float64 instead:
    - the map encoder's own: behind BatchNorm on batch statistics of
      non-negative inputs they are small differences of large sums, and
      float32 resolves them to about 1e-3 of their largest |value| (each
      package against its own float64 gradients);
    - on the padded batch, also ``map_linear``'s: JAX sums its float32
      reductions in order, so the constant padded maps shift its batch
      statistics enough to flip ReLUs of ``map_linear`` near 0 (its
      gradient 5.6e-2 from the port's, whose float32 and float64 agree to
      6e-7; with the padded maps set to a real frame, 2e-6)."""
    config_path, kw = STEP_CASES[case]
    tcfg, jpol, params, tpol = _pair(config_path, _opts(**kw))
    if kw.get("chunk"):
        assert jpol.encode_chunk == tpol.encode_chunk == 5
    jax_step = _jax_grad_step(jpol)
    for lengths in (UNPADDED, PADDED):
        batch = _train_batch(tpol, lengths)
        tour = _tour_masks(batch[3])
        _, jgrads, jloss, jaction, jaux, jrnn = jax_step(params, batch, tour)
        loss, action, aux, rnn = _torch_loss(tpol, batch, tour)
        loss.backward()
        for got, want in ((loss, jloss), (action, jaction), (aux, jaux)):
            got = float(got.detach())
            assert abs(got - float(want)) <= LOSS_RTOL * abs(float(want))
        assert float(aux.detach()) > 0
        # the final RNN states, at the card-vs-CPU checks' tolerance
        err = float(np.abs(rnn.detach().numpy() - jrnn).max())
        assert err <= GRAD_TOL * float(np.abs(jrnn).max())
        skip = (MAP_ENCODER,) + (("net.map_linear.",) if lengths == PADDED
                                 else ())
        _assert_grads_match(tpol, jgrads, skip=skip)


@pytest.mark.parametrize("chunk", [0, 5])
def test_map_encoder_backward_matches_jax(chunk):
    """The map encoder's training forward and backward over a padded
    batch's maps (3 of 12 rows all 1s), by the port's encoder and by the
    JAX package's ``apply_map_encoder(training=True)``, both in float64
    (float32 cannot resolve these gradients, see above), with the same
    weights and the same seeded output gradient: every gradient tensor
    within GRAD_TOL of its largest |value|. With ``chunk`` the rows go
    through in chunks of 5, zero-padded to 15, each chunk on its own batch
    statistics, as ``TPU.train_encode_chunk`` runs them."""
    import copy

    from ivlnce_tpu.models import map_encoder as JME

    tcfg, jpol, params, tpol = _pair(MAP_CONFIG, _opts())
    obs = _train_batch(tpol)[0]
    occ, sem = obs["occupancy_map"], obs["semantic_map"]
    tn = occ.shape[0]
    size = chunk or tn
    k = -(-tn // size)
    pad = k * size - tn
    rng = np.random.default_rng(4)
    encoder = copy.deepcopy(tpol.net.map_encoder).double()
    cot = rng.normal(0, 1, (k * size,) + encoder.output_shape)
    cot[tn:] = 0  # the padding's outputs are cut off

    def padded(a):
        return np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])

    outs = []
    for o, s_ in zip(np.split(padded(occ), k), np.split(padded(sem), k)):
        outs.append(encoder(torch.from_numpy(o), torch.from_numpy(s_),
                            training=True))
    (torch.cat(outs) * torch.from_numpy(cot)).sum().backward()

    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                     params["map_encoder"])

        def loss(p):
            outs = [JME.apply_map_encoder(p, o, s_, training=True,
                                          dtype=jnp.float64)
                    for o, s_ in zip(np.split(padded(occ), k),
                                     np.split(padded(sem), k))]
            return jnp.sum(jnp.concatenate(outs).astype(jnp.float64) * cot)

        grads = jax.device_get(jax.jit(jax.grad(loss))(p64))
    want = params_from_jax({"map_encoder": grads})
    for name, p in encoder.named_parameters():
        _assert_grad_close(MAP_ENCODER + name, p.grad,
                           want[MAP_ENCODER + name].double())


def test_masked_gru_sequence_matches_jax():
    """``RNNStateEncoder.sequence``, h <- GRU(x_t, h * m_t) step by step,
    against the JAX package's ``gru_sequence`` on the same weights, with
    episode starts (mask 0) inside the sequence."""
    from ivlnce_tpu.models.rnn import gru_sequence

    from ivlnce_tpu_torch.models.rnn import RNNStateEncoder

    rng = np.random.default_rng(6)
    torch.manual_seed(6)
    enc = RNNStateEncoder(24, 32)
    xs = rng.normal(0, 1, (7, 3, 24)).astype(np.float32)
    h0 = rng.normal(0, 1, (3, 32)).astype(np.float32)
    masks = np.ones((7, 3), np.float32)
    masks[0, 1] = masks[3, 0] = masks[5, 2] = 0
    weights = {k[:-len("_l0")].replace("weight", "w").replace("bias", "b"):
               v.detach().numpy() for k, v in enc.rnn.named_parameters()}
    jys, jh = gru_sequence(weights, xs, h0, masks)
    with torch.no_grad():
        ys, h = enc.sequence(torch.from_numpy(xs), torch.from_numpy(h0),
                             torch.from_numpy(masks))
    np.testing.assert_allclose(ys.numpy(), np.asarray(jys), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("custom_lr", [False, True])
def test_adam_matches_optax_on_shared_gradients(custom_lr):
    """Three steps of the same gradients through optax (the JAX trainer's
    optimizer) and the port's Adam; ``custom_lr`` puts the map encoder in
    a second group at SEMANTIC_MAP_ENCODER.lr. Both run in float64: optax
    computes its bias corrections in the parameters' dtype, and in float32
    its first step is 6.4e-6 smaller than the exact one (1 - 0.999 rounds
    to 0.00099998713), which torch computes in Python floats."""
    tcfg, jpol, params, tpol = _pair(MAP_CONFIG, _opts(custom_lr=custom_lr))
    tpol.double()
    topt = il_update.make_optimizer(tpol, tcfg)
    assert len(topt.param_groups) == (2 if custom_lr else 1)
    rng = np.random.default_rng(9)
    with jax.enable_x64(True):
        if custom_lr:
            optimizer = optax.multi_transform(
                {"map": optax.adam(1e-3), "regular": optax.adam(2.5e-4)},
                lambda p: {k: ("map" if k == "map_encoder" else "regular")
                           for k in p})
        else:
            optimizer = optax.adam(2.5e-4)
        # the trainable tree: the frozen depth encoder never receives a
        # gradient in training (its features come from the store)
        jparams = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64),
            {k: v for k, v in params.items() if k != "depth_encoder"})
        state = optimizer.init(jparams)
        update = jax.jit(optimizer.update)
        for _ in range(3):
            grads = jax.tree_util.tree_map(
                lambda a: rng.normal(0, 1, np.shape(a)), jparams)
            for blk in grads["map_encoder"]["cnn"].values():
                # running statistics are buffers in the port: no gradient
                blk["conv"]["1"]["mean"] *= 0
                blk["conv"]["1"]["var"] *= 0
            updates, state = update(grads, state, jparams)
            jparams = jax.device_get(optax.apply_updates(jparams, updates))
            tgrads = params_from_jax(grads)
            for name, p in tpol.named_parameters():
                p.grad = tgrads[name].clone() if name in tgrads else None
            topt.step()
            want = params_from_jax(jparams)
            for name, p in tpol.named_parameters():
                if name not in want:
                    continue
                np.testing.assert_allclose(
                    p.detach().numpy(), want[name].numpy(), rtol=ADAM_RTOL,
                    atol=0, err_msg=name)


def _map_bn(tpol):
    return {f"{i}.{k}": getattr(blk.conv[1], k).clone()
            for i, blk in enumerate(tpol.net.map_encoder.cnn)
            for k in ("running_mean", "running_var")}


@pytest.mark.parametrize("lengths", [UNPADDED, PADDED])
def test_map_bn_statistics_follow_the_updated_weights(lengths):
    """After one train step, the running statistics equal JAX's
    ``map_encoder_new_stats`` over the batch's maps with the weights of
    AFTER the optimizer step; those of the weights before differ. On the
    padded batch only the first block's are compared: its input is the
    maps themselves, while deeper blocks see the batch statistics of the
    blocks before, which JAX's float32 sums, taken in order over rows with
    the padding's constant maps, move by up to 6e-5 relative (the
    function has no float64 form to hold the port against)."""
    tcfg, jpol, params, tpol = _pair(MAP_CONFIG, _opts())
    obs, prev, masks, corrected, weights = _train_batch(tpol, lengths)
    t, n = corrected.shape
    optimizer = il_update.make_optimizer(tpol, tcfg)
    # a large step, so the statistics of the two weights are far apart
    for group in optimizer.param_groups:
        group["lr"] = 0.05
    tmasks = torch.from_numpy(masks.reshape(t, n).astype(np.float32))
    il_update.train_step(
        tpol, optimizer, {k: torch.from_numpy(v) for k, v in obs.items()},
        torch.from_numpy(prev), tmasks, tmasks, torch.from_numpy(corrected),
        torch.from_numpy(weights.astype(np.float32)),
        tpol.initial_rnn_states(n, "cpu"), True, 1.0, True)
    got = _map_bn(tpol)

    new_stats = jax.jit(map_encoder_new_stats)

    def jax_stats(map_params):
        new = jax.device_get(new_stats(
            map_params, obs["occupancy_map"], obs["semantic_map"]))
        return {f"{i}.{k}": new["cnn"][str(i)]["conv"]["1"][j]
                for i in range(len(new["cnn"]))
                for k, j in (("running_mean", "mean"),
                             ("running_var", "var"))}

    # the port's updated weights, with the statistics from before the step
    updated = tcio.jax_params_from_state_dict(tpol.state_dict())["map_encoder"]
    for i, blk in params["map_encoder"]["cnn"].items():
        for k in ("mean", "var"):
            updated["cnn"][i]["conv"]["1"][k] = blk["conv"]["1"][k]
    after = jax_stats(updated)
    stale = jax_stats(params["map_encoder"])
    blocks = ("0.",) if lengths == PADDED else tuple(f"{i}." for i in range(4))
    far = 0.0
    for k, v in after.items():
        far = max(far, float(np.abs(stale[k] - v).max()))
        if k.startswith(blocks):
            np.testing.assert_allclose(got[k].numpy(), v, rtol=BN_TOL,
                                       atol=BN_TOL, err_msg=k)
    assert far > 100 * BN_TOL


# -- (d) collection -----------------------------------------------------------
def _collection_config(get_config, root, side):
    config = get_config(MAP_CONFIG, _opts() + [
        "NUM_ENVIRONMENTS", 2,
        "CHECKPOINT_FOLDER", os.path.join(root, side, "ckpts"),
        "TENSORBOARD_DIR", os.path.join(root, side, "tb"),
        "IL.DAGGER.update_size", 2,
        "IL.DAGGER.lmdb_features_dir", os.path.join(root, side, "traj.lmdb"),
        "TPU.world_grid_cells", 256,
        "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", 8,
        "TASK_CONFIG.ENVIRONMENT.ITERATOR_OPTIONS.MAX_SCENE_REPEAT_STEPS", -1,
    ])
    config.defrost()
    config.TASK_CONFIG.TASK.SENSORS.append("SHORTEST_PATH_SENSOR")
    config.freeze()
    return config


@pytest.fixture(scope="module")
def collections(tmp_path_factory):
    """One p = 1 iterative collection by each package, from the same
    weights (the JAX trainer's seeded ones, converted)."""
    os.chdir(REPO)
    root = str(tmp_path_factory.mktemp("collect"))
    jcfg = _collection_config(jax_config, root, "jax")
    register_all()
    tcfg = _collection_config(torch_config, root, "torch")
    ttrainer = torch_registry.get_trainer(tcfg.TRAINER_NAME)(tcfg, "cpu")
    ttrainer._setup_obs_transforms(tcfg)
    ttrainer._initialize_training(tcfg)

    from ivlnce_tpu.mapping.obs_transforms import get_active_obs_transforms

    jtrainer = jax_registry.get_trainer(jcfg.TRAINER_NAME)(jcfg)
    jtrainer.obs_transforms = get_active_obs_transforms(jcfg)
    # the state _initialize_policy leaves, with the port's seeded weights
    # (the JAX package's own initialisation runs op by op: 20 s here)
    jtrainer.policy = jax_registry.get_policy("MapCMAPolicy").from_config(
        jcfg, jtrainer._observation_info(jcfg))
    jtrainer.params = jax.device_put(jax.tree_util.tree_map(
        np.array, tcio.jax_params_from_state_dict(
            ttrainer.policy.state_dict())))
    jtrainer._jit_cache, jtrainer._lane_rows = {}, None
    jtrainer._txt_cache_tokens = None
    random.seed(0)
    jtrainer._update_dataset(0)
    random.seed(0)
    with torch.no_grad():
        ttrainer._update_dataset(0)
    return jtrainer, ttrainer


def test_p1_collection_writes_the_jax_packages_records(collections):
    jtrainer, ttrainer = collections
    with jts.TrajectoryStore(jtrainer.lmdb_features_dir) as jstore, \
            tts.TrajectoryStore(ttrainer.lmdb_features_dir) as tstore:
        assert tstore.count() == jstore.count() >= 2
        for k in range(jstore.count()):
            jobs, jprev, jact = jstore.get(k)
            tobs, tprev, tact = tstore.get(k)
            np.testing.assert_array_equal(tprev, jprev)
            np.testing.assert_array_equal(tact, jact)
            assert tobs.keys() == jobs.keys()
            assert {"depth_features", "occupancy_map",
                    "semantic_map"} <= set(tobs)
            assert "depth" not in tobs and "rgb" not in tobs
            for key in jobs:
                if key == "depth_features":
                    scale = float(np.abs(jobs[key]).max())
                    err = float(np.abs(tobs[key] - jobs[key]).max())
                    assert err <= FEATURE_TOL * scale, (err, scale)
                else:
                    np.testing.assert_array_equal(tobs[key], jobs[key],
                                                  err_msg=key)
            assert int(tobs["occupancy_map"].sum()) > 0
    # K1 and K2's plain versions ran once per collection step here
    assert ttrainer.collection_steps > 0


# -- (e) the checkpoint -------------------------------------------------------
def test_training_checkpoint_reads_back_and_requeues(tmp_path):
    register_all()
    opts = _opts() + ["CHECKPOINT_FOLDER", str(tmp_path / "ckpts"),
                      "TENSORBOARD_DIR", str(tmp_path / "tb")]
    tcfg = torch_config(MAP_CONFIG, opts)
    trainer = torch_registry.get_trainer(tcfg.TRAINER_NAME)(tcfg, "cpu")
    trainer._initialize_training(tcfg)
    batch = _train_batch(trainer.policy)
    for _ in range(2):
        trainer._update_agent(*batch)
    trainer.save_training_checkpoint("ckpt.3.pth", dagger_it=1, epoch=3,
                                     step_id=2)
    path = str(tmp_path / "ckpts" / "ckpt.3.pth")
    state = trainer.policy.state_dict()

    loaded = tbt.load_checkpoint(path)
    assert (loaded["dagger_it"], loaded["epoch"], loaded["step_id"]) == (
        1, 3, 2)
    assert loaded["state_dict"].keys() == state.keys()
    for k, v in state.items():
        assert torch.equal(loaded["state_dict"][k], v), k
    # the JAX package's reader and merge give the same weights
    init = _pair(MAP_CONFIG, _opts(), seed=0)[2]
    jloaded = jcio.load_reference_policy_checkpoint(path)
    assert jloaded["epoch"] == 3 and "optim_state" in jloaded
    merged = params_from_jax(jcio.merge_params(init, jloaded["params"]))
    for k, v in state.items():
        assert torch.equal(merged[k], v), k

    # IL.is_requeue restores Adam's state exactly
    resumed = torch_registry.get_trainer(tcfg.TRAINER_NAME)(
        torch_config(MAP_CONFIG, opts + [
            "IL.load_from_ckpt", True, "IL.is_requeue", True,
            "IL.ckpt_to_load", path]), "cpu")
    resumed._initialize_training(resumed.config)
    assert (resumed.start_epoch, resumed.step_id) == (4, 2)
    want = trainer.optimizer.state_dict()
    got = resumed.optimizer.state_dict()
    assert got["param_groups"] == want["param_groups"]
    assert got["state"].keys() == want["state"].keys()
    for idx, st in want["state"].items():
        for k, v in st.items():
            assert torch.equal(got["state"][idx][k], v), (idx, k)
    for k, v in state.items():
        assert torch.equal(resumed.policy.state_dict()[k], v), k
