"""DAgger / teacher-forcing trainer: the PyTorch counterpart of
``ivlnce_tpu/trainers/dagger_trainer.py`` (reference dagger_trainer.py).

Collection rolls out the policy with beta = p^iter expert mixing. Each
step runs the mapper (K1 accumulate, K2 rasterize, when a mapper obs
transform is enabled), the frozen depth (and LatentCMA's RGB) encoders
and a sampling act on the device, and brings the actions, the encoder
features and the maps back in one copy; the step records keep the
FEATURES instead of the frames, and the built maps, and are written per
episode as msgpack records into the trajectory store. Training replays
length-sorted, block-shuffled trajectories as (T, N) padded batches
through the BPTT train step (``base_trainer.train_step``).

Sampled actions come from a ``torch.Generator`` seeded with
``TASK_CONFIG.SEED + data_it``; the beta mix draws from numpy's
``default_rng`` with the same seed, as in the JAX package. Under p = 1
(beta = 1) every executed and stored action is the expert's, so the
stores equal the JAX package's; with beta < 1 the policy's own draws
cannot match JAX's PRNG, and the stores differ where they are used."""

from __future__ import annotations

import contextlib
import os
import random
import time
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from ivlnce_tpu_torch.envs.vector_env import construct_envs
from ivlnce_tpu_torch.trainers.base_trainer import BaseVLNCETrainer
from ivlnce_tpu_torch.trainers.trajectory_store import TrajectoryStore
from ivlnce_tpu_torch.utils import batching, logging_util, profiling
from ivlnce_tpu_torch.utils.batching import batch_obs
from ivlnce_tpu_torch.utils.prefetch import prefetch
from ivlnce_tpu_torch.utils.registry import registry
from ivlnce_tpu_torch.utils.tb import TensorboardWriter

logger = logging_util.logger


def _block_shuffle(lst: List, block_size: int, rng=None) -> List:
    blocks = [
        lst[i:i + block_size] for i in range(0, len(lst), block_size)
    ]
    (rng or random).shuffle(blocks)
    return [ele for block in blocks for ele in block]


# -- shared sampling recipe (serial IWTrajectoryDataset + decode workers) ----
# ONE implementation of the window ordering (length sort with a shuffled
# tiebreak, then batch-block shuffle — dagger_trainer.py:196-216) and of
# the per-record sample construction (inflection weighting, :218-233),
# so IL.decode_workers>0 trains on identically-prepared data as the
# serial path.

def _window_order(lengths: List[int], batch_size: int, rng=None) -> List[int]:
    sort_priority = list(range(len(lengths)))
    (rng or random).shuffle(sort_priority)
    sorted_ordering = sorted(
        range(len(lengths)), key=lambda k: (lengths[k], sort_priority[k])
    )
    return _block_shuffle(sorted_ordering, batch_size, rng=rng)


def _make_sample(record: Tuple, inflec_weights: np.ndarray) -> Tuple:
    obs, prev_actions, oracle_actions = record
    obs = {k: np.asarray(v) for k, v in obs.items()}
    prev_actions = np.asarray(prev_actions)
    oracle_actions = np.asarray(oracle_actions)
    inflections = np.concatenate(
        [[1], (oracle_actions[1:] != oracle_actions[:-1]).astype(np.int64)]
    )
    return (
        obs,
        prev_actions,
        oracle_actions,
        np.asarray(inflec_weights)[inflections],
    )


# per-process store handle for the decode workers (one open per worker
# process, reused across its windows)
_worker_store_cache: Dict[str, "TrajectoryStore"] = {}


def _decode_window(task) -> List[Tuple]:
    """Decode + collate one preload window in a worker process
    (utils/prefetch.ProcessWindowIterator). Uses the same _window_order /
    _make_sample recipe as the serial path (seeded rng), then collates
    consecutive batch_size samples (drop_last inside the window — windows
    are batch_size-divisible except the epoch tail, identical to the
    serial path's end-of-epoch drop)."""
    store_path, keys, seed, batch_size, inflec_weights = task
    store = _worker_store_cache.get(store_path)
    if store is None:
        store = TrajectoryStore(store_path)
        _worker_store_cache[store_path] = store
    rng = random.Random(seed)

    raw = [store.get(k) for k in keys]
    order = _window_order([len(r[1]) for r in raw], batch_size, rng=rng)
    samples = [_make_sample(raw[idx], inflec_weights) for idx in order]
    return [
        collate_fn(samples[i:i + batch_size])
        for i in range(0, len(samples) - batch_size + 1, batch_size)
    ]


def _pad_to(arr: np.ndarray, max_len: int, fill_val=0) -> np.ndarray:
    pad = max_len - arr.shape[0]
    if pad == 0:
        return arr
    pad_block = np.full((pad,) + arr.shape[1:], fill_val, arr.dtype)
    return np.concatenate([arr, pad_block], 0)


def collate_fn(batch: List[Tuple]) -> Tuple:
    """Pad T and flatten T-major (dagger_trainer.py:42-117). Padded obs
    fill value is 1.0 like the reference."""
    obs_list, prev_list, corr_list, weight_list = zip(*batch)
    max_t = max(p.shape[0] for p in prev_list)

    obs_out: Dict[str, np.ndarray] = {}
    for sensor in obs_list[0]:
        stacked = np.stack(
            [_pad_to(np.asarray(o[sensor]), max_t, 1.0) for o in obs_list],
            axis=1,
        )  # (T, N, ...)
        obs_out[sensor] = stacked.reshape((-1,) + stacked.shape[2:])

    prev_actions = np.stack(
        [_pad_to(np.asarray(p), max_t) for p in prev_list], 1
    )
    corrected = np.stack(
        [_pad_to(np.asarray(c), max_t) for c in corr_list], 1
    )
    weights = np.stack(
        [_pad_to(np.asarray(w), max_t) for w in weight_list], 1
    )
    not_done_masks = np.ones_like(corrected, np.uint8)
    not_done_masks[0] = 0

    return (
        obs_out,
        prev_actions.reshape(-1, 1),
        not_done_masks.reshape(-1, 1),
        corrected,
        weights,
    )


class IWTrajectoryDataset:
    """Inflection-weighted trajectory stream (dagger_trainer.py:127-234):
    block-shuffled load order, preload window sorted by length then
    re-block-shuffled so batches have similar T."""

    def __init__(
        self,
        store_path: str,
        use_iw: bool,
        inflection_weight_coef: float = 1.0,
        batch_size: int = 1,
    ):
        self.store_path = store_path
        self.batch_size = batch_size
        self.preload_size = batch_size * 100
        self._preload: List = []
        if use_iw:
            self.inflec_weights = np.array([1.0, inflection_weight_coef])
        else:
            self.inflec_weights = np.array([1.0, 1.0])
        with TrajectoryStore(store_path) as store:
            self.length = store.count()
            # key 0 holds the tours index after iterative collection
            # (iterative_collection_dagger_trainer.py:377-385)
            self.start = 1 if self._has_tours_index(store) else 0

    @staticmethod
    def _has_tours_index(store) -> bool:
        try:
            v = store.get(0)
            return isinstance(v, dict) and "tours_to_idxs" in v
        except KeyError:
            return False

    def __iter__(self) -> Iterator:
        self.load_ordering = list(
            reversed(
                _block_shuffle(
                    list(range(self.start, self.length)), self.preload_size
                )
            )
        )
        self._store = TrajectoryStore(self.store_path)
        self._preload = []
        return self

    def _load_next(self):
        if len(self._preload) == 0:
            if len(self.load_ordering) == 0:
                self._store.close()
                raise StopIteration
            new_preload = []
            lengths = []
            for _ in range(self.preload_size):
                if len(self.load_ordering) == 0:
                    break
                new_preload.append(
                    self._store.get(self.load_ordering.pop())
                )
                lengths.append(len(new_preload[-1][1]))

            for idx in _window_order(lengths, self.batch_size):
                self._preload.append(new_preload[idx])
        return self._preload.pop()

    def __next__(self):
        return _make_sample(self._load_next(), self.inflec_weights)

    def batches(self) -> Iterator[Tuple]:
        """Yield collated full batches (drop_last=True like the
        reference's DataLoader)."""
        it = iter(self)
        while True:
            samples = []
            try:
                for _ in range(self.batch_size):
                    samples.append(next(it))
            except StopIteration:
                return
            yield collate_fn(samples)

    def batches_parallel(self, workers: int, depth: int = 4):
        """Collated batches with store read + msgpack decode + collate
        running in ``workers`` processes (the reference's DataLoader
        num_workers equivalent, dagger_trainer.py:568-576). Windows use
        the same _window_order/_make_sample recipe as batches() with a
        seeded rng; traversal ORDER differs from the serial path (which
        reverses for O(1) pop()) — both are shuffles of the same window
        partition, like the reference's worker sharding. Returns a
        context-manager iterator (close() terminates workers)."""
        from ivlnce_tpu_torch.utils.prefetch import ProcessWindowIterator

        ordering = _block_shuffle(
            list(range(self.start, self.length)), self.preload_size
        )
        windows = [
            ordering[i:i + self.preload_size]
            for i in range(0, len(ordering), self.preload_size)
        ]
        tasks = [
            (
                self.store_path,
                w,
                random.randrange(2**31),
                self.batch_size,
                tuple(self.inflec_weights),
            )
            for w in windows
        ]
        return ProcessWindowIterator(
            _decode_window, tasks, workers=workers, depth=depth
        )


def _to_host(tensors: List[torch.Tensor]) -> List[np.ndarray]:
    """Several device tensors brought to the host in ONE copy: their bytes
    are packed into one buffer on the device (widest dtypes first, so each
    array stays aligned) and split again on the host."""
    order = sorted(range(len(tensors)),
                   key=lambda i: -tensors[i].element_size())
    flat = torch.cat([tensors[i].contiguous().reshape(-1).view(torch.uint8)
                      for i in order])
    host = flat.cpu().numpy()
    out: List = [None] * len(tensors)
    offset = 0
    for i in order:
        t = tensors[i]
        nbytes = t.numel() * t.element_size()
        dtype = torch.empty((), dtype=t.dtype).numpy().dtype
        out[i] = host[offset:offset + nbytes].view(dtype).reshape(t.shape)
        offset += nbytes
    return out


def _record_step_obs(observation: Dict, features: Dict, batch: Dict, i: int,
                     drop_rgb: bool) -> Dict:
    """One lane's step record: the frozen-encoder features in place of the
    frames, the built maps in place of the mapper's inputs, no strings
    (dagger_trainer.py:404-431)."""
    step_obs = dict(observation)
    if "depth_features" in features:
        step_obs["depth_features"] = features["depth_features"][i]
        step_obs.pop("depth", None)
    if "rgb_features" in features:
        step_obs["rgb_features"] = features["rgb_features"][i]
        step_obs.pop("rgb", None)
    if drop_rgb:
        step_obs.pop("rgb", None)
    map_k_sum = int("occupancy_map" in batch) + int("semantic_map" in batch)
    if map_k_sum == 1:
        raise RuntimeError(
            "either both map keys should exist in the batch or neither"
        )
    if map_k_sum == 2:
        for k in ["occupancy_map", "semantic_map"]:
            step_obs[k] = np.asarray(batch[k][i])
        for k in ["semantic", "semantic12", "world_robot_pose",
                  "world_robot_orientation", "env_name", "rgb"]:
            step_obs.pop(k, None)
    step_obs.pop("not_done_masks", None)
    step_obs.pop("env_name", None)
    return step_obs


@registry.register_trainer(name="dagger")
class DaggerTrainer(BaseVLNCETrainer):
    def __init__(self, config, device=None):
        self.lmdb_features_dir = config.IL.DAGGER.lmdb_features_dir.format(
            split=config.TASK_CONFIG.DATASET.SPLIT
        )
        super().__init__(config, device)
        # collection steps over the trainer's collections (each launches
        # the mapper kernels once when a mapper transform is enabled)
        self.collection_steps = 0
        self.collection_env_steps = 0
        self.collection_seconds = 0.0
        self.run_seconds = 0.0
        # (loss, action loss, aux loss) of every train step
        self.losses: List[Tuple[float, float, float]] = []

    # -- collection (dagger_trainer.py:251-504) -------------------------------
    def _update_dataset(self, data_it: int, save_tour_idx_data: bool = False):
        config = self.config
        env_class = registry.get_env(config.ENV_NAME)
        envs = construct_envs(config, env_class)
        expert_uuid = config.IL.DAGGER.expert_policy_sensor_uuid
        self._lane_rows = None  # fresh env set per dagger iteration
        for transform in self.obs_transforms:
            transform.reset()

        rnn_states = self.policy.initial_rnn_states(envs.num_envs,
                                                    self.device)
        prev_actions = np.zeros((envs.num_envs, 1), np.int64)
        not_done_masks = np.zeros((envs.num_envs, 1), np.uint8)

        observations = envs.reset()
        observations = self._extract_tokens(observations)
        batch = batch_obs(observations)

        episodes: List[List] = [[] for _ in range(envs.num_envs)]
        skips = np.zeros(envs.num_envs, bool)
        dones = [False for _ in range(envs.num_envs)]

        p = config.IL.DAGGER.p
        beta = 0.0 if p == 0.0 else p ** data_it
        ensure_unique_episodes = beta == 1.0

        rng = np.random.default_rng(config.TASK_CONFIG.SEED + data_it)
        self._collect_generator(config.TASK_CONFIG.SEED + data_it)

        collected_eps = 0
        ep_ids_collected = None
        if ensure_unique_episodes:
            ep_ids_collected = {
                info["episode_id"]
                for info in self._current_episode_info(envs)
            }

        store = TrajectoryStore(self.lmdb_features_dir, writable=True)
        start_id = store.count()
        commit_freq = config.IL.DAGGER.lmdb_commit_frequency

        while collected_eps < config.IL.DAGGER.update_size:
            current_episodes = None
            envs_to_pause = []
            if ensure_unique_episodes:
                current_episodes = self._current_episode_info(envs)

            for i in range(envs.num_envs):
                if dones[i] and not skips[i]:
                    ep = episodes[i]
                    traj_obs = batch_obs(
                        [step[0] for step in ep], ignore_keys=set()
                    )
                    traj_obs.pop(expert_uuid, None)
                    if config.IL.DAGGER.lmdb_fp16:
                        for k, v in traj_obs.items():
                            if v.dtype == np.float32:
                                traj_obs[k] = v.astype(np.float16)
                    record = [
                        traj_obs,
                        np.array([s[1] for s in ep], np.int64),
                        np.array([s[2] for s in ep], np.int64),
                    ]
                    store.put(start_id + collected_eps, record)
                    collected_eps += 1
                    if collected_eps % commit_freq == 0:
                        store.sync()
                    if ensure_unique_episodes:
                        if (
                            current_episodes[i]["episode_id"]
                            in ep_ids_collected
                        ):
                            envs_to_pause.append(i)
                        else:
                            ep_ids_collected.add(
                                current_episodes[i]["episode_id"]
                            )
                if dones[i]:
                    episodes[i] = []

            if ensure_unique_episodes:
                (
                    envs, not_done_masks, prev_actions, batch, _,
                ) = self._pause_envs(
                    envs_to_pause, envs, not_done_masks,
                    prev_actions, batch=batch,
                )
                if envs_to_pause:
                    # the host-side per-lane lists are compacted too, so
                    # lanes stay aligned (JAX dagger_trainer.py:366-380)
                    keep = [
                        i
                        for i in range(len(episodes))
                        if i not in envs_to_pause
                    ]
                    episodes = [episodes[i] for i in keep]
                    observations = [observations[i] for i in keep]
                    dones = [dones[i] for i in keep]
                    skips = skips[np.asarray(keep, dtype=np.int64)]
                if envs.num_envs == 0:
                    break

            with profiling.wall_range("policy_step"):
                actions, rnn_states, features, batch = self._collect_step(
                    batch, not_done_masks, rnn_states, prev_actions,
                    (not_done_masks,), iterative=False,
                )

            expert_actions = np.asarray(batch[expert_uuid]).reshape(-1, 1)
            mix = rng.random(actions.shape) < beta
            actions = np.where(mix, expert_actions.astype(actions.dtype),
                               actions)

            # dispatch the sims now; the episode-append host work below
            # overlaps the simulation
            step_actions = np.where(
                (expert_actions.reshape(-1) == -1)[:, None], 0, actions
            )
            envs.step_async([int(a[0]) for a in step_actions])

            for i in range(envs.num_envs):
                episodes[i].append(
                    (
                        _record_step_obs(observations[i], features, batch,
                                         i, drop_rgb=False),
                        int(prev_actions[i, 0]),
                        int(expert_actions[i, 0]),
                    )
                )

            skips = (expert_actions.reshape(-1) == -1)
            prev_actions = step_actions

            with profiling.wall_range("env_step_wait"):
                outputs = envs.step_wait()
            observations, _, dones, _ = (list(x) for x in zip(*outputs))
            not_done_masks = np.array(
                [[0] if d else [1] for d in dones], np.uint8
            )
            with profiling.wall_range("batch_obs"):
                observations = self._extract_tokens(observations)
                batch = batch_obs(observations)

        store.sync()
        store.close()
        envs.close()
        # truncated maps must not silently enter the training store:
        # the dropped-point telemetry at the end of every collection
        dropped = sum(
            t.warn_if_dropped(f"dagger collection it={data_it}")
            for t in self.obs_transforms
        )
        logger.info(
            f"collected {collected_eps} episodes (beta={beta:.3f}, "
            f"dropped_map_points={dropped})"
        )

    # -- one collection step on the device ------------------------------------
    def _collect_generator(self, seed: int) -> None:
        """The sampling act's generator for one collection pass."""
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)

    def _encode_feats(self, obs: Dict[str, torch.Tensor]) -> Dict:
        """The frozen encoders' features (the reference takes them with
        forward hooks, dagger_trainer.py:301-323): the same activations
        feed the act and the stored trajectory."""
        cfg = self.config.MODEL
        net = self.policy.net
        feats = {}
        if not cfg.DEPTH_ENCODER.trainable and "depth" in obs:
            feats["depth_features"] = net.depth_encoder(obs["depth"])
        if (cfg.policy_name == "LatentCMAPolicy"
                and not cfg.RGB_ENCODER.trainable and "rgb" in obs):
            with torch.profiler.record_function("rgb_encoder"):
                feats["rgb_features"] = net.rgb_encoder(obs["rgb"])
        return feats

    def _collect_step(self, batch, reset_masks, rnn_states, prev_actions,
                      masks, iterative: bool):
        """One fixed-lane collection step: the mapper (K1, K2) when a
        transform is enabled, the frozen encoders' features and a sampling
        act (``act_iterative`` with ``masks`` = (agent, sim, tour, action),
        else ``act`` with (not_done,)). The actions, the features and the
        maps come back in one device-to-host copy. Returns (live-lane
        actions (live, 1), full-width rnn_states on the device, live-lane
        features, ``batch`` with the live lanes' maps)."""
        self.collection_steps += 1
        if self._lane_rows is None or rnn_states.shape[0] != self._num_rows:
            self._reset_lanes(rnn_states.shape[0])
        rows = self._lane_rows
        self.collection_env_steps += len(rows)
        transform = self.obs_transforms[0] if self.obs_transforms else None
        if transform is not None:
            transform.host_prepare(
                batch, np.asarray(reset_masks).reshape(-1), rows=rows,
                num_rows=self._num_rows,
            )
        obs = batching.decode_wire_obs(self._wire_device_obs(batch, transform))

        def dev(a, dtype):
            return torch.as_tensor(self._expand_rows(a), dtype=dtype,
                                   device=self.device)

        masks_full = [dev(m, torch.float32) for m in masks]
        prev_full = dev(prev_actions, torch.int64)
        with profiling.range_context("collect_step"):
            with torch.profiler.record_function("encoders"):
                feats = self._encode_feats(obs)
            pobs = dict(obs, **feats)
            if transform is not None:
                reset_full = self._expand_rows(
                    np.asarray(reset_masks, np.float32).reshape(-1, 1)
                )
                with torch.profiler.record_function("mapper"):
                    state, occ, sem = self._device_step(
                        transform.state, obs, reset_full.reshape(-1),
                        transform.rednet,
                    )
                transform.state = state
                pobs.update(occupancy_map=occ, semantic_map=sem)
            act = self.policy.act_iterative if iterative else self.policy.act
            out = act(pobs, rnn_states, prev_full, *masks_full,
                      generator=self._generator)
            keys = sorted(feats)
            fetch = [out.actions] + [feats[k] for k in keys]
            if transform is not None:
                fetch += [occ, sem]
            got = _to_host(fetch)
        features = {k: got[1 + i][rows] for i, k in enumerate(keys)}
        if transform is not None:
            batch["occupancy_map"] = got[-2][rows]
            batch["semantic_map"] = got[-1][rows]
        return got[0][rows], out.rnn_states, features, batch

    # -- training (dagger_trainer.py:506-649) ---------------------------------
    def _collect(self, data_it: int, **kwargs):
        """One collection pass, timed and without autograd; returns what
        ``_update_dataset`` returns."""
        t0 = time.perf_counter()
        with torch.no_grad():
            out = self._update_dataset(data_it, **kwargs)
        self.collection_seconds += time.perf_counter() - t0
        return out

    def train(self) -> None:
        t0 = time.perf_counter()
        profiling.reset_phases()
        try:
            self._train()
        finally:
            # the last asynchronous checkpoint is on disk, or its error
            # raised, before train() returns
            self.checkpoint_writer.wait()
            self.run_seconds = time.perf_counter() - t0

    def _log_train_step(self, writer, dagger_it: int, epoch: int,
                        step_id: int, loss: float, action_loss: float,
                        aux_loss: float) -> None:
        """One train step's loss terms: the log line, the TensorBoard
        scalars and ``self.losses``."""
        logger.info(
            f"train_loss: {loss:.4f} action: {action_loss:.4f} aux: "
            f"{aux_loss:.4f} (dagger {dagger_it} epoch {epoch} batch "
            f"{step_id})"
        )
        writer.add_scalar(f"train_loss_iter_{dagger_it}", loss, step_id)
        writer.add_scalar(f"train_action_loss_iter_{dagger_it}", action_loss,
                          step_id)
        writer.add_scalar(f"train_aux_loss_iter_{dagger_it}", aux_loss,
                          step_id)
        self.losses.append((loss, action_loss, aux_loss))

    def _start_training(self):
        """What a training run does before its first collection: refuse
        what the port cannot do, check (``IL.DAGGER.preload_lmdb_features``)
        or drop the store, add the expert sensor to the config, and build
        the obs transforms, the policy and its optimizer. Returns the
        run's config."""
        config = self.config
        self._check_training_options(config)
        if config.IL.DAGGER.preload_lmdb_features:
            with TrajectoryStore(self.lmdb_features_dir) as store:
                if store.count() == 0:
                    raise RuntimeError(
                        "Cannot open database for teacher forcing preload."
                    )
        else:
            TrajectoryStore.drop(self.lmdb_features_dir)

        config = config.clone()
        eps = config.IL.DAGGER.expert_policy_sensor
        if eps not in config.TASK_CONFIG.TASK.SENSORS:
            config.TASK_CONFIG.TASK.SENSORS.append(eps)
        if config.IL.DAGGER.p == 1.0:
            config.TASK_CONFIG.ENVIRONMENT.ITERATOR_OPTIONS.MAX_SCENE_REPEAT_STEPS = -1
        config.freeze()
        self.config = config

        self._setup_obs_transforms(config)
        self._initialize_training(config)
        os.makedirs(config.TENSORBOARD_DIR, exist_ok=True)
        return config

    def _train(self) -> None:
        config = self._start_training()
        with TensorboardWriter(
            config.TENSORBOARD_DIR, flush_secs=self.flush_secs
        ) as writer:
            for dagger_it in range(config.IL.DAGGER.iterations):
                step_id = 0
                if not config.IL.DAGGER.preload_lmdb_features:
                    self._collect(
                        dagger_it + (1 if config.IL.load_from_ckpt else 0)
                    )

                dataset = IWTrajectoryDataset(
                    self.lmdb_features_dir,
                    config.IL.use_iw,
                    inflection_weight_coef=config.IL.inflection_weight_coef,
                    batch_size=config.IL.batch_size,
                )
                for epoch in range(config.IL.epochs):
                    # decode/collate the next batches while the device
                    # runs the current update; IL.decode_workers > 0
                    # moves decode into worker processes. The with block
                    # stops the producer on early exits.
                    workers = config.IL.decode_workers
                    with contextlib.ExitStack() as stack:
                        source = (
                            stack.enter_context(
                                dataset.batches_parallel(workers)
                            )
                            if workers > 0
                            else dataset.batches()
                        )
                        batches = stack.enter_context(
                            prefetch(source, depth=3)
                        )
                        for batch in batches:
                            (
                                observations, prev_actions, not_done_masks,
                                corrected, weights,
                            ) = batch
                            loss, action_loss, aux_loss, _ = self._update_agent(
                                {
                                    k: v.astype(np.float32)
                                    if v.dtype == np.float16
                                    else v
                                    for k, v in observations.items()
                                },
                                prev_actions,
                                not_done_masks,
                                corrected,
                                weights,
                            )
                            self._log_train_step(
                                writer, dagger_it, epoch, step_id, loss,
                                action_loss, aux_loss)
                            step_id += 1

                    self.save_training_checkpoint(
                        f"ckpt.{dagger_it * config.IL.epochs + epoch}.pth",
                        dagger_it=dagger_it,
                        epoch=epoch,
                        step_id=step_id,
                    )
