"""VLN-CE evaluation trainer: the PyTorch counterpart of the eval half of
``ivlnce_tpu/trainers/base_trainer.py`` (reference
ivlnce_baselines/common/base_il_trainer.py:313-928).

Episodic and iterative (tour) evaluation: each env step runs the mapper
obs transform, when one is enabled, and the policy on the device
(``_policy_step``) and brings back the actions; lanes keep a fixed row
count while envs pause. Stats JSONs and tour-nDTW are written as the JAX
package writes them. The registered trainers (``dagger_trainer.py`` and
its two iterative subclasses) are this class under the reference's
names; training waits for a later slice of the port."""

from __future__ import annotations

import contextlib
import json
import numbers
import os
import time
from collections import defaultdict
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from ivlnce_tpu_torch.envs.vector_env import construct_envs_auto_reset_false
from ivlnce_tpu_torch.mapping.obs_transforms import get_active_obs_transforms
from ivlnce_tpu_torch.tasks.tour_ndtw import compute_tour_ndtw
from ivlnce_tpu_torch.utils import batching, logging_util
from ivlnce_tpu_torch.utils.batching import batch_obs, extract_instruction_tokens
from ivlnce_tpu_torch.utils.device import resolve_device
from ivlnce_tpu_torch.utils.registry import registry
from ivlnce_tpu_torch.utils.tb import TensorboardWriter

logger = logging_util.logger

EVAL_METRICS = (
    "distance_to_goal success spl ndtw path_length oracle_success "
    "steps_taken".split()
)


def save_checkpoint(policy, config, path: str, **meta) -> None:
    """The port's checkpoint: ``torch.save({"state_dict", "config",
    ...})``."""
    torch.save(
        {"state_dict": policy.state_dict(), "config": config.to_dict(),
         **meta},
        path,
    )


def load_checkpoint(path: str) -> Dict[str, Any]:
    return torch.load(path, map_location="cpu", weights_only=True)


class BaseVLNCETrainer:
    """Evaluation of a MapCMA or LatentCMA checkpoint on the device given
    by ``device`` ("cuda" unless the caller asks for "cpu")."""

    def __init__(self, config, device: Optional[str] = None):
        self.config = config
        self.device = resolve_device(device)
        self.policy = None
        self.obs_transforms = []
        self.flush_secs = 30
        self._lane_rows = None
        self._txt_cache_tokens = None
        self._device_step = None
        self._generator = None
        # policy steps and instruction bi-LSTM runs (once per episode
        # change, not per step) over the trainer's evals
        self.policy_steps = 0
        self.instruction_encodes = 0
        os.makedirs(config.CHECKPOINT_FOLDER, exist_ok=True)
        if config.EVAL.SAVE_RESULTS:
            os.makedirs(config.RESULTS_DIR, exist_ok=True)

    # -- policy ----------------------------------------------------------------
    def _observation_info(self, config) -> Dict:
        """Sensor sizes the nets are built for; LatentCMA ignores map_hw."""
        mapper = config.RL.POLICY.OBS_TRANSFORMS.EGOCENTRIC_MAPPER
        return {
            "depth_hw": config.TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.HEIGHT,
            "map_hw": int(
                np.ceil(mapper.height_meters / mapper.resolution_meters)
            ),
        }

    def _initialize_policy(self, config, checkpoint_path: str) -> None:
        policy_cls = registry.get_policy(config.MODEL.policy_name)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(config.TASK_CONFIG.SEED)
            policy = policy_cls.from_config(
                config, self._observation_info(config)
            )
        policy.load_state_dict(load_checkpoint(checkpoint_path)["state_dict"])
        self.policy = policy.to(self.device).eval()
        n_params = sum(p.numel() for p in policy.parameters())
        logger.info(f"Loaded weights from checkpoint: {checkpoint_path}")
        logger.info(f"Agent parameters: {n_params}.")
        self._lane_rows = None
        self._txt_cache_tokens = None
        # EVAL.SAMPLE: actions drawn with a generator on the policy's
        # device seeded from TASK_CONFIG.SEED (base_il_trainer.py:452,699)
        self._generator = None
        if config.EVAL.SAMPLE:
            self._generator = torch.Generator(device=self.device)
            self._generator.manual_seed(config.TASK_CONFIG.SEED)

    def _setup_obs_transforms(self, config) -> None:
        """The enabled mapper obs transform and its device step; none for
        a policy that reads no map (LatentCMA)."""
        self.obs_transforms = get_active_obs_transforms(config, self.device)
        self._device_step = (
            self.obs_transforms[0].make_device_step()
            if self.obs_transforms else None
        )

    def _extract_tokens(self, observations):
        return extract_instruction_tokens(
            observations, self.config.TASK_CONFIG.TASK.INSTRUCTION_SENSOR_UUID
        )

    # -- fixed-lane bookkeeping -------------------------------------------------
    # Device state (RNN hidden, world grid) keeps its first lane count for
    # a whole run; when an env pauses, only the host-side lane map shrinks.
    def _reset_lanes(self, num_lanes: int) -> None:
        self._lane_rows = np.arange(num_lanes)
        self._num_rows = num_lanes

    def _pause_lane(self, index: int) -> None:
        if self._lane_rows is not None:
            self._lane_rows = np.delete(self._lane_rows, index)

    def _expand_rows(self, arr, fill=0):
        """Scatter a live-lane host array into full-width rows."""
        arr = np.asarray(arr)
        rows = self._lane_rows
        if len(rows) == self._num_rows:
            return arr
        full = np.full((self._num_rows,) + arr.shape[1:], fill, arr.dtype)
        full[rows] = arr
        return full

    # -- one env step on the device ---------------------------------------------
    def _wire_device_obs(self, batch, transform) -> Dict[str, Any]:
        """Full-width obs for one step: only the keys the step reads; depth
        as uint16, uploaded with the semantic or RGB frame; pose,
        orientation and scene centres stay on the host; instruction tokens
        become cached features."""
        wire_keys = batching.wire_obs_keys(self.policy, transform)
        dobs = {
            k: self._expand_rows(v)
            for k, v in batch.items()
            if not (isinstance(v, list) and isinstance(v[0], str))
            and k not in ("occupancy_map", "semantic_map")
            and (wire_keys is None or k in wire_keys)
        }
        dobs = batching.encode_wire_obs(
            dobs, self.config.TPU.wire_depth_uint16
        )
        for k, v in dobs.items():
            if k not in batching.HOST_OBS_KEYS:
                dobs[k] = torch.from_numpy(np.ascontiguousarray(v)).to(
                    self.device
                )
        return self._cache_instruction_features(dobs)

    def _cache_instruction_features(self, dobs):
        """Encode the instruction bi-LSTM once per episode: the tokens (or
        RxR's precomputed features) are compared on the host, and only on
        a change (an episode boundary) uploaded and re-encoded; the step
        reads the cached per-token features."""
        key = next((k for k in ("instruction", "rxr_instruction")
                    if k in dobs), None)
        if key is None:
            return dobs
        tokens = np.asarray(dobs[key])
        if self._txt_cache_tokens is None or not np.array_equal(
            tokens, self._txt_cache_tokens
        ):
            t = torch.from_numpy(tokens).to(self.device)
            with record_function("instruction_encoder"):
                self._txt_cache = self.policy.net.instruction_encoder(
                    {key: t}
                )
            self._txt_cache_tokens = tokens.copy()
            self.instruction_encodes += 1
        dobs = dict(dobs)
        del dobs[key]
        dobs["instruction_features"] = self._txt_cache
        return dobs

    def _policy_step(self, batch, reset_masks, rnn_states, prev_actions,
                     masks, iterative: bool = True):
        """Mapper step, when a transform is enabled, then ``act_iterative``
        (``masks`` is (agent, sim, tour, action)) or, with ``iterative``
        False, ``act`` (``masks`` is (not_done,)) for the live lanes.
        Returns (actions (live, 1) host array, full-width rnn_states on
        the device)."""
        self.policy_steps += 1
        if self._lane_rows is None or rnn_states.shape[0] != self._num_rows:
            self._reset_lanes(rnn_states.shape[0])
        rows = self._lane_rows
        transform = self.obs_transforms[0] if self.obs_transforms else None
        if transform is not None:
            # before the wire obs: host_prepare may add scene_center to the
            # batch besides allocating state and preloading known maps
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
        if transform is not None:
            reset_full = self._expand_rows(
                np.asarray(reset_masks, np.float32).reshape(-1, 1)
            )
            with record_function("mapper"):
                state, occ, sem = self._device_step(
                    transform.state, obs, reset_full.reshape(-1),
                    transform.rednet,
                )
            transform.state = state
            obs = dict(obs, occupancy_map=occ, semantic_map=sem)
        act = self.policy.act_iterative if iterative else self.policy.act
        out = act(obs, rnn_states, prev_full, *masks_full,
                  generator=self._generator)
        return out.actions.cpu().numpy()[rows], out.rnn_states

    def _pause_envs(self, envs_to_pause, envs, *arrays, batch=None):
        if len(envs_to_pause) > 0:
            state_index = list(range(envs.num_envs))
            for idx in reversed(envs_to_pause):
                state_index.pop(idx)
                envs.pause_at(idx)
                self._pause_lane(idx)
            keep = np.asarray(state_index, dtype=np.int64)
            arrays = tuple(np.asarray(a)[keep] for a in arrays)
            if batch is not None:
                for k, v in batch.items():
                    if isinstance(v, list):
                        batch[k] = [v[i] for i in state_index]
                    else:
                        batch[k] = np.asarray(v)[keep]
        return (envs,) + arrays + (batch,)

    # -- eval entry point ---------------------------------------------------------
    def eval(self) -> None:
        os.makedirs(self.config.TENSORBOARD_DIR, exist_ok=True)
        with TensorboardWriter(
            self.config.TENSORBOARD_DIR, flush_secs=self.flush_secs
        ) as writer:
            ckpt_dir = self.config.EVAL_CKPT_PATH_DIR
            if os.path.isfile(ckpt_dir):
                ckpt_index = 0
                with contextlib.suppress(ValueError, IndexError):
                    ckpt_index = int(ckpt_dir.split(".")[-2])
                self._eval_checkpoint(ckpt_dir, writer, ckpt_index)
            else:
                ckpts = sorted(
                    (f for f in os.listdir(ckpt_dir) if f.startswith("ckpt.")),
                    key=lambda f: int(f.split(".")[1]),
                )
                for f in ckpts:
                    self._eval_checkpoint(
                        os.path.join(ckpt_dir, f), writer,
                        int(f.split(".")[1]),
                    )

    def _setup_eval_config(self, checkpoint_config):
        """Merge a checkpoint's saved config under the eval config
        (overwrite priority: eval_opts > ckpt_opts > eval_cfg > ckpt_cfg)."""
        from ivlnce_tpu_torch.config.node import ConfigNode as CN

        if isinstance(checkpoint_config, dict):
            checkpoint_config = CN(checkpoint_config)
        config = self.config.clone()
        ckpt_cmd_opts = list(checkpoint_config.CMD_TRAILING_OPTS) if (
            "CMD_TRAILING_OPTS" in checkpoint_config
        ) else []
        eval_cmd_opts = list(config.CMD_TRAILING_OPTS)
        try:
            config.merge_from_other_cfg(checkpoint_config)
            config.merge_from_other_cfg(self.config)
            config.merge_from_list(ckpt_cmd_opts)
            config.merge_from_list(eval_cmd_opts)
        except KeyError:
            logger.info("Saved config is outdated, using solely eval config")
            config = self.config.clone()
            config.merge_from_list(eval_cmd_opts)
        if config.TASK_CONFIG.DATASET.SPLIT == "train":
            config.TASK_CONFIG.DATASET.SPLIT = "val"
        config.TASK_CONFIG.SIMULATOR.AGENT_0.SENSORS = list(
            self.config.SENSORS
        )
        return config

    def _eval_checkpoint(self, checkpoint_path: str, writer,
                         checkpoint_index: int = 0):
        start_from = self.config.EVAL.START_FROM
        if 0 <= start_from > checkpoint_index:
            logger.info(f"skipping ckpt: starting from {start_from}.")
            return None
        logger.info(f"checkpoint_path: {checkpoint_path}")
        if self.config.EVAL.USE_CKPT_CONFIG:
            config = self._setup_eval_config(
                load_checkpoint(checkpoint_path).get("config", {})
            )
        else:
            config = self.config.clone()
        config.TASK_CONFIG.DATASET.SPLIT = config.EVAL.SPLIT
        config.TASK_CONFIG.DATASET.ROLES = ["guide"]
        config.TASK_CONFIG.DATASET.LANGUAGES = config.EVAL.LANGUAGES
        config.TASK_CONFIG.TASK.NDTW.SPLIT = config.EVAL.SPLIT
        opts = config.TASK_CONFIG.ENVIRONMENT.ITERATOR_OPTIONS
        opts.SHUFFLE = False
        opts.MAX_SCENE_REPEAT_STEPS = -1
        opts.SHUFFLE_TOURS = False
        opts.SHUFFLE_EPISODES = False
        config.IL.ckpt_to_load = checkpoint_path
        config.freeze()
        if len(config.VIDEO_OPTION) > 0:
            raise NotImplementedError("videos wait for a later slice")
        with torch.inference_mode():
            if config.TASK_CONFIG.ENVIRONMENT.ITERATIVE.ENABLED:
                return self._eval_checkpoint_iterative(
                    config, writer, checkpoint_index
                )
            return self._eval_checkpoint_episodic(
                config, writer, checkpoint_index
            )

    def _eval_checkpoint_episodic(self, config, writer,
                                  checkpoint_index: int = 0):
        """The episodic loop (base_il_trainer.py:313-583): each lane walks
        its episodes with the GRUs, and the map, restarted at every
        episode; a lane pauses when its next episode was evaluated."""
        split = config.TASK_CONFIG.DATASET.SPLIT
        fname = os.path.join(
            config.RESULTS_DIR, f"stats_ckpt_{checkpoint_index}_{split}.json"
        )
        if config.EVAL.SAVE_RESULTS and os.path.exists(fname):
            logger.info("skipping -- evaluation exists.")
            return None

        env_class = registry.get_env(config.ENV_NAME)
        envs = construct_envs_auto_reset_false(config, env_class)
        self._setup_obs_transforms(config)
        self._initialize_policy(config, config.IL.ckpt_to_load)

        rnn_states = self.policy.initial_rnn_states(
            envs.num_envs, self.device
        )
        prev_actions = np.zeros((envs.num_envs, 1), np.int64)
        not_done_masks = np.zeros((envs.num_envs, 1), np.uint8)

        observations = self._extract_tokens(envs.reset())
        batch = batch_obs(observations)

        stats_episodes: Dict[str, Dict] = {}
        episodes_to_eval = sum(envs.count_episodes())
        if config.EVAL.EPISODE_COUNT > -1:
            episodes_to_eval = min(config.EVAL.EPISODE_COUNT,
                                   episodes_to_eval)
        start_time = time.time()
        env_steps = 0
        while envs.num_envs > 0 and len(stats_episodes) < episodes_to_eval:
            env_steps += envs.num_envs
            current_episodes = self._current_episode_info(envs)
            # the not-done masks restart the map and the GRUs
            actions, rnn_states = self._policy_step(
                batch, not_done_masks, rnn_states, prev_actions,
                (not_done_masks,), iterative=False,
            )
            prev_actions = actions
            outputs = envs.step([int(a[0]) for a in actions])
            observations, _, dones, infos = (list(x) for x in zip(*outputs))
            not_done_masks = np.array(
                [[0] if done else [1] for done in dones], np.uint8
            )
            for i in range(envs.num_envs):
                if not dones[i]:
                    continue
                stats_episodes[current_episodes[i]["episode_id"]] = {
                    k: infos[i][k] for k in EVAL_METRICS if k in infos[i]
                }
                observations[i] = envs.reset_at(i)
                prev_actions[i] = 0
                elapsed = time.time() - start_time
                logger.info(
                    f"[Ckpt: {checkpoint_index}] episodes evaluated: "
                    f"{len(stats_episodes)}/{episodes_to_eval} "
                    f"({round(elapsed)}s, "
                    f"{env_steps / max(elapsed, 1e-6):.1f} env steps/s)"
                )

            observations = self._extract_tokens(observations)
            batch = batch_obs(observations)

            next_episodes = self._current_episode_info(envs)
            envs_to_pause = [
                i for i in range(envs.num_envs)
                if next_episodes[i]["episode_id"] in stats_episodes
            ]
            envs, not_done_masks, prev_actions, batch = self._pause_envs(
                envs_to_pause, envs, not_done_masks, prev_actions,
                batch=batch,
            )

        envs.close()
        self.env_steps = env_steps
        self.eval_seconds = time.time() - start_time
        for transform in self.obs_transforms:
            transform.warn_if_dropped("episodic eval")

        aggregated_stats = {}
        num_episodes = max(len(stats_episodes), 1)
        if stats_episodes:
            for stat_key in next(iter(stats_episodes.values())).keys():
                aggregated_stats[stat_key] = (
                    sum(v[stat_key] for v in stats_episodes.values())
                    / num_episodes
                )
        if config.EVAL.SAVE_RESULTS:
            with open(fname, "w") as f:
                json.dump(aggregated_stats, f, indent=4)

        logger.info(f"Episodes evaluated: {num_episodes}")
        for k, v in aggregated_stats.items():
            logger.info(f"Average episode {k}: {v:.6f}")
            writer.add_scalar(f"eval_{split}_{k}", v, checkpoint_index + 1)
        return aggregated_stats

    def _eval_checkpoint_iterative(self, config, writer,
                                   checkpoint_index: int = 0):
        if "Iterative" not in config.ENV_NAME:
            config = config.clone()
            config.ENV_NAME = config.TASK_CONFIG.ENVIRONMENT.ITERATIVE.ENV_NAME
            config.freeze()
        split = config.TASK_CONFIG.DATASET.SPLIT
        if config.EVAL.SAVE_RESULTS:
            fname = os.path.join(
                config.RESULTS_DIR,
                f"iterative_stats_ckpt_{checkpoint_index}_{split}.json",
            )
            if os.path.exists(fname):
                logger.info("skipping -- evaluation exists.")
                return None

        # the reference reads the trainer's own config here
        map_reset = self.config.EVAL.ITERATIVE_MAP_RESET
        if map_reset not in ("episodic", "iterative"):
            raise ValueError("config.EVAL.ITERATIVE_MAP_RESET not valid")

        env_class = registry.get_env(config.ENV_NAME)
        envs = construct_envs_auto_reset_false(config, env_class)
        self._setup_obs_transforms(config)
        self._initialize_policy(config, config.IL.ckpt_to_load)

        rnn_states = self.policy.initial_rnn_states(
            envs.num_envs, self.device
        )
        prev_actions = np.zeros((envs.num_envs, 1), np.int64)
        agent_masks = np.zeros((envs.num_envs, 1), np.uint8)
        sim_masks = np.zeros((envs.num_envs, 1), np.uint8)
        tour_masks = np.zeros((envs.num_envs, 1), np.uint8)
        action_masks = np.ones((envs.num_envs, 1), np.uint8)

        observations, _, _ = (list(x) for x in zip(*envs.reset()))
        observations = self._extract_tokens(observations)
        batch = batch_obs(observations)

        stats_tours: Dict[str, Dict] = defaultdict(dict)
        dtw_data: Dict[str, List] = defaultdict(list)
        episodes_evaluated = 0
        start_time = time.time()
        env_steps = 0
        while envs.num_envs > 0:
            env_steps += envs.num_envs
            current_episodes = self._current_episode_info(envs)
            reset_masks = (
                agent_masks if map_reset == "episodic" else tour_masks
            )
            actions, rnn_states = self._policy_step(
                batch, reset_masks, rnn_states, prev_actions,
                (agent_masks, sim_masks, tour_masks, action_masks),
            )
            prev_actions = actions
            outputs = envs.step([int(a[0]) for a in actions])
            (
                observations, _, agent_dones, sim_dones, tour_dones,
                produce_actions, infos,
            ) = (list(x) for x in zip(*outputs))
            agent_masks = np.array(
                [[0] if d else [1] for d in agent_dones], np.uint8
            )
            sim_masks = np.array(
                [[0] if d else [1] for d in sim_dones], np.uint8
            )
            tour_masks = np.array(
                [[0] if d else [1] for d in tour_dones], np.uint8
            )
            action_masks = np.array(
                [[int(p)] for p in produce_actions], np.uint8
            )

            for i in range(envs.num_envs):
                if not agent_dones[i]:
                    continue
                ep_id = current_episodes[i]["episode_id"]
                tour_id = current_episodes[i]["tour_id"]
                if ep_id not in stats_tours[tour_id] and len(infos[i]) > 1:
                    episodes_evaluated += 1
                    stats_tours[tour_id][ep_id] = {
                        k: v
                        for k, v in infos[i].items()
                        if isinstance(v, numbers.Number)
                    }
                    elapsed = time.time() - start_time
                    logger.info(
                        f"[Ckpt: {checkpoint_index}] episodes evaluated: "
                        f"{episodes_evaluated} ({round(elapsed)}s, "
                        f"{env_steps / max(elapsed, 1e-6):.1f} env steps/s)"
                    )
                if not sim_dones[i]:
                    continue
                if "dtw_data" in infos[i]:
                    dtw_data[tour_id].extend(infos[i]["dtw_data"])
                observations[i], tour_done, produce_action = envs.reset_at(i)
                tour_masks[i] = int(not tour_done)
                action_masks[i] = int(produce_action)
                prev_actions[i] = 0

            observations = self._extract_tokens(observations)
            batch = batch_obs(observations)

            next_episodes = self._current_episode_info(envs)
            envs_to_pause = []
            for i in range(envs.num_envs):
                if not sim_dones[i]:
                    continue
                tour_id = next_episodes[i]["tour_id"]
                if next_episodes[i]["episode_id"] in stats_tours[tour_id]:
                    envs_to_pause.append(i)
            (
                envs, agent_masks, sim_masks, tour_masks,
                action_masks, prev_actions, batch,
            ) = self._pause_envs(
                envs_to_pause, envs, agent_masks, sim_masks,
                tour_masks, action_masks, prev_actions, batch=batch,
            )

        envs.close()
        self.env_steps = env_steps
        self.eval_seconds = time.time() - start_time
        for transform in self.obs_transforms:
            transform.warn_if_dropped("iterative eval")

        fname = os.path.join(
            config.RESULTS_DIR, f"dtw_data_ckpt_{checkpoint_index}_{split}.json"
        )
        with open(fname, "w") as f:
            json.dump(dtw_data, f, indent=2)
        fname = os.path.join(
            config.RESULTS_DIR,
            f"iterative_all_stats_ckpt_{checkpoint_index}_{split}.json",
        )
        with open(fname, "w") as f:
            json.dump(stats_tours, f, indent=2)

        aggregated_stats: Dict[str, float] = defaultdict(float)
        for stats_episodes in stats_tours.values():
            for stat_key in next(iter(stats_episodes.values())).keys():
                aggregated_stats[stat_key] += sum(
                    v.get(stat_key, 0.0) for v in stats_episodes.values()
                )
        episodes_evaluated = sum(len(v) for v in stats_tours.values())
        for stat_key in aggregated_stats:
            aggregated_stats[stat_key] /= max(episodes_evaluated, 1)

        if os.path.exists(config.EVAL.ITERATIVE_GT_PATHS):
            with open(config.EVAL.ITERATIVE_GT_PATHS, "r") as f:
                gt_paths = json.load(f)
            aggregated_stats["tndtw"] = compute_tour_ndtw(
                agent_paths=dtw_data,
                gt_paths=gt_paths[split],
                success_distance=config.TASK_CONFIG.TASK.NDTW.SUCCESS_DISTANCE,
            )
        else:
            logger.warning(
                "no iterative GT paths file at "
                f"{config.EVAL.ITERATIVE_GT_PATHS}; skipping t-nDTW"
            )

        if config.EVAL.SAVE_RESULTS:
            fname = os.path.join(
                config.RESULTS_DIR,
                f"iterative_stats_ckpt_{checkpoint_index}_{split}.json",
            )
            with open(fname, "w") as f:
                json.dump(aggregated_stats, f, indent=4)

        logger.info(f"Episodes evaluated: {episodes_evaluated}")
        for k, v in aggregated_stats.items():
            logger.info(f"Average episode {k}: {v:.6f}")
            writer.add_scalar(f"eval_{split}_{k}", v, checkpoint_index + 1)
        return dict(aggregated_stats)

    @staticmethod
    def _current_episode_info(envs) -> List[Dict]:
        """episode_id / tour_id of each lane's current episode."""
        return envs.call(["current_episode_info"] * envs.num_envs)
