"""DAgger with iterative (tour-ordered) collection: the PyTorch
counterpart of ``ivlnce_tpu/trainers/iterative_collection_dagger_trainer.py``
(reference iterative_collection_dagger_trainer.py).

Maps build iteratively across tours during collection (the env is the
7-tuple phase machine; map reset masks are TOUR masks), oracle-phase
steps are left out of the saved trajectories through action_masks
(:319-341), and a tours_to_idxs index lands at store key 0 (:377-385)
when ``save_tour_idx_data`` is set. Training stays episodic (inherits
DaggerTrainer.train)."""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from ivlnce_tpu_torch.envs.vector_env import construct_envs
from ivlnce_tpu_torch.trainers.dagger_trainer import (
    DaggerTrainer,
    _record_step_obs,
)
from ivlnce_tpu_torch.trainers.trajectory_store import TrajectoryStore
from ivlnce_tpu_torch.utils import logging_util, profiling
from ivlnce_tpu_torch.utils.batching import batch_obs
from ivlnce_tpu_torch.utils.registry import registry

logger = logging_util.logger


@registry.register_trainer(name="iterative_collection_dagger")
class IterativeCollectionDaggerTrainer(DaggerTrainer):
    def _save_episode(self, store, episode, lmdb_idx, expert_uuid):
        traj_obs = batch_obs([s[0] for s in episode], ignore_keys=set())
        traj_obs.pop(expert_uuid, None)
        if self.config.IL.DAGGER.lmdb_fp16:
            for k, v in traj_obs.items():
                if v.dtype == np.float32:
                    traj_obs[k] = v.astype(np.float16)
        store.put(
            lmdb_idx,
            [
                traj_obs,
                np.array([s[1] for s in episode], np.int64),
                np.array([s[2] for s in episode], np.int64),
            ],
        )

    def _update_dataset(
        self, data_it: int, save_tour_idx_data: bool = False
    ) -> Optional[Dict[str, List[int]]]:
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
        agent_masks = np.zeros((envs.num_envs, 1), np.uint8)
        sim_masks = np.zeros((envs.num_envs, 1), np.uint8)
        tour_masks = np.zeros((envs.num_envs, 1), np.uint8)
        action_masks = np.ones((envs.num_envs, 1), np.uint8)

        observations, _, _ = (list(x) for x in zip(*envs.reset()))
        observations = self._extract_tokens(observations)
        batch = batch_obs(observations)

        episodes: List[List] = [[] for _ in range(envs.num_envs)]
        skips = np.zeros(envs.num_envs, bool)
        sim_episode_dones = [False for _ in range(envs.num_envs)]

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
        tours_to_idxs: Dict[str, List[int]] = defaultdict(list)
        if save_tour_idx_data:
            if start_id:
                tours_to_idxs = defaultdict(
                    list, store.get(0)["tours_to_idxs"]
                )
            else:
                start_id += 1

        while collected_eps < config.IL.DAGGER.update_size:
            current_episodes = None
            envs_to_pause = []
            if ensure_unique_episodes:
                current_episodes = self._current_episode_info(envs)

            for i in range(envs.num_envs):
                if not sim_episode_dones[i]:
                    continue
                if skips[i] or not episodes[i]:
                    episodes[i] = []
                    continue
                lmdb_idx = start_id + collected_eps
                self._save_episode(store, episodes[i], lmdb_idx, expert_uuid)
                tour_id = str(episodes[i][0][3])
                tours_to_idxs[tour_id].append(lmdb_idx)
                collected_eps += 1
                if (
                    collected_eps
                    % config.IL.DAGGER.lmdb_commit_frequency == 0
                ):
                    store.sync()

                if ensure_unique_episodes:
                    if current_episodes[i]["episode_id"] in ep_ids_collected:
                        envs_to_pause.append(i)
                    else:
                        ep_ids_collected.add(
                            current_episodes[i]["episode_id"]
                        )
                episodes[i] = []

            if ensure_unique_episodes:
                (
                    envs, agent_masks, sim_masks, tour_masks,
                    action_masks, prev_actions, batch, _,
                ) = self._pause_envs(
                    envs_to_pause, envs, agent_masks, sim_masks,
                    tour_masks, action_masks, prev_actions, batch=batch,
                )
                if envs.num_envs == 0:
                    break

            # map reset masks are TOUR masks: maps persist across the
            # episodes of a tour during collection (reference :131-397)
            actions, rnn_states, features, batch = self._collect_step(
                batch, tour_masks, rnn_states, prev_actions,
                (agent_masks, sim_masks, tour_masks, action_masks),
                iterative=True,
            )

            expert_actions = np.asarray(batch[expert_uuid]).reshape(-1, 1)
            mix = rng.random(actions.shape) < beta
            actions = np.where(
                mix, expert_actions.astype(actions.dtype), actions
            )

            episode_infos = self._current_episode_info(envs)
            # the sims step while the append/pack host work below runs
            # (episode_infos is fetched first: the lane protocol is
            # strictly request/reply ordered)
            step_actions = np.where(
                (expert_actions.reshape(-1) == -1)[:, None], 0, actions
            )
            envs.step_async([int(a[0]) for a in step_actions])
            for i in range(envs.num_envs):
                # only agent-phase steps are recorded (oracle steps left
                # out, iterative_collection_dagger_trainer.py:319-322)
                if not action_masks[i, 0]:
                    continue
                episodes[i].append(
                    (
                        _record_step_obs(observations[i], features, batch,
                                         i, drop_rgb=True),
                        int(prev_actions[i, 0]),
                        int(expert_actions[i, 0]),
                        episode_infos[i]["tour_id"],
                    )
                )

            skips = expert_actions.reshape(-1) == -1
            prev_actions = step_actions

            with profiling.span("env_step_wait"):
                outputs = envs.step_wait()
            (
                observations, _, agent_dones, sim_episode_dones, tour_dones,
                produce_actions, _,
            ) = (list(x) for x in zip(*outputs))

            agent_masks = np.array(
                [[0] if d else [1] for d in agent_dones], np.uint8
            )
            sim_masks = np.array(
                [[0] if d else [1] for d in sim_episode_dones], np.uint8
            )
            tour_masks = np.array(
                [[0] if d else [1] for d in tour_dones], np.uint8
            )
            action_masks = np.array(
                [[int(p)] for p in produce_actions], np.uint8
            )

            with profiling.span("batch_obs"):
                observations = self._extract_tokens(observations)
                batch = batch_obs(observations)

        if save_tour_idx_data:
            store.put(0, {"tours_to_idxs": dict(tours_to_idxs)})
        store.sync()
        store.close()
        envs.close()
        # the map-truncation telemetry before the store is consumed
        dropped = sum(
            t.warn_if_dropped(f"iterative dagger collection it={data_it}")
            for t in self.obs_transforms
        )
        logger.info(
            f"collected {collected_eps} episodes across "
            f"{len(tours_to_idxs)} tours (beta={beta:.3f}, "
            f"dropped_map_points={dropped})"
        )
        if save_tour_idx_data:
            return dict(tours_to_idxs)
        return None
