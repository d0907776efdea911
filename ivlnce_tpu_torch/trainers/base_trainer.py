"""VLN-CE trainer base: the PyTorch counterpart of
``ivlnce_tpu/trainers/base_trainer.py`` (reference
ivlnce_baselines/common/base_il_trainer.py).

Evaluation (base_il_trainer.py:313-928), episodic and iterative (tour):
each env step runs the mapper obs transform, when one is enabled, and the
policy on the device (``_policy_step``) and brings back the actions;
lanes keep a fixed row count while envs pause. Stats JSONs and tour-nDTW
are written as the JAX package writes them.

Training (base_il_trainer.py:173-219): ``train_step`` is the BPTT update
over a (T, N) batch (inflection-weighted cross-entropy plus the progress
monitor, backward, Adam, then the map encoder's BatchNorm statistics);
``_update_agent`` feeds it a collated batch. The registered trainers
(``dagger_trainer.py`` and its two iterative subclasses) collect the
trajectories and run the loops; ``save_training_checkpoint`` writes in
the background with ``TPU.async_checkpointing``."""

from __future__ import annotations

import contextlib
import json
import numbers
import os
import threading
import time
import zipfile
from collections import defaultdict
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from ivlnce_tpu_torch.envs.vector_env import construct_envs_auto_reset_false
from ivlnce_tpu_torch.mapping.obs_transforms import get_active_obs_transforms
from ivlnce_tpu_torch.models import checkpoint_io as cio
from ivlnce_tpu_torch.models.cma import progress_monitor_loss
from ivlnce_tpu_torch.models.convert import params_from_jax
from ivlnce_tpu_torch.tasks.tour_ndtw import compute_tour_ndtw
from ivlnce_tpu_torch.utils import batching, logging_util, profiling, viz
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


def _to_cpu(obj):
    """A copy of ``obj`` (dicts, lists, tuples of tensors and plain
    values) whose tensors are detached copies on the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


class AsyncCheckpointWriter:
    """``TPU.async_checkpointing``: the counterpart of the JAX package's
    Orbax async save (base_trainer.py:267-283) in the port's format. The
    caller copies the state off the device at once; one background thread
    ``torch.save``s it to a temporary name and renames it into place, so a
    reader never sees a partial file. Each save first waits for the
    previous write; a write's error is raised by the next ``save`` or
    ``wait``, never dropped."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, payload: Dict[str, Any], path: str) -> None:
        self.wait()
        self._thread = threading.Thread(target=self._write,
                                        args=(payload, path),
                                        name="checkpoint-writer", daemon=True)
        self._thread.start()

    def _write(self, payload, path: str) -> None:
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            torch.save(payload, tmp)
            os.replace(tmp, path)
        except Exception as e:  # raised in the caller's thread
            self._error = e
            with contextlib.suppress(OSError):
                os.remove(tmp)

    def wait(self) -> None:
        """Block until the last write is done; raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Read a checkpoint of any kind the JAX package's eval reads, as a
    dict whose ``state_dict`` is in the port's names (JAX
    base_trainer.py:296-326):

    - a zip file (``torch.save``): the port's own or a reference
      training checkpoint, which share the ``net.`` /
      ``action_distribution.`` layout;
    - an Orbax directory (``path`` or ``path + ".orbax"``): raises;
    - anything else: a pickle of the JAX trainer, whose ``params`` tree
      goes through ``params_from_jax``; its optax ``optim_state`` comes
      back inert."""
    if os.path.isdir(path) or os.path.isdir(path + ".orbax"):
        raise NotImplementedError(
            f"{path} is an Orbax checkpoint directory: reading it needs "
            "orbax and tensorstore, which the PyTorch port does not use; "
            "evaluate a pickle checkpoint (TPU.async_checkpointing False) "
            "or a reference .pth instead"
        )
    if zipfile.is_zipfile(path):
        return cio.load_reference_policy_checkpoint(path)
    ckpt = cio.load_jax_pickle(path)
    return {**ckpt, "state_dict": params_from_jax(ckpt["params"])}


# -- the training step --------------------------------------------------------
def make_optimizer(policy, config) -> torch.optim.Adam:
    """Adam at ``IL.lr`` (optax's defaults: betas 0.9 / 0.999, eps 1e-8);
    with ``SEMANTIC_MAP_ENCODER.custom_lr`` the map encoder's parameters
    form a second group at ``SEMANTIC_MAP_ENCODER.lr`` (JAX
    base_trainer.py:193-211)."""
    params = list(policy.parameters())
    map_encoder = getattr(policy.net, "map_encoder", None)
    if not config.MODEL.SEMANTIC_MAP_ENCODER.custom_lr or map_encoder is None:
        return torch.optim.Adam(params, lr=config.IL.lr)
    in_map = {id(p) for p in map_encoder.parameters()}
    return torch.optim.Adam([
        {"params": [p for p in params if id(p) not in in_map],
         "lr": config.IL.lr},
        {"params": list(map_encoder.parameters()),
         "lr": config.MODEL.SEMANTIC_MAP_ENCODER.lr},
    ])


def train_loss(policy, observations, prev_actions, episode_masks,
               tour_masks, corrected, weights, rnn_states,
               use_progress: bool, alpha: float):
    """The training forward and its loss (JAX base_trainer.py:69-93):
    ``mean_n(sum_t w * CE / sum_t w)`` over the (T, N) ``corrected``
    actions and inflection ``weights``, plus ``alpha`` times the progress
    monitor's squared error over the rows with w > 0. Returns (loss,
    action loss, aux loss, final rnn_states)."""
    t, n = corrected.shape
    logits, features, rnn_out = policy.build_distribution(
        observations, rnn_states, prev_actions, episode_masks, tour_masks,
        training=True,
    )
    with record_function("train_loss"):
        logp = torch.log_softmax(logits.reshape(t, n, -1), dim=-1)
        action_loss = -logp.gather(-1, corrected[..., None])[..., 0]
        action_loss = ((weights * action_loss).sum(0)
                       / weights.sum(0)).mean()
        aux_loss = torch.zeros((), device=logits.device)
        if use_progress:
            p_loss = progress_monitor_loss(policy.net, features,
                                           observations["progress"])
            aux_mask = (weights > 0).reshape(-1).float()
            aux_loss = alpha * (p_loss * aux_mask).sum() / aux_mask.sum()
    return action_loss + aux_loss, action_loss, aux_loss, rnn_out


def train_step(policy, optimizer, observations, prev_actions, episode_masks,
               tour_masks, corrected, weights, rnn_states,
               use_progress: bool, alpha: float, update_map_bn: bool):
    """One BPTT update (JAX ``make_train_step``): the loss, its gradients,
    an optimizer step, then, with ``update_map_bn`` (MapCMA with a
    trainable map encoder), the map encoder's running BatchNorm statistics
    recomputed over the batch's maps with the UPDATED weights, as the JAX
    package does after its optimizer update. Returns the loss terms and
    the final rnn_states, detached."""
    loss, action_loss, aux_loss, rnn_out = train_loss(
        policy, observations, prev_actions, episode_masks, tour_masks,
        corrected, weights, rnn_states, use_progress, alpha,
    )
    with record_function("backward"):
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
    with record_function("optimizer"):
        optimizer.step()
    if update_map_bn:
        with record_function("map_bn_stats"):
            policy.net.map_encoder.update_running_stats(
                observations["occupancy_map"], observations["semantic_map"]
            )
    return (loss.detach(), action_loss.detach(), aux_loss.detach(),
            rnn_out.detach())


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
        self._pending_maps = None
        # policy steps and instruction bi-LSTM runs (once per episode
        # change, not per step) over the trainer's evals
        self.policy_steps = 0
        self.instruction_encodes = 0
        # training: the optimizer, and the train steps and their T*N rows
        self.optimizer = None
        self.checkpoint_writer = AsyncCheckpointWriter()
        self.train_steps = 0
        self.train_rows = 0
        os.makedirs(config.CHECKPOINT_FOLDER, exist_ok=True)
        if config.EVAL.SAVE_RESULTS:
            os.makedirs(config.RESULTS_DIR, exist_ok=True)

    # -- policy ---------------------------------------------------------------
    def _observation_info(self, config) -> Dict:
        """Sensor sizes the nets are built for; LatentCMA ignores map_hw."""
        mapper = config.RL.POLICY.OBS_TRANSFORMS.EGOCENTRIC_MAPPER
        return {
            "depth_hw": config.TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.HEIGHT,
            "map_hw": int(
                np.ceil(mapper.height_meters / mapper.resolution_meters)
            ),
        }

    def _build_policy(self, config, checkpoint_path: Optional[str]):
        """The configured policy on the device: seeded weights, the
        external encoders, then the checkpoint's weights when a path is
        given. Returns (policy, the checkpoint dict or None)."""
        policy_cls = registry.get_policy(config.MODEL.policy_name)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(config.TASK_CONFIG.SEED)
            policy = policy_cls.from_config(
                config, self._observation_info(config)
            )
        state = self._load_external_encoders(config, policy.state_dict())
        ckpt = None
        if checkpoint_path is not None:
            ckpt = load_checkpoint(checkpoint_path)
            state = cio.merge_params(state, ckpt["state_dict"])
            logger.info(f"Loaded weights from checkpoint: {checkpoint_path}")
        policy.load_state_dict(state)
        n_params = sum(p.numel() for p in policy.parameters())
        logger.info(f"Agent parameters: {n_params}.")
        return policy.to(self.device), ckpt

    def _initialize_policy(self, config, checkpoint_path: str) -> None:
        self.policy = self._build_policy(config, checkpoint_path)[0].eval()
        self._lane_rows = None
        self._txt_cache_tokens = None
        # EVAL.SAMPLE: actions drawn with a generator on the policy's
        # device seeded from TASK_CONFIG.SEED (base_il_trainer.py:452,699)
        self._generator = None
        if config.EVAL.SAMPLE:
            self._generator = torch.Generator(device=self.device)
            self._generator.manual_seed(config.TASK_CONFIG.SEED)

    # -- training -------------------------------------------------------------
    def _check_training_options(self, config) -> None:
        """Refuse what the port's training cannot do, before any
        collection: more than one device."""
        want = config.TPU.data_parallel_devices
        visible = (torch.cuda.device_count() if self.device.type == "cuda"
                   else 1)
        devices = 1 if want in (0, 1) else (visible if want < 0 else want)
        if devices > 1:
            raise NotImplementedError(
                f"TPU.data_parallel_devices {want} asks for {devices} "
                "devices; the PyTorch port trains on one device "
                "(ROADMAP: parallel/); set it to 1"
            )

    def _initialize_training(self, config) -> None:
        """The policy and its optimizer for training; with
        ``IL.load_from_ckpt`` the weights of ``IL.ckpt_to_load`` and, with
        ``IL.is_requeue``, its optimizer state (the port's, or a JAX
        pickle's optax Adam state: ``cio.adam_state_from_optax``), epoch
        and step (JAX base_trainer.py:169-224). The modules stay in eval mode but for
        the recurrent ones, which cuDNN's backward needs in train mode:
        BatchNorm is switched by the forward's ``training`` argument."""
        load = config.IL.load_from_ckpt
        policy, ckpt = self._build_policy(
            config, config.IL.ckpt_to_load if load else None
        )
        policy.eval()
        for module in policy.modules():
            if isinstance(module, torch.nn.RNNBase):
                module.train()
        self.policy = policy
        self.optimizer = make_optimizer(policy, config)
        self.start_epoch, self.step_id = 0, 0
        if ckpt is not None and config.IL.is_requeue and "optim_state" in ckpt:
            optim_state = ckpt["optim_state"]
            if isinstance(optim_state, dict) and "param_groups" in optim_state:
                self.optimizer.load_state_dict(optim_state)
            else:  # the JAX trainer's pickle: optax Adam's moments
                cio.adam_state_from_optax(optim_state, self.optimizer, policy)
            self.start_epoch = ckpt["epoch"] + 1
            self.step_id = ckpt["step_id"]
        self._lane_rows = None
        self._txt_cache_tokens = None

    def save_training_checkpoint(self, file_name: str, dagger_it: int = 0,
                                 epoch: int = 0, step_id: int = 0) -> None:
        """The port's checkpoint with the optimizer state, the DAgger
        iteration, epoch and step (JAX base_trainer.py:256-294); with
        ``TPU.async_checkpointing`` the state is copied to the CPU now and
        written in the background (``checkpoint_writer``)."""
        path = os.path.join(self.config.CHECKPOINT_FOLDER, file_name)
        meta = {"optim_state": self.optimizer.state_dict(),
                "dagger_it": dagger_it, "epoch": epoch, "step_id": step_id}
        if not self.config.TPU.async_checkpointing:
            save_checkpoint(self.policy, self.config, path, **meta)
            return
        self.checkpoint_writer.save(
            _to_cpu({"state_dict": self.policy.state_dict(),
                     "config": self.config.to_dict(), **meta}),
            path,
        )

    def _update_agent(
        self,
        observations: Dict[str, np.ndarray],
        prev_actions: np.ndarray,
        not_done_masks: np.ndarray,
        corrected_actions: np.ndarray,
        weights: np.ndarray,
        tour_not_done_masks: Optional[np.ndarray] = None,
        rnn_states: Optional[torch.Tensor] = None,
    ):
        """One BPTT update over a collated (T, N) batch of host arrays
        (JAX base_trainer.py:689-739); an ``rnn_states`` carry continues
        a sequence. Returns (loss, action loss, aux loss) as floats and
        the final rnn_states."""
        t, n = corrected_actions.shape
        if rnn_states is None:
            rnn_states = self.policy.initial_rnn_states(n, self.device)
        if tour_not_done_masks is None:
            tour_not_done_masks = not_done_masks

        def dev(a, dtype=None):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=self.device)

        model = self.config.MODEL
        update_map_bn = (model.policy_name == "MapCMAPolicy"
                         and model.SEMANTIC_MAP_ENCODER.trainable)
        with profiling.wall_range("train_step"), \
                profiling.range_context("train_step"):
            obs = {k: dev(v) for k, v in observations.items()}
            loss, action_loss, aux_loss, rnn_out = train_step(
                self.policy, self.optimizer, obs,
                dev(prev_actions, torch.int64),
                dev(np.asarray(not_done_masks).reshape(t, n), torch.float32),
                dev(np.asarray(tour_not_done_masks).reshape(t, n),
                    torch.float32),
                dev(corrected_actions, torch.int64),
                dev(weights, torch.float32),
                rnn_states,
                model.PROGRESS_MONITOR.use, model.PROGRESS_MONITOR.alpha,
                update_map_bn,
            )
            losses = [float(x) for x in
                      torch.stack([loss, action_loss, aux_loss]).cpu()]
        # the weights changed: cached per-episode instruction features are
        # stale
        self._txt_cache_tokens = None
        self.train_steps += 1
        self.train_rows += t * n
        return (*losses, rnn_out)

    @staticmethod
    def _load_external_encoders(config, state):
        """Frozen external weights merged into the policy's ``state``: the
        DDPPO depth encoder and the pretrained map encoder (JAX
        base_trainer.py:233-253). A missing file keeps the seeded
        weights."""
        ddppo = config.MODEL.DEPTH_ENCODER.ddppo_checkpoint
        if ddppo != "NONE" and os.path.exists(ddppo):
            state = cio.merge_params(state,
                                     cio.load_ddppo_depth_encoder(ddppo))
            logger.info(f"Loaded DDPPO depth encoder: {ddppo}")
        sm = config.MODEL.SEMANTIC_MAP_ENCODER
        if sm.from_pretrained and os.path.exists(sm.checkpoint):
            state = cio.merge_params(state,
                                     cio.load_map_encoder(sm.checkpoint))
            logger.info(f"Loaded map encoder: {sm.checkpoint}")
        return state

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

    # -- fixed-lane bookkeeping -----------------------------------------------
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

    # -- one env step on the device -------------------------------------------
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
                     masks, iterative: bool = True, need_maps: bool = False):
        """Mapper step, when a transform is enabled, then ``act_iterative``
        (``masks`` is (agent, sim, tour, action)) or, with ``iterative``
        False, ``act`` (``masks`` is (not_done,)) for the live lanes.
        Returns (actions (live, 1) host array, full-width rnn_states on
        the device). With ``need_maps`` (videos) the step's egocentric
        maps are kept for ``_materialize_maps``; otherwise they stay on
        the device."""
        self.policy_steps += 1
        # an on-demand trace of policy steps [3, 23) (TPU.profile_dir)
        if self.policy_steps == 3:
            profiling.maybe_start_trace(self.config, self.device)
        elif self.policy_steps == 23:
            profiling.maybe_stop_trace()
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
        self._pending_maps = None
        with profiling.range_context("policy_step"):
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
                if need_maps:
                    self._pending_maps = (occ, sem, rows)
            act = self.policy.act_iterative if iterative else self.policy.act
            out = act(obs, rnn_states, prev_full, *masks_full,
                      generator=self._generator)
            actions = out.actions.cpu().numpy()[rows]
        return actions, out.rnn_states

    def _materialize_maps(self, batch) -> None:
        """Read the maps kept by ``_policy_step(need_maps=True)`` into
        ``batch`` (called after ``envs.step_async``, so the copy overlaps
        the simulators' step)."""
        if self._pending_maps is None:
            return
        occ, sem, rows = self._pending_maps
        self._pending_maps = None
        batch["occupancy_map"] = occ.cpu().numpy()[rows]
        batch["semantic_map"] = sem.cpu().numpy()[rows]

    @staticmethod
    def _video_frame(observation, info, episode, batch, i):
        """One lane's video frame: the sensors, the top-down map, the
        instruction and, with a mapper, the egocentric maps."""
        frame = viz.observations_to_image(observation, info)
        frame = viz.append_text_to_image(
            frame, episode.get("instruction_text", "")
        )
        if "occupancy_map" in batch:
            map_frame = viz.append_image_horizontally([
                viz.visualize_ego_occupancy_map(batch["occupancy_map"][i]),
                viz.visualize_ego_semantic_map(batch["semantic_map"][i]),
            ])
            frame = viz.append_image_vertically([frame, map_frame])
        return frame

    def _pause_envs(self, envs_to_pause, envs, *arrays, batch=None,
                    rgb_frames=None):
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
            if rgb_frames is not None:
                rgb_frames = [rgb_frames[i] for i in state_index]
        return (envs,) + arrays + (batch, rgb_frames)

    def inference(self) -> None:
        """``--run-type inference``: not implemented, as in the JAX package
        (its base_trainer.py:795-796)."""
        raise NotImplementedError

    # -- eval entry point -----------------------------------------------------
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
        if len(config.VIDEO_OPTION) > 0:
            # the drawn map measure only when videos are asked for
            # (base_il_trainer.py:352-373)
            os.makedirs(config.VIDEO_DIR, exist_ok=True)
            measurements = config.TASK_CONFIG.TASK.MEASUREMENTS
            if "TOP_DOWN_MAP_VLNCE" not in measurements:
                measurements.append("TOP_DOWN_MAP_VLNCE")
        config.freeze()
        # per-checkpoint phase attribution (the accumulators are
        # process-wide)
        profiling.reset_phases()
        try:
            with torch.inference_mode():
                if config.TASK_CONFIG.ENVIRONMENT.ITERATIVE.ENABLED:
                    return self._eval_checkpoint_iterative(
                        config, writer, checkpoint_index
                    )
                return self._eval_checkpoint_episodic(
                    config, writer, checkpoint_index
                )
        finally:
            # a trace window an eval left open (a short run, an error)
            profiling.maybe_stop_trace()

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
        videos = len(config.VIDEO_OPTION) > 0
        rgb_frames: List[List] = [[] for _ in range(envs.num_envs)]
        start_time = time.time()
        env_steps = 0
        while envs.num_envs > 0 and len(stats_episodes) < episodes_to_eval:
            env_steps += envs.num_envs
            current_episodes = self._current_episode_info(envs)
            # the not-done masks restart the map and the GRUs
            with profiling.wall_range("policy_step"):
                actions, rnn_states = self._policy_step(
                    batch, not_done_masks, rnn_states, prev_actions,
                    (not_done_masks,), iterative=False, need_maps=videos,
                )
            prev_actions = actions
            envs.step_async([int(a[0]) for a in actions])
            with profiling.wall_range("materialize_maps"):
                self._materialize_maps(batch)
            with profiling.wall_range("env_step_wait"):
                outputs = envs.step_wait()
            observations, _, dones, infos = (list(x) for x in zip(*outputs))
            not_done_masks = np.array(
                [[0] if done else [1] for done in dones], np.uint8
            )
            for i in range(envs.num_envs):
                if videos:
                    rgb_frames[i].append(self._video_frame(
                        observations[i], infos[i], current_episodes[i],
                        batch, i,
                    ))
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
                self._log_phases()
                if videos:
                    ep_id = current_episodes[i]["episode_id"]
                    viz.generate_video(
                        video_option=config.VIDEO_OPTION,
                        video_dir=config.VIDEO_DIR,
                        images=rgb_frames[i],
                        episode_id=ep_id,
                        checkpoint_idx=checkpoint_index,
                        metrics={"spl": stats_episodes[ep_id].get("spl", 0.0)},
                        tb_writer=writer,
                    )
                    rgb_frames[i] = []

            with profiling.wall_range("batch_obs"):
                observations = self._extract_tokens(observations)
                batch = batch_obs(observations)

            next_episodes = self._current_episode_info(envs)
            envs_to_pause = [
                i for i in range(envs.num_envs)
                if next_episodes[i]["episode_id"] in stats_episodes
            ]
            (
                envs, not_done_masks, prev_actions, batch, rgb_frames,
            ) = self._pause_envs(
                envs_to_pause, envs, not_done_masks, prev_actions,
                batch=batch, rgb_frames=rgb_frames,
            )

        envs.close()
        self.env_steps = env_steps
        self.eval_seconds = time.time() - start_time
        self.episodes_evaluated = len(stats_episodes)
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
        videos = len(config.VIDEO_OPTION) > 0
        rgb_frames: List[List] = [[] for _ in range(envs.num_envs)]
        start_time = time.time()
        env_steps = 0
        while envs.num_envs > 0:
            env_steps += envs.num_envs
            current_episodes = self._current_episode_info(envs)
            reset_masks = (
                agent_masks if map_reset == "episodic" else tour_masks
            )
            with profiling.wall_range("policy_step"):
                actions, rnn_states = self._policy_step(
                    batch, reset_masks, rnn_states, prev_actions,
                    (agent_masks, sim_masks, tour_masks, action_masks),
                    need_maps=videos,
                )
            # the JAX loop's host copy of the actions; the port's device
            # readback falls inside policy_step
            with profiling.wall_range("action_readback"):
                actions = np.array(actions)
            prev_actions = actions
            envs.step_async([int(a[0]) for a in actions])
            with profiling.wall_range("materialize_maps"):
                self._materialize_maps(batch)
            with profiling.wall_range("env_step_wait"):
                outputs = envs.step_wait()
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
                if videos:
                    rgb_frames[i].append(self._video_frame(
                        observations[i], infos[i], current_episodes[i],
                        batch, i,
                    ))
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
                    self._log_phases()
                if not sim_dones[i]:
                    continue
                if "dtw_data" in infos[i]:
                    dtw_data[tour_id].extend(infos[i]["dtw_data"])
                if videos and rgb_frames[i]:
                    viz.generate_video(
                        video_option=config.VIDEO_OPTION,
                        video_dir=config.VIDEO_DIR,
                        images=rgb_frames[i],
                        episode_id=ep_id,
                        checkpoint_idx=checkpoint_index,
                        metrics={
                            "spl": stats_tours[tour_id]
                            .get(ep_id, {})
                            .get("spl", 0.0)
                        },
                        tb_writer=writer,
                    )
                    rgb_frames[i] = []
                observations[i], tour_done, produce_action = envs.reset_at(i)
                tour_masks[i] = int(not tour_done)
                action_masks[i] = int(produce_action)
                prev_actions[i] = 0

            with profiling.wall_range("batch_obs"):
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
                action_masks, prev_actions, batch, rgb_frames,
            ) = self._pause_envs(
                envs_to_pause, envs, agent_masks, sim_masks,
                tour_masks, action_masks, prev_actions, batch=batch,
                rgb_frames=rgb_frames,
            )

        envs.close()
        self.env_steps = env_steps
        self.eval_seconds = time.time() - start_time
        self.episodes_evaluated = episodes_evaluated
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
    def _log_phases() -> None:
        report = profiling.phase_report()
        if report:
            logger.info(f"phase times: {report}")

    @staticmethod
    def _current_episode_info(envs) -> List[Dict]:
        """episode_id / tour_id of each lane's current episode."""
        return envs.call(["current_episode_info"] * envs.num_envs)
