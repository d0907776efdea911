"""VLN-CE trainer base: the PyTorch counterpart of
``ivlnce_tpu/trainers/base_trainer.py`` (reference
ivlnce_baselines/common/base_il_trainer.py).

Evaluation (base_il_trainer.py:313-928), episodic and iterative (tour):
each env step runs the mapper obs transform, when one is enabled, and the
policy on the device (``_policy_step``) and brings back the actions;
lanes keep a fixed row count while envs pause. Stats JSONs and tour-nDTW
are written as the JAX package writes them.

Training (base_il_trainer.py:173-219): ``_update_agent`` feeds a
collated batch to the BPTT update (``models/il_update.py::train_step``),
or to its data-parallel form over the devices
``TPU.data_parallel_devices`` resolves to (``parallel/``). The registered
trainers (``dagger_trainer.py`` and its two iterative subclasses) collect
the trajectories and run the loops; ``save_training_checkpoint`` writes
in the background with ``TPU.async_checkpointing``."""

from __future__ import annotations

import contextlib
import json
import numbers
import os
import threading
import time
import zipfile
from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ivlnce_tpu_torch import parallel
from ivlnce_tpu_torch.envs.vector_env import construct_envs_auto_reset_false
from ivlnce_tpu_torch.mapping.obs_transforms import get_active_obs_transforms
from ivlnce_tpu_torch.models import checkpoint_io as cio
from ivlnce_tpu_torch.models import il_update
from ivlnce_tpu_torch.models import instruction_encoder as IE
from ivlnce_tpu_torch.models.convert import params_from_jax
from ivlnce_tpu_torch.models.orbax_io import load_orbax_checkpoint
from ivlnce_tpu_torch.tasks.tour_ndtw import compute_tour_ndtw
from ivlnce_tpu_torch.utils import batching, logging_util, profiling, viz
from ivlnce_tpu_torch.utils.batching import batch_obs, extract_instruction_tokens
from ivlnce_tpu_torch.utils.device import resolve_device
from ivlnce_tpu_torch.utils.registry import registry
from ivlnce_tpu_torch.utils.tb import TensorboardWriter
from ivlnce_tpu_torch.utils.upload import StagedUpload

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

    - an Orbax directory, ``path + ".orbax"`` or else ``path`` (the JAX
      trainer's ``TPU.async_checkpointing`` save): its tree and the
      ``.meta.json`` sidecar (``models/orbax_io.py``), the ``params``
      through ``params_from_jax``, bfloat16 leaves widened to float32;
      ``optim_state`` is optax's state as Orbax restores it, in dicts and
      lists;
    - a zip file (``torch.save``): the port's own or a reference
      training checkpoint, which share the ``net.`` /
      ``action_distribution.`` layout;
    - anything else: a pickle of the JAX trainer, whose ``params`` tree
      goes through ``params_from_jax``; its optax ``optim_state`` comes
      back inert."""
    orbax_dir = path + ".orbax" if os.path.isdir(path + ".orbax") else path
    if os.path.isdir(orbax_dir):
        ckpt = load_orbax_checkpoint(orbax_dir, bfloat16_as_float32=True)
    elif zipfile.is_zipfile(path):
        return cio.load_reference_policy_checkpoint(path)
    else:
        ckpt = cio.load_jax_pickle(path)
    return {**ckpt, "state_dict": params_from_jax(ckpt["params"])}


def checkpoints_in(folder: str) -> List[Tuple[int, str]]:
    """The checkpoints of an ``EVAL_CKPT_PATH_DIR`` folder, as (index,
    path) in index order: each ``ckpt.<index>.*`` entry, as the JAX
    package lists them (base_trainer.py:775-795), but for the
    ``ckpt.N.pth.meta.json`` beside a ``ckpt.N.pth.orbax``: that is the
    Orbax checkpoint's sidecar, not a checkpoint."""
    names = [f for f in os.listdir(folder) if f.startswith("ckpt.")]
    sidecars = {f[:-len(".orbax")] + ".meta.json" for f in names
                if f.endswith(".orbax")}
    return sorted(
        ((int(f.split(".")[1]), os.path.join(folder, f)) for f in names
         if f not in sidecars),
        key=lambda c: c[0],
    )


class BaseVLNCETrainer:
    """Evaluation of a MapCMA or LatentCMA checkpoint on the device given
    by ``device`` ("cuda" unless the caller asks for "cpu"). ``devices``
    are those the IL update's data axis may use, ``device`` first (JAX
    ``make_mesh(devices=...)``): by default every visible card, or the one
    CPU; a list that names the CPU more than once runs that many shards on
    it."""

    def __init__(self, config, device: Optional[str] = None,
                 devices: Optional[Sequence] = None):
        self.config = config
        self.device = resolve_device(device)
        if devices is None:
            lead = self.device
            if lead.type == "cuda" and lead.index is None:
                lead = torch.device("cuda", torch.cuda.current_device())
            devices = [lead] + [d for d in
                                parallel.local_devices(lead.type)
                                if d != lead]
        self.data_devices = [torch.device(d) for d in devices]
        self._train_steps: Dict[int, Any] = {}
        self._dp_warned_lanes = set()
        self.policy = None
        self.obs_transforms = []
        self.flush_secs = 30
        self._lane_rows = None
        self.instruction_cache: Optional[IE.InstructionCache] = None
        self._device_step = None
        self._generator = None
        self._pending_maps = None
        # every host-to-device copy of a policy or collection step
        self._upload = StagedUpload(self.device)
        # policy steps and instruction bi-LSTM runs (once per episode
        # change, not per step) over the trainer's evals, and their rows
        self.policy_steps = 0
        self.instruction_encodes = 0
        self.instruction_rows_encoded = 0
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
        given; a new lane map and instruction cache go with it. Returns
        (policy, the checkpoint dict or None)."""
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
        policy.to(self.device)
        self._lane_rows = None
        self.instruction_cache = IE.InstructionCache(
            policy.net.instruction_encoder)
        return policy, ckpt

    def _initialize_policy(self, config, checkpoint_path: str) -> None:
        self.policy = self._build_policy(config, checkpoint_path)[0].eval()
        # EVAL.SAMPLE: actions drawn with a generator on the policy's
        # device seeded from TASK_CONFIG.SEED (base_il_trainer.py:452,699)
        self._generator = None
        if config.EVAL.SAMPLE:
            self._generator = torch.Generator(device=self.device)
            self._generator.manual_seed(config.TASK_CONFIG.SEED)

    # -- training -------------------------------------------------------------
    def _data_parallel_devices(self, n_lanes: int) -> int:
        """Data-axis size of the IL update (JAX base_trainer.py:618-644):
        ``TPU.data_parallel_devices`` (0 or 1: one device; N: up to N;
        -1: all of ``data_devices``), capped by the devices present and
        by divisibility: the LARGEST count within the cap that divides
        the batch's lanes, with one warning per distinct lane count."""
        want = self.config.TPU.data_parallel_devices
        if want in (0, 1):
            return 1
        avail = len(self.data_devices)
        n = avail if want < 0 else min(want, avail)
        full = n
        while n > 1 and n_lanes % n != 0:
            n -= 1
        if n < full and n_lanes not in self._dp_warned_lanes:
            self._dp_warned_lanes.add(n_lanes)
            logger.warning(
                f"data-parallel IL update using {n}/{full} devices: "
                f"batch lanes ({n_lanes}) not divisible by {full}"
            )
        return n

    def _train_step_fn(self, n_lanes: int):
        """``train_step``, or the data-parallel step over the resolved
        device count, kept by that count (JAX ``_train_step_fn``); each
        new choice is logged."""
        ndp = self._data_parallel_devices(n_lanes)
        if ndp not in self._train_steps:
            if ndp > 1:
                mesh = parallel.make_mesh(ndp, devices=self.data_devices)
                logger.info(
                    f"IL update: data-parallel over {ndp} devices (mesh "
                    f"{mesh.shape}: {', '.join(map(str, mesh.devices))})"
                )
                self._train_steps[ndp] = parallel.sharded_train_step(mesh)
            else:
                logger.info(
                    f"IL update: one device ({self.device}), "
                    f"TPU.data_parallel_devices "
                    f"{self.config.TPU.data_parallel_devices} with "
                    f"{len(self.data_devices)} device(s) and {n_lanes} "
                    "lanes"
                )
                self._train_steps[ndp] = il_update.train_step
        return self._train_steps[ndp]

    def _initialize_training(self, config) -> None:
        """The policy and its optimizer for training; with
        ``IL.load_from_ckpt`` the weights of ``IL.ckpt_to_load`` and, with
        ``IL.is_requeue``, its optimizer state (the port's, or the JAX
        trainer's optax Adam state from its pickle or Orbax directory:
        ``cio.adam_state_from_optax``), epoch and step (JAX
        base_trainer.py:169-224; its own resume from an Orbax directory
        fails, ROADMAP §3), in ``train_mode``."""
        load = config.IL.load_from_ckpt
        policy, ckpt = self._build_policy(
            config, config.IL.ckpt_to_load if load else None
        )
        self.policy = il_update.train_mode(policy)
        self.optimizer = il_update.make_optimizer(policy, config)
        self.start_epoch, self.step_id = 0, 0
        if ckpt is not None and config.IL.is_requeue and "optim_state" in ckpt:
            optim_state = ckpt["optim_state"]
            if isinstance(optim_state, dict) and "param_groups" in optim_state:
                self.optimizer.load_state_dict(optim_state)
            else:  # the JAX trainer's pickle: optax Adam's moments
                cio.adam_state_from_optax(optim_state, self.optimizer, policy)
            self.start_epoch = ckpt["epoch"] + 1
            self.step_id = ckpt["step_id"]

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
        (JAX base_trainer.py:689-739), on one device or data-parallel
        (``_train_step_fn``); the masks may be (T, N) or the collate's
        T-major (T*N, 1). An ``rnn_states`` carry continues a sequence.
        Returns (loss, action loss, aux loss) as floats and the final
        rnn_states."""
        t, n = corrected_actions.shape
        if rnn_states is None:
            rnn_states = self.policy.initial_rnn_states(n, self.device)
        if tour_not_done_masks is None:
            tour_not_done_masks = not_done_masks
        step = self._train_step_fn(n)
        model = self.config.MODEL
        with profiling.span("train_step"):
            loss, action_loss, aux_loss, rnn_out = step(
                self.policy, self.optimizer, observations,
                np.asarray(prev_actions, np.int64),
                np.asarray(not_done_masks, np.float32).reshape(t, n),
                np.asarray(tour_not_done_masks, np.float32).reshape(t, n),
                np.asarray(corrected_actions, np.int64),
                np.asarray(weights, np.float32), rnn_states,
                model.PROGRESS_MONITOR.use, model.PROGRESS_MONITOR.alpha,
                il_update.refreshes_map_bn(self.policy),
            )
            with profiling.span("device_sync"):
                losses = [float(x) for x in
                          torch.stack([loss, action_loss, aux_loss]).cpu()]
        # the weights changed: the cached instruction features are stale
        if self.instruction_cache is not None:
            self.instruction_cache.clear()
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
        """The enabled mapper obs transform and its device step, which
        uploads through the step's arena; none for a policy that reads no
        map (LatentCMA)."""
        self.obs_transforms = get_active_obs_transforms(config, self.device)
        self._device_step = (
            self.obs_transforms[0].make_device_step(self._upload)
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
        as uint16, staged with the semantic or RGB frame in one copy; pose,
        orientation and scene centres stay on the host; instruction tokens
        become cached features."""
        wire_keys = batching.wire_obs_keys(self.policy, transform)
        with profiling.span("wire_obs"):
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
        with profiling.span("upload"):
            dobs.update(self._upload({
                k: v for k, v in dobs.items()
                if k not in batching.HOST_OBS_KEYS}))
        key = next((k for k in ("instruction", "rxr_instruction")
                    if k in dobs), None)
        if key is not None:
            dobs["instruction_features"], encoded = self.instruction_cache(
                dobs.pop(key), self._upload)
            self.instruction_encodes += int(encoded > 0)
            self.instruction_rows_encoded += encoded
        return dobs

    def _step_inputs(self, batch, reset_masks, rnn_states, prev_actions,
                     masks):
        """The host half of a policy or collection step: the lane map, the
        transform's ``host_prepare``, the wire obs with the cached
        instruction features, and the masks and previous actions on the
        device, every copy staged in this step's arena. Returns (live
        rows, transform, obs, full-width previous actions, full-width
        masks)."""
        self._upload.begin_step()
        if self._lane_rows is None or rnn_states.shape[0] != self._num_rows:
            self._reset_lanes(rnn_states.shape[0])
        rows = self._lane_rows
        transform = self.obs_transforms[0] if self.obs_transforms else None
        if transform is not None:
            # before the wire obs: host_prepare may add scene_center to the
            # batch besides allocating state and preloading known maps
            with profiling.span("host_prepare"):
                transform.host_prepare(
                    batch, np.asarray(reset_masks).reshape(-1), rows=rows,
                    num_rows=self._num_rows,
                )
        obs = batching.decode_wire_obs(self._wire_device_obs(batch, transform))
        with profiling.span("upload"):
            host = {f"mask{i}": np.asarray(self._expand_rows(m), np.float32)
                    for i, m in enumerate(masks)}
            host["prev"] = np.asarray(self._expand_rows(prev_actions),
                                      np.int64)
            got = self._upload(host)
        prev_full = got.pop("prev")
        return rows, transform, obs, prev_full, list(got.values())

    def _mapper_step(self, transform, obs, reset_masks) -> Dict[str, Any]:
        """The transform's device step (``self._device_step`` at each call)
        on ``obs``, its new state kept: ``obs`` with the step's maps."""
        reset_full = self._expand_rows(
            np.asarray(reset_masks, np.float32).reshape(-1))
        with profiling.span("mapper"):
            transform.state, occ, sem = self._device_step(
                transform.state, obs, reset_full, transform.rednet)
        return dict(obs, occupancy_map=occ, semantic_map=sem)

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
        with profiling.span("policy_step"):
            rows, transform, obs, prev_full, masks_full = self._step_inputs(
                batch, reset_masks, rnn_states, prev_actions, masks)
            self._pending_maps = None
            if transform is not None:
                obs = self._mapper_step(transform, obs, reset_masks)
                if need_maps:
                    self._pending_maps = (obs["occupancy_map"],
                                          obs["semantic_map"], rows)
            act = self.policy.act_iterative if iterative else self.policy.act
            out = act(obs, rnn_states, prev_full, *masks_full,
                      generator=self._generator)
            with profiling.span("device_sync"):
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
            # a file, or ckpt.N.pth naming its Orbax directory
            if os.path.isfile(ckpt_dir) or os.path.isdir(ckpt_dir + ".orbax"):
                ckpt_index = 0
                with contextlib.suppress(ValueError, IndexError):
                    ckpt_index = int(ckpt_dir.split(".")[-2])
                self._eval_checkpoint(ckpt_dir, writer, ckpt_index)
            else:
                for index, path in checkpoints_in(ckpt_dir):
                    self._eval_checkpoint(path, writer, index)

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
            actions, rnn_states = self._policy_step(
                batch, not_done_masks, rnn_states, prev_actions,
                (not_done_masks,), iterative=False, need_maps=videos,
            )
            prev_actions = actions
            envs.step_async([int(a[0]) for a in actions])
            with profiling.span("materialize_maps"):
                self._materialize_maps(batch)
            with profiling.span("env_step_wait"):
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

            with profiling.span("batch_obs"):
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
            actions, rnn_states = self._policy_step(
                batch, reset_masks, rnn_states, prev_actions,
                (agent_masks, sim_masks, tour_masks, action_masks),
                need_maps=videos,
            )
            prev_actions = actions
            envs.step_async([int(a[0]) for a in actions])
            with profiling.span("materialize_maps"):
                self._materialize_maps(batch)
            with profiling.span("env_step_wait"):
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

            with profiling.span("batch_obs"):
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
