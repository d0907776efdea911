"""Observation transformers: the egocentric mapper in the policy loop. The
PyTorch counterpart of ``ivlnce_tpu/mapping/obs_transforms.py``: four
registered variants, {GT, Predicted} semantics x {Iterative, Known} maps
(reference obs_transforms.py:30-134).

The transformer owns a MapperState on the device. Per step,
``host_prepare`` allocates it, adds the lanes' scene centres when the grid
was sized from scene bounds, and in known-map mode preloads each lane's
scene cloud (K3) when the lane starts a tour or changes scene; then the
device step turns the depth frame and the semantics (the ``semantic12``
sensor, or RedNet's labels of the RGB frame) into uint8 occupancy and
semantic maps."""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ivlnce_tpu_torch.mapping.camera import (
    CameraParameters,
    camera_parameters_from_config,
)
from ivlnce_tpu_torch.mapping.mapper import (
    MapperParams,
    MapperState,
    init_state,
    load_lanes,
    mapper_step,
)
from ivlnce_tpu_torch.models.nn import compute_dtype as nn_compute_dtype
from ivlnce_tpu_torch.ops.geometry import MapDims
from ivlnce_tpu_torch.utils import logging_util, profiling
from ivlnce_tpu_torch.utils import upload as U
from ivlnce_tpu_torch.utils.registry import registry

REDNET_CHECKPOINT = "data/rednet_mp3d_best_model.pkl"


class Mapper:
    """Base obs transformer (obs_transforms.py:30-134)."""

    predicted_semantics = False
    known_maps = False
    maps_location: Optional[str] = None

    def __init__(
        self,
        camera_parameters: CameraParameters,
        map_dimensions: MapDims,
        device: torch.device,
        grid_cells: int = 1024,
        window_cells: int = 192,
        rednet: Optional[torch.nn.Module] = None,
        maps_location: Optional[str] = None,
        known_map_max_points: int = 2 ** 18,
        scene_centers: Optional[Dict[str, tuple]] = None,
        compute_dtype: str = "float32",
    ):
        self.params = MapperParams(
            camera=camera_parameters,
            map_height_meters=map_dimensions.height_meters,
            map_width_meters=map_dimensions.width_meters,
            resolution_meters=map_dimensions.resolution_meters,
            grid_cells=grid_cells,
            window_cells=window_cells,
        )
        self.params.validate()
        self.device = device
        self.state: Optional[MapperState] = None
        self.rednet = rednet
        # RedNet's dtype (TPU.compute_dtype; JAX obs_transforms.py:67-68)
        self.compute_dtype = nn_compute_dtype(compute_dtype)
        if maps_location is not None:
            self.maps_location = maps_location
        self.known_map_max_points = known_map_max_points
        self._loaded_env_names: List[Optional[str]] = []
        # env_name -> (xyz (n, 3), sem (n,), n) on the device, kept after a
        # scene's first load
        self._known_map_cache: Dict[str, tuple] = {}
        # per-scene (x, z) grid centres (mapping/scene_bounds.py); lanes of
        # unknown scenes centre on the robot
        self.scene_centers = scene_centers
        # per-scene points cut at the preload cap (the reference loads
        # whole npz files, mapper.py:283-294)
        self._preload_truncated: Dict[str, int] = {}
        self.known_map_loads = 0  # lanes loaded with a scene's cloud

    # -- lane management -----------------------------------------------------
    def reset(self) -> None:
        """Drop the lane state: a new set of envs (a DAgger collection)
        starts from empty grids."""
        self.state = None
        self._loaded_env_names = []

    def _ensure_state(self, batch_size: int):
        if self.state is None or self.state.batch_size != batch_size:
            self.state = init_state(
                batch_size, self.params.grid_cells, self.device
            )
            self._loaded_env_names = [None] * batch_size

    @property
    def device_obs_keys(self) -> frozenset:
        """Sensors the device step reads (the upload filter,
        utils/batching.wire_obs_keys, drops everything else). Known maps
        accumulate no frames, so they read no semantics."""
        keys = {"depth", "world_robot_pose", "world_robot_orientation"}
        if not self.known_maps:
            keys.add("rgb" if self.predicted_semantics else "semantic12")
        if self.scene_centers:
            keys.add("scene_center")  # added by host_prepare
        return frozenset(keys)

    def dropped_point_count(self) -> int:
        """Total points lost to the bounded world grid across all lanes:
        nonzero means a scene outgrew grid_cells * half_res."""
        if self.state is None:
            return 0
        return int(self.state.dropped.sum())

    def preload_truncated_count(self) -> int:
        """Total known-map points cut at the TPU.known_map_max_points
        preload cap, summed over loaded scenes."""
        return sum(self._preload_truncated.values())

    def warn_if_dropped(self, context: str = "eval") -> int:
        count = self.dropped_point_count()
        if count > 0:
            extent = self.params.grid_cells * self.params.half_res
            logging_util.logger.warning(
                f"{type(self).__name__}: {count} depth points fell outside "
                f"the {extent:.1f} m bounded world grid during {context}; "
                "maps are missing geometry — raise TPU.world_grid_cells"
            )
        truncated = self.preload_truncated_count()
        if truncated > 0:
            worst = max(self._preload_truncated.items(), key=lambda kv: kv[1])
            logging_util.logger.warning(
                f"{type(self).__name__}: {truncated} known-map points were "
                f"cut at the {self.known_map_max_points}-point preload cap "
                f"during {context} (worst scene {worst[0]}: {worst[1]} "
                "points); maps are missing geometry — raise "
                "TPU.known_map_max_points"
            )
        return count + truncated

    # -- known maps ------------------------------------------------------------
    def _load_known_map(self, env_name: str):
        """The scene's cloud on the device, cut at the preload cap."""
        if env_name not in self._known_map_cache:
            path = os.path.join(self.maps_location, f"{env_name}.npz")
            with np.load(path) as f:
                xyz = np.asarray(f["xyz"], np.float32)
                sem = np.asarray(f["semantics"], np.uint8)
            n = min(len(xyz), self.known_map_max_points)
            if n < len(xyz):
                self._preload_truncated[env_name] = len(xyz) - n
                logging_util.logger.warning(
                    f"{type(self).__name__}: known map {env_name} has "
                    f"{len(xyz)} points; truncating to the "
                    f"{self.known_map_max_points}-point preload cap "
                    f"({len(xyz) - n} dropped) — raise "
                    "TPU.known_map_max_points"
                )
            got = U.blocking({"xyz": xyz[:n], "sem": sem[:n]}, self.device)
            self._known_map_cache[env_name] = (got["xyz"], got["sem"], n)
        return self._known_map_cache[env_name]

    def _stack_clouds(self, clouds):
        """(L, N, 3) xyz, (L, N) labels and (L,) counts of cached clouds,
        N the largest count; padding points lie beyond the counts."""
        counts = np.array([c[2] for c in clouds], np.int32)
        n = max(int(counts.max()), 1)
        xyz = torch.zeros((len(clouds), n, 3), dtype=torch.float32,
                          device=self.device)
        sem = torch.zeros((len(clouds), n), dtype=torch.uint8,
                          device=self.device)
        for i, (x, s, k) in enumerate(clouds):
            xyz[i, :k] = x
            sem[i, :k] = s
        return xyz, sem, U.blocking({"counts": counts},
                                    self.device)["counts"]

    def _maybe_load_known_maps(self, observations: Dict, masks: np.ndarray,
                               rows=None) -> None:
        """Reload lane i's scene cloud into state row ``rows[i]`` when its
        mask is 0 (a new tour, which wipes what the lane saw) or its
        ``env_name`` changed; only those rows are loaded."""
        env_names = observations.get("env_name")
        b = len(masks)
        if rows is None:
            rows = np.arange(b)
        live_pose = np.asarray(observations["world_robot_pose"], np.float32)
        # centre loaded grids on the scene when its bounds are known, so
        # the cloud fits a scene-sized grid wherever the robot starts
        live_centers = (
            self._host_scene_centers(observations)
            if self.scene_centers
            else live_pose[:, [0, 2]]
        )
        lanes, clouds, centers = [], [], []
        for i in range(b):
            row = int(rows[i])
            name = env_names[i] if env_names is not None else None
            if masks[i] == 0 or self._loaded_env_names[row] != name:
                clouds.append(self._load_known_map(name))
                lanes.append(row)
                centers.append(live_centers[i])
                self._loaded_env_names[row] = name
        if lanes:
            self.known_map_loads += len(lanes)
            with profiling.span("known_map_load"):
                xyz, sem, counts = self._stack_clouds(clouds)
                load_lanes(self.params, self.state, lanes, xyz, sem, counts,
                           np.stack(centers).astype(np.float32))

    def _host_scene_centers(self, observations: Dict) -> np.ndarray:
        """(b, 2) per-lane world (x, z) grid centres: the scene's centre
        when known (keyed by env_name), else the lane's robot pose."""
        live_pose = np.asarray(observations["world_robot_pose"], np.float32)
        centers = live_pose[:, [0, 2]].copy()
        names = observations.get("env_name")
        if names is not None:
            for i, name in enumerate(names):
                c = self.scene_centers.get(name)
                if c is not None:
                    centers[i] = c
        return centers

    # -- fused-step API (trainers/base_trainer.py) ---------------------------
    def host_prepare(self, observations: Dict, masks: np.ndarray, rows=None,
                     num_rows: Optional[int] = None) -> None:
        """Host-side work before the device step: allocate the lane state
        (``num_rows``, the full lane count, keeps it full-width while lanes
        pause; ``rows[i]`` is live lane i's state row), add
        ``scene_center`` to ``observations`` when scene centres are known,
        and preload known maps. Runs before the trainer builds the wire
        obs."""
        self._ensure_state(num_rows or len(masks))
        if self.scene_centers:
            observations["scene_center"] = self._host_scene_centers(
                observations
            )
        if self.known_maps:
            self._maybe_load_known_maps(observations, masks, rows)

    def make_device_step(self, upload: Optional[U.Upload] = None):
        """A function (state, obs, reset_masks, rednet) -> (state,
        occupancy, semantic). ``obs`` holds device ``depth`` and
        ``semantic12`` or uint8 ``rgb``, host ``world_robot_pose`` /
        ``world_robot_orientation`` and, with scene centres, host
        ``scene_center``; ``reset_masks`` is a host array. Known maps feed
        all-ones masks (reloads handle resets, mapper.py:851-881) and
        accumulate nothing. The mapper's per-lane inputs go through
        ``upload`` (the trainer's ``utils/upload.py::StagedUpload``; by
        default blocking copies)."""
        params = self.params
        predicted = self.predicted_semantics
        known = self.known_maps
        dtype = self.compute_dtype

        def device_step(state, obs, reset_masks, rednet=None):
            depth = obs["depth"]
            if depth.dim() == 4:
                depth = depth[..., 0]
            if known:
                semantics = None
                masks = np.ones((depth.shape[0],), np.float32)
            else:
                if predicted:
                    from ivlnce_tpu_torch.models.rednet import (
                        predict_semantics,
                    )

                    with profiling.span("semantics"):
                        semantics = predict_semantics(rednet, obs["rgb"],
                                                      depth, dtype)
                else:
                    semantics = obs["semantic12"]
                    if semantics.dim() == 4:
                        semantics = semantics[..., 0]
                    semantics = semantics.to(torch.uint8)
                masks = np.asarray(reset_masks, np.float32).reshape(-1)
            center = obs.get("scene_center")
            return mapper_step(
                params,
                state,
                depth,
                semantics,
                np.asarray(obs["world_robot_pose"], np.float32),
                np.asarray(obs["world_robot_orientation"], np.float32),
                None,
                masks,
                update_world=not known,
                scene_center=(None if center is None
                              else np.asarray(center, np.float32)),
                upload=upload,
            )

        return device_step

    @classmethod
    def from_config(cls, config, device: torch.device):
        mapper_cfg = config.RL.POLICY.OBS_TRANSFORMS.EGOCENTRIC_MAPPER
        camera = camera_parameters_from_config(
            config.TASK_CONFIG.SIMULATOR.DEPTH_SENSOR, mapper_cfg
        )
        dims = MapDims(
            mapper_cfg.height_meters,
            mapper_cfg.width_meters,
            mapper_cfg.resolution_meters,
        )
        kwargs = {"known_map_max_points": config.TPU.known_map_max_points,
                  "compute_dtype": config.TPU.compute_dtype}
        if cls.predicted_semantics and not cls.known_maps:
            kwargs["rednet"] = _load_rednet(config, device)
        grid_cells = config.TPU.world_grid_cells
        if grid_cells == 0:
            # auto: size the grid from the split's scene geometry and
            # centre each lane's grid on its scene
            from ivlnce_tpu_torch.mapping.scene_bounds import (
                auto_grid_cells,
                scene_geometry_from_dataset,
            )

            centers, span = scene_geometry_from_dataset(
                config.TASK_CONFIG.DATASET
            )
            grid_cells = auto_grid_cells(
                span,
                config.TPU.world_grid_margin_meters,
                dims.resolution_meters / 2,
                192,
            )
            kwargs["scene_centers"] = centers
            logging_util.logger.info(
                f"{cls.__name__}: world grid auto-sized to {grid_cells} "
                f"cells ({grid_cells * dims.resolution_meters / 2:.1f} m) "
                f"from {len(centers)} scene(s), max span {span:.1f} m + "
                f"{config.TPU.world_grid_margin_meters:.1f} m margin"
            )
        return cls(camera, dims, device, grid_cells=grid_cells, **kwargs)


def _load_rednet(config, device: torch.device):
    """RedNet with the reference's weights from ``REDNET_CHECKPOINT`` or,
    when that file is missing, seeded random weights, as the JAX package
    falls back to (obs_transforms.py:446-470). Its weights stay float32;
    the device step casts them for ``TPU.compute_dtype``."""
    from ivlnce_tpu_torch.models.checkpoint_io import load_rednet, merge_params
    from ivlnce_tpu_torch.models.rednet import RedNet

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = RedNet()
    if os.path.exists(REDNET_CHECKPOINT):
        model.load_state_dict(
            merge_params(model.state_dict(), load_rednet(REDNET_CHECKPOINT))
        )
    else:
        logging_util.logger.warning(
            f"RedNet checkpoint missing at {REDNET_CHECKPOINT}; "
            "using randomly initialized weights"
        )
    return model.to(device).eval()


@registry.register_obs_transformer(name="GTSemanticsIterativeMapper")
class GTSemanticsIterativeMapper(Mapper):
    """Ground-truth semantics (the ``semantic12`` sensor), a world map
    that persists across the episodes of a tour."""


@registry.register_obs_transformer(name="PredictedSemanticsIterativeMapper")
class PredictedSemanticsIterativeMapper(Mapper):
    """RedNet's labels of the RGB frame, a tour-persistent world map."""

    predicted_semantics = True


@registry.register_obs_transformer(name="GTSemanticsKnownMapper")
class GTSemanticsKnownMapper(Mapper):
    """The scene's ground-truth cloud, preloaded; frames add nothing."""

    known_maps = True
    maps_location = "data/known_maps/gt_semantics"


@registry.register_obs_transformer(name="PredictedSemanticsKnownMapper")
class PredictedSemanticsKnownMapper(Mapper):
    """The scene's predicted-semantics cloud, preloaded."""

    predicted_semantics = True
    known_maps = True
    maps_location = "data/known_maps/predicted_semantics"


def get_active_obs_transforms(config, device: torch.device) -> List[Mapper]:
    """Instantiate RL.POLICY.OBS_TRANSFORMS.ENABLED_TRANSFORMS."""
    return [
        registry.get_obs_transformer(name).from_config(config, device)
        for name in config.RL.POLICY.OBS_TRANSFORMS.ENABLED_TRANSFORMS
    ]
