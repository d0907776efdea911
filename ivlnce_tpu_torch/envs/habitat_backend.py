"""habitat-sim backend: the real MP3D simulator behind the Simulator
protocol (sim_api.py).

The reference consumes habitat-sim through habitat-lab's ``Env``
(reference ``ivlnce_baselines/common/environments.py:4,168``); this
framework keeps its own episode/task layer (envs/env.py) and needs only the
raw simulator: scene loading, agent kinematics, sensor rendering, and
navmesh queries. This adapter provides exactly that surface, so the entire
stack above (iterative phase machine, sensors, measures, mappers, trainers)
runs unchanged on MP3D scenes when habitat-sim is installed, and on FakeSim
when it is not (env.py:make_sim falls back on ImportError).

Also here: the 12-class semantic whitelist mapping the reference implements
inside its Semantic12Sensor (``habitat_extensions/sensors.py:253-329``).
It is a pure function of the scene's semantic annotations, so it lives in
:class:`Semantic12Mapping` — built once per scene as a flat instance-id ->
class lookup table (the reference re-loops over ``np.unique`` ids every
frame; a LUT gather is one vectorized index per frame) — and is unit-tested
against mock annotations without habitat installed.

habitat-sim conventions honored here:
- y is up; the agent's heading is the rotation of -z about +y.
- Depth sensors return meters; the task config's NORMALIZE_DEPTH/MIN/MAX
  produce the [0, 1] depth frames the models consume.
- RGB sensors return RGBA; the alpha channel is dropped.
- The semantic sensor returns per-pixel instance ids (int32).
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence

import numpy as np

from ivlnce_tpu_torch.envs.sim_api import AgentState, SimActions

logger = logging.getLogger("ivlnce_tpu_torch")

# Default ceiling on MP3D instance ids; LUTs grow on demand if a scene
# has more instances.
_DEFAULT_LUT_SIZE = 4096


class Semantic12Mapping:
    """Instance ids -> {0 void, 1..12 whitelist} labels.

    Mirrors the reference mapping exactly (sensors.py:253-329): an
    instance's mpcat40 category name is looked up in the whitelist; for
    the coarse names in ``use_fine`` the raw category name is used
    instead; whitelist index + 1 is the label, everything else is void.
    """

    use_fine = ("appliances", "furniture")
    object_whitelist = (
        "shelving",
        "chest_of_drawers",
        "bed",
        "cushion",
        "fireplace",
        "sofa",
        "table",
        "chair",
        "cabinet",
        "plant",
        "counter",
        "sink",
    )

    def __init__(self, semantic_annotations) -> None:
        """``semantic_annotations`` is habitat-sim's per-scene annotation
        object: ``.objects`` with ``.id`` ("<level>_<region>_<n>" or
        "..._<instance_id>") and ``.category.name(mapping=...)``."""
        self._lut = self.build_lut(semantic_annotations)

    @classmethod
    def label_for(cls, obj) -> int:
        if obj is None or obj.category is None:
            return 0
        name = obj.category.name(mapping="mpcat40")
        if name in cls.use_fine:
            name = obj.category.name(mapping="raw")
        if name in cls.object_whitelist:
            return cls.object_whitelist.index(name) + 1
        return 0

    @classmethod
    def build_lut(cls, semantic_annotations) -> np.ndarray:
        objects = {}
        for o in getattr(semantic_annotations, "objects", []) or []:
            if o is None:
                continue
            try:
                oid = int(str(o.id).split("_")[-1])
            except ValueError:
                continue
            objects[oid] = o
        size = max(_DEFAULT_LUT_SIZE, max(objects, default=0) + 1)
        lut = np.zeros((size,), np.uint8)
        for oid, obj in objects.items():
            lut[oid] = cls.label_for(obj)
        return lut

    def __call__(self, instance_frame: np.ndarray) -> np.ndarray:
        """(H, W) instance ids -> (H, W, 1) uint8 semantic12 labels."""
        ids = np.asarray(instance_frame)
        if ids.ndim == 3:
            ids = ids[..., 0]
        size = self._lut.shape[0]
        safe = np.clip(ids, 0, size - 1).astype(np.int64)
        labels = self._lut[safe]
        # ids beyond the annotation table are VOID, never the last LUT
        # entry's label (the reference hard-KeyErrors on unknown ids,
        # sensors.py:308-310; void is the lenient equivalent)
        return np.where(ids < size, labels, np.uint8(0))[..., None]


def _sensor_specs(sim_config):
    """Build habitat-sim CameraSensorSpec list from the task SIMULATOR
    node (AGENT_0.SENSORS selects which are active)."""
    import habitat_sim

    kinds = {
        "RGB_SENSOR": ("rgb", habitat_sim.SensorType.COLOR),
        "DEPTH_SENSOR": ("depth", habitat_sim.SensorType.DEPTH),
        "SEMANTIC_SENSOR": ("semantic", habitat_sim.SensorType.SEMANTIC),
    }
    active = list(sim_config.AGENT_0.SENSORS)
    # depth is required by the task even when configs only list RGB
    if "DEPTH_SENSOR" not in active:
        active.append("DEPTH_SENSOR")
    specs = []
    for key in active:
        if key not in kinds:
            continue
        uuid, stype = kinds[key]
        node = getattr(sim_config, key)
        spec = habitat_sim.CameraSensorSpec()
        spec.uuid = uuid
        spec.sensor_type = stype
        spec.resolution = [node.HEIGHT, node.WIDTH]
        spec.hfov = node.HFOV
        spec.position = list(node.POSITION)
        spec.orientation = list(node.ORIENTATION)
        specs.append(spec)
    return specs


class HabitatSimAdapter:
    """Simulator-protocol adapter over habitat-sim.

    One habitat_sim.Simulator instance, reconfigured per scene. All
    protocol methods are host-side numpy; frames flow to the device via
    the env layer's batching.
    """

    def __init__(self, sim_config, scene_id: str) -> None:
        import habitat_sim  # ImportError -> make_sim falls back to FakeSim

        self._hsim = habitat_sim
        self._config = sim_config
        self._scene_id = scene_id
        self.forward_step = float(sim_config.FORWARD_STEP_SIZE)
        self.turn_angle_deg = float(sim_config.TURN_ANGLE)
        self._depth_node = sim_config.DEPTH_SENSOR
        self.previous_step_collided = False
        self._semantic12: Optional[Semantic12Mapping] = None
        self._sim = None
        self._last_obs: Dict[str, np.ndarray] = {}
        self._make_sim(scene_id)

    # -- construction -------------------------------------------------------

    def _backend_config(self, scene_id: str):
        hsim = self._hsim
        backend = hsim.SimulatorConfiguration()
        backend.scene_id = scene_id
        backend.gpu_device_id = int(
            self._config.HABITAT_SIM_V0.GPU_DEVICE_ID
        )
        backend.allow_sliding = bool(
            self._config.HABITAT_SIM_V0.ALLOW_SLIDING
        )
        backend.random_seed = int(self._config.SEED)

        agent = hsim.agent.AgentConfiguration()
        agent.height = float(self._config.AGENT_0.HEIGHT)
        agent.radius = float(self._config.AGENT_0.RADIUS)
        agent.sensor_specifications = _sensor_specs(self._config)
        agent.action_space = {
            SimActions.STOP: hsim.agent.ActionSpec("move_forward",
                hsim.agent.ActuationSpec(amount=0.0)),
            SimActions.MOVE_FORWARD: hsim.agent.ActionSpec(
                "move_forward",
                hsim.agent.ActuationSpec(amount=self.forward_step),
            ),
            SimActions.TURN_LEFT: hsim.agent.ActionSpec(
                "turn_left",
                hsim.agent.ActuationSpec(amount=self.turn_angle_deg),
            ),
            SimActions.TURN_RIGHT: hsim.agent.ActionSpec(
                "turn_right",
                hsim.agent.ActuationSpec(amount=self.turn_angle_deg),
            ),
        }
        return hsim.Configuration(backend, [agent])

    def _make_sim(self, scene_id: str) -> None:
        if self._sim is not None:
            self._sim.close()
        self._sim = self._hsim.Simulator(self._backend_config(scene_id))
        self._scene_id = scene_id
        self._semantic12 = None  # rebuilt lazily per scene
        self._agent = self._sim.get_agent(
            int(self._config.DEFAULT_AGENT_ID)
        )

    def reconfigure(self, scene_id: str) -> None:
        if scene_id != self._scene_id:
            try:
                self._sim.reconfigure(self._backend_config(scene_id))
                self._scene_id = scene_id
                self._semantic12 = None
                self._agent = self._sim.get_agent(
                    int(self._config.DEFAULT_AGENT_ID)
                )
            except Exception:
                # some habitat-sim builds leak GL state on reconfigure;
                # fall back to a full rebuild
                self._make_sim(scene_id)

    def close(self) -> None:
        if self._sim is not None:
            self._sim.close()
            self._sim = None

    # -- observations -------------------------------------------------------

    def _postprocess(self, raw: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        obs: Dict[str, np.ndarray] = {}
        if "rgb" in raw:
            rgb = np.asarray(raw["rgb"])
            if rgb.ndim == 3 and rgb.shape[-1] == 4:
                rgb = rgb[..., :3]
            obs["rgb"] = rgb.astype(np.uint8, copy=False)
        if "depth" in raw:
            depth = np.asarray(raw["depth"], np.float32)
            node = self._depth_node
            lo, hi = float(node.MIN_DEPTH), float(node.MAX_DEPTH)
            depth = np.clip(depth, lo, hi)
            if bool(node.NORMALIZE_DEPTH):
                depth = (depth - lo) / max(hi - lo, 1e-8)
            if depth.ndim == 2:
                depth = depth[..., None]
            obs["depth"] = depth
        if "semantic" in raw:
            sem = np.asarray(raw["semantic"])
            obs["semantic"] = sem
            if self._semantic12 is None:
                self._semantic12 = Semantic12Mapping(
                    self._sim.semantic_scene
                )
            obs["semantic12"] = self._semantic12(sem)
        self._last_obs = obs
        return obs

    def reset(self) -> Dict[str, np.ndarray]:
        return self._postprocess(self._sim.get_sensor_observations())

    def render_observations(self) -> Dict[str, np.ndarray]:
        return self._postprocess(self._sim.get_sensor_observations())

    def step(self, action: int) -> Dict[str, np.ndarray]:
        action = int(action)
        if action == SimActions.STOP:
            self.previous_step_collided = False
            return self._postprocess(self._sim.get_sensor_observations())
        before = np.asarray(self._agent.get_state().position, np.float64)
        raw = self._sim.step(action)
        # habitat-sim reports collisions in the raw step obs ("collided");
        # habitat-lab's previous_step_collided reads exactly that key
        # (habitat_simulator.py _prev_sim_obs.get("collided")). Use it when
        # present — the distance heuristic below misses ALLOW_SLIDING
        # collisions that slide more than half the step (ADVICE r2).
        collided = raw.get("collided") if isinstance(raw, dict) else None
        if collided is not None:
            self.previous_step_collided = bool(collided)
        else:
            after = np.asarray(
                self._agent.get_state().position, np.float64
            )
            moved = float(np.linalg.norm(after - before))
            self.previous_step_collided = (
                action == SimActions.MOVE_FORWARD
                and moved < 0.5 * self.forward_step
            )
        return self._postprocess(raw)

    # -- agent state --------------------------------------------------------

    def get_agent_state(self) -> AgentState:
        s = self._agent.get_state()
        rot = s.rotation  # quaternion (habitat: w, x, y, z accessors)
        quat = np.array(
            [rot.x, rot.y, rot.z, rot.w], np.float64
        )
        return AgentState(
            position=np.asarray(s.position, np.float64), rotation=quat
        )

    def set_agent_state(
        self,
        position: Sequence[float],
        rotation: Sequence[float],
        reset_sensors: bool = True,
    ) -> None:
        state = self._agent.get_state()
        state.position = np.asarray(position, np.float32)
        r = np.asarray(rotation, np.float64)
        try:
            from habitat_sim.utils.common import quat_from_coeffs

            state.rotation = quat_from_coeffs(r)  # (x, y, z, w)
        except ImportError:  # quaternion package fallback
            import quaternion  # noqa: F401

            state.rotation = np.quaternion(r[3], r[0], r[1], r[2])
        state.sensor_states = {}
        self._agent.set_state(state, reset_sensors)

    # -- navmesh queries ----------------------------------------------------

    def geodesic_distance(self, position_a, position_b, episode=None) -> float:
        hsim = self._hsim
        targets = np.asarray(position_b, np.float32)
        if targets.ndim == 1:
            targets = targets[None]
        path = hsim.MultiGoalShortestPath()
        path.requested_start = np.asarray(position_a, np.float32)
        path.requested_ends = targets
        self._sim.pathfinder.find_path(path)
        return float(path.geodesic_distance)

    def is_navigable(self, position) -> bool:
        return bool(
            self._sim.pathfinder.is_navigable(
                np.asarray(position, np.float32)
            )
        )

    def get_straight_shortest_path_points(self, position_a, position_b):
        """Navmesh shortest-path waypoints (reference measures.py:318-326
        uses sim.get_straight_shortest_path_points)."""
        hsim = self._hsim
        path = hsim.ShortestPath()
        path.requested_start = np.asarray(position_a, np.float32)
        path.requested_end = np.asarray(position_b, np.float32)
        self._sim.pathfinder.find_path(path)
        return [list(np.asarray(p, float)) for p in path.points]

    def sample_navigable_point(self) -> List[float]:
        return list(
            np.asarray(
                self._sim.pathfinder.get_random_navigable_point(), float
            )
        )

    # -- map queries (TopDownMapVLNCE measure) -------------------------------

    def get_bounds(self):
        lower, upper = self._sim.pathfinder.get_bounds()
        return (
            np.asarray(lower, np.float32),
            np.asarray(upper, np.float32),
        )

    def get_topdown_map(self, map_resolution: int = 1024) -> np.ndarray:
        """(res, res) uint8 navigability raster at the agent's height."""
        lower, upper = self.get_bounds()
        height = float(self._agent.get_state().position[1])
        xs = np.linspace(lower[0], upper[0], map_resolution)
        zs = np.linspace(lower[2], upper[2], map_resolution)
        grid = np.zeros((map_resolution, map_resolution), np.uint8)
        for i, z in enumerate(zs):
            pts = np.stack(
                [xs, np.full_like(xs, height), np.full_like(xs, z)], 1
            )
            grid[i] = [
                self._sim.pathfinder.is_navigable(p) for p in pts
            ]
        return grid

    # -- semantic annotations (Semantic12Sensor) ------------------------------

    def semantic_annotations(self):
        return self._sim.semantic_scene
