"""Seeded mapper inputs for checking and timing the mapper's kernels.

Each generator yields, per step, what ``mapping.mapper.mapper_step``
takes from the host: depth (B, H, W) float32 normalized to [0, 1], labels
(B, H, W) uint8, camera pose (B, 3), orientation (B, 2) as (elevation,
heading), and the not-done masks (B,).

- ``fakesim_walk``: frames rendered by the simulator the evaluations run
  (``envs/fake_sim.py``), so smooth as the main path's are: a wall
  column's pixels land in one grid cell.
- ``tie_walk``: frames built so that many pixels share a cell and an
  exact float32 height key, to exercise every tie rule of the grid and
  the raster.
"""

from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Iterator, Sequence, Tuple

import numpy as np

from ivlnce_tpu_torch.envs.fake_sim import FakeSim
from ivlnce_tpu_torch.envs.sim_api import SimActions, quat_from_heading
from ivlnce_tpu_torch.tasks.sensors import (
    WorldRobotOrientationSensor,
    WorldRobotPoseSensor,
)

Step = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]

# the fake val_seen split's scenes (data/datasets/fake/val_seen)
VAL_SEEN_SCENES = tuple(
    f"mp3d/fakeval_seen{i}/fakeval_seen{i}.glb" for i in range(3))


def fakesim_walk(batch: int, hw: int, steps: int, seed: int,
                 scenes: Sequence[str] = VAL_SEEN_SCENES) -> Iterator[Step]:
    """Lane i walks scene ``scenes[i % len(scenes)]`` from a seeded
    navigable start and heading, taking a seeded action per step (forward
    twice as often as either turn), its depth camera ``hw`` x ``hw`` with
    a 90 degree field of view. Pose and orientation are what the
    evaluation's sensors report."""
    rng = np.random.default_rng(seed)
    camera = SimpleNamespace(HEIGHT=hw, WIDTH=hw, HFOV=90)
    config = SimpleNamespace(FORWARD_STEP_SIZE=0.25, TURN_ANGLE=15,
                             RGB_SENSOR=camera, DEPTH_SENSOR=camera)
    sims = []
    for i in range(batch):
        sim = FakeSim(config, scenes[i % len(scenes)])
        half = sim.scene.extent / 2 - 0.5
        while True:
            x, z = rng.uniform(-half, half, 2)
            if sim.scene.is_navigable_xz(x, z):
                break
        sim.set_agent_state([x, 0.0, z],
                            quat_from_heading(rng.uniform(0, 2 * math.pi)))
        sims.append(sim)
    pose_sensors = [WorldRobotPoseSensor(sim=s) for s in sims]
    orient_sensors = [WorldRobotOrientationSensor(sim=s) for s in sims]
    actions = (SimActions.MOVE_FORWARD, SimActions.MOVE_FORWARD,
               SimActions.TURN_LEFT, SimActions.TURN_RIGHT)
    for t in range(steps):
        if t == 0:
            obs = [s.render_observations() for s in sims]
        else:
            obs = [s.step(actions[rng.integers(len(actions))]) for s in sims]
        yield (
            np.stack([o["depth"][..., 0] for o in obs]).astype(np.float32),
            np.stack([o["semantic12"][..., 0] for o in obs]).astype(np.uint8),
            np.stack([p.get_observation(None, None) for p in pose_sensors]),
            np.stack([o.get_observation(None, None)
                      for o in orient_sensors]).astype(np.float32),
            np.ones(batch, np.float32),
        )


# normalized depths of the tie frames: two outside the filters (0 and 1),
# the rest from 0.2 m to 9 m
_TIE_DEPTHS = np.float32([0.0, 0.02, 0.05, 0.08, 0.12, 0.2, 0.35, 0.5, 0.7,
                          0.9, 1.0])


def tie_walk(batch: int, hw: int, steps: int, seed: int,
             edge_step: float = 0.0, empty_lanes: Sequence[int] = ()
             ) -> Iterator[Step]:
    """Frames where many pixels share a cell and a float32 height key.

    Elevation is 0, so a pixel's world height does not depend on its
    column (the camera matrix's height row is [0, cos, -sin]): every
    pixel of a row of equal depth has the same key, and those a grid cell
    wide share that cell too, so the lowest pixel must win. Depth is
    constant along each row, drawn from ``_TIE_DEPTHS`` in runs of 1 to 8
    rows, and 9 m in the two rows at the horizon; labels are random per
    pixel, so a wrong winner shows in the maps. Headings are multiples of
    90 degrees, so a row's cells lie on one grid line and many map cells
    get candidates of one key, tied by window index. Steps come in pairs: the second repeats the first's
    depth and pose with new labels, so every new point ties a stored one
    and the stored one must stay. After each pair lane 0 moves
    ``edge_step`` metres along +x, so with a large enough step its frames
    leave the grid and are counted as dropped; lanes in ``empty_lanes``
    see only depths outside the filters, so their windows stay empty."""
    rng = np.random.default_rng(seed)
    pose = np.zeros((batch, 3), np.float32)
    pose[:, 0] = rng.uniform(-1, 1, batch)
    pose[:, 1] = 1.25
    pose[:, 2] = rng.uniform(-1, 1, batch)
    heading = (rng.integers(0, 4, batch) * (math.pi / 2)).astype(np.float32)
    depth = None
    for t in range(steps):
        if t % 2 == 0:
            depth = np.empty((batch, hw, hw), np.float32)
            for b in range(batch):
                rows = []
                while len(rows) < hw:
                    level = _TIE_DEPTHS[rng.integers(len(_TIE_DEPTHS))]
                    rows += [level] * int(rng.integers(1, 9))
                depth[b] = np.float32(rows[:hw])[:, None]
            # the rows at the horizon see 9 m, so points lie far from the
            # robot in every frame
            depth[:, hw // 2 - 1:hw // 2 + 1] = np.float32(0.9)
            depth[list(empty_lanes)] = 0.0
        sem = rng.integers(0, 13, (batch, hw, hw)).astype(np.uint8)
        orient = np.stack([np.zeros(batch, np.float32), heading], -1)
        yield depth.copy(), sem, pose.copy(), orient, np.ones(batch,
                                                              np.float32)
        if t % 2 == 1:
            pose[0, 0] += np.float32(edge_step)
            heading = (heading + np.float32(math.pi / 2)).astype(np.float32)
