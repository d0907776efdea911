"""Dataset-driven world-grid sizing (VERDICT r3 next #9).

The dense world grid is the mapper's per-lane HBM ceiling (8 bytes/cell;
the old fixed 1024-cell side = 51.2 m = 8.4 MB/lane OOMed at B=1024).
Real scenes are far smaller than 51.2 m, and the grid does not need to be
robot-start-centered: centering each lane's grid on its SCENE halves the
extent the grid must cover (a start near a scene wall otherwise needs the
full scene diameter on both sides), and is strictly better for tour mode
where the agent eventually visits the whole scene.

This module computes per-scene (x, z) centers and the split-wide grid
side from the episode geometry the dataset already carries — starts,
goals, and reference paths (reference task.py:38-46) — without touching
the simulator. Undersizing stays loud: points outside the grid extent
land in MapperState.dropped and trainers warn at eval end.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

from ivlnce_tpu_torch.tasks.dataset import (
    env_name_from_scene_path,
    make_dataset,
)


def scene_geometry_from_dataset(
    dataset_config,
) -> Tuple[Dict[str, Tuple[float, float]], float]:
    """Per-scene grid centers and the largest scene span.

    Returns ``(centers, span)`` where ``centers[env_name] = (x, z)`` is
    the midpoint of the scene's episode-geometry bounding box (keyed by
    the EnvNameSensor's name, tasks/sensors.py:190-193) and ``span`` is
    the largest scene's bounding-box side in meters (max over x/z).

    Bounds come from every episode's start position, goal positions, and
    reference-path waypoints; walls the depth camera can see beyond the
    walkable area are covered by the caller's margin.
    """
    dataset = make_dataset(dataset_config.TYPE, dataset_config)
    bounds: Dict[str, Tuple[float, float, float, float]] = {}

    def fold(name: str, x: float, z: float) -> None:
        b = bounds.get(name)
        bounds[name] = (
            (x, x, z, z)
            if b is None
            else (min(b[0], x), max(b[1], x), min(b[2], z), max(b[3], z))
        )

    for ep in dataset.episodes:
        # keyed by env_name (NOT scene_from_scene_path): lanes look
        # centers up with EnvNameSensor observations, whose derivation
        # differs for multi-dot scene filenames (ADVICE r4)
        name = env_name_from_scene_path(ep.scene_id)
        pts = [ep.start_position]
        if ep.goals:
            pts += [g.position for g in ep.goals]
        if ep.reference_path:
            pts += list(ep.reference_path)
        for p in pts:
            fold(name, float(p[0]), float(p[2]))

    centers = {
        name: ((b[0] + b[1]) / 2.0, (b[2] + b[3]) / 2.0)
        for name, b in bounds.items()
    }
    span = max(
        (max(b[1] - b[0], b[3] - b[2]) for b in bounds.values()),
        default=0.0,
    )
    return centers, span


def auto_grid_cells(
    span_meters: float,
    margin_meters: float,
    half_res_meters: float,
    window_cells: int,
) -> int:
    """Static grid side (in half-res cells) covering ``span + margin``.

    ``margin_meters`` is a TOTAL addition to the bounding-box span — the
    grid is scene-centered, so the slack beyond the recorded episode
    geometry is margin/2 PER SIDE (5 m default = 2.5 m/side). The depth
    camera sees up to DEPTH_SCALE_METERS (10 m) past the agent, so
    off-path walls can exceed the slack near scene edges; that is an
    accepted trade (dropped points are counted and warned at eval end,
    never silent) because the power-of-two rounding below usually grants
    far more physical slack than the nominal margin anyway.

    Rounded up to a power of two (sort/slice-friendly shapes; XLA tiles
    them best) with a floor of the egocentric rasterize window — the
    window slice must fit inside the grid. The fake 16 m scenes size to
    512 cells (25.6 m) = 2 MB/lane, 4x less than the old fixed 1024.
    """
    need_m = span_meters + margin_meters
    cells = max(int(math.ceil(need_m / half_res_meters)), window_cells, 256)
    return 1 << (cells - 1).bit_length()
