"""Top-down map drawing utilities.

Reference: habitat_extensions/maps.py — color palette, map colorization
with fog-of-war shading, dotted/solid line drawing, agent/point/triangle
sprites, reference- and shortest-path overlays, and nearest-MP3D-node
tracking over a connectivity graph.

Host-side visualization only (cv2 + numpy); never on the device path.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

try:
    import cv2
except ImportError:  # visualization degrades gracefully
    cv2 = None

# palette (maps.py:14-46 defines named BGR colors; values here are our own)
MAP_INVALID_POINT = 0
MAP_VALID_POINT = 1
MAP_BORDER_INDICATOR = 2
MAP_SOURCE_POINT_INDICATOR = 4
MAP_TARGET_POINT_INDICATOR = 6
MAP_MP3D_WAYPOINT = 8
MAP_SHORTEST_PATH_WAYPOINT = 14
MAP_REFERENCE_POINT = 17
MAP_AGENT_SPRITE = 20

# trail thickness divisor (reference maps.py:14)
MAP_THICKNESS_SCALAR = 128

TOP_DOWN_MAP_COLORS = np.full((256, 3), 150, dtype=np.uint8)
# indices >= 15 form the agent-trail gradient (reference maps.py:30-33
# uses a JET colormap over 15..255; a blue->red ramp keeps the same
# "early steps cold, late steps hot" reading without cv2's colormap)
_ramp = np.linspace(0.0, 1.0, 241)[:, None]
TOP_DOWN_MAP_COLORS[15:] = (
    np.array([[0, 60, 220]]) * (1 - _ramp) + np.array([[220, 40, 0]]) * _ramp
).astype(np.uint8)
TOP_DOWN_MAP_COLORS[MAP_INVALID_POINT] = [255, 255, 255]  # white
TOP_DOWN_MAP_COLORS[MAP_VALID_POINT] = [150, 150, 150]  # gray
TOP_DOWN_MAP_COLORS[MAP_BORDER_INDICATOR] = [50, 50, 50]  # dark gray
TOP_DOWN_MAP_COLORS[MAP_SOURCE_POINT_INDICATOR] = [0, 0, 200]  # blue
TOP_DOWN_MAP_COLORS[MAP_TARGET_POINT_INDICATOR] = [200, 0, 0]  # red
TOP_DOWN_MAP_COLORS[MAP_MP3D_WAYPOINT] = [0, 200, 0]  # green
TOP_DOWN_MAP_COLORS[MAP_SHORTEST_PATH_WAYPOINT] = [0, 150, 200]  # teal
TOP_DOWN_MAP_COLORS[MAP_REFERENCE_POINT] = [100, 0, 200]  # purple
TOP_DOWN_MAP_COLORS[MAP_AGENT_SPRITE] = [200, 100, 0]  # orange


def colorize_topdown_map(
    top_down_map: np.ndarray,
    fog_of_war_mask: Optional[np.ndarray] = None,
    fog_of_war_desat_amount: float = 0.5,
) -> np.ndarray:
    """Index map -> RGB, desaturating unexplored area (maps.py:61-80)."""
    _map = TOP_DOWN_MAP_COLORS[top_down_map]
    if fog_of_war_mask is not None:
        fog_of_war_desat_values = np.array(
            [[fog_of_war_desat_amount], [1.0]], np.float32
        )
        desat_mask = top_down_map != MAP_INVALID_POINT
        _map[desat_mask] = (
            _map
            * fog_of_war_desat_values[fog_of_war_mask.astype(np.int64)]
        ).astype(np.uint8)[desat_mask]
    return _map


def static_to_grid(
    realworld_x: float,
    realworld_y: float,
    grid_resolution: Tuple[int, int],
    bounds: Dict[str, Tuple[float, float]],
) -> Tuple[int, int]:
    """World (x, z) -> map (row, col) with PRE-COMPUTED bounds
    (maps.py:83-102 variant of habitat's to_grid that does not need a
    live sim handle)."""
    grid_size = (
        abs(bounds["upper"][2] - bounds["lower"][2]) / grid_resolution[0],
        abs(bounds["upper"][0] - bounds["lower"][0]) / grid_resolution[1],
    )
    grid_x = int((realworld_x - bounds["lower"][2]) / grid_size[0])
    grid_y = int((realworld_y - bounds["lower"][0]) / grid_size[1])
    return grid_x, grid_y


def drawline(
    img: np.ndarray,
    pt1: Sequence[float],
    pt2: Sequence[float],
    color: int,
    thickness: int = 2,
    style: str = "dotted",
    gap: int = 15,
) -> None:
    """Dotted/dashed/filled line (maps.py:105-141)."""
    if cv2 is None:
        return
    pt1 = (int(pt1[0]), int(pt1[1]))
    pt2 = (int(pt2[0]), int(pt2[1]))
    if style == "filled":
        cv2.line(img, pt1, pt2, color, thickness)
        return
    dist = ((pt1[0] - pt2[0]) ** 2 + (pt1[1] - pt2[1]) ** 2) ** 0.5
    pts = []
    for i in np.arange(0, dist, gap):
        r = i / max(dist, 1e-6)
        x = int((pt1[0] * (1 - r) + pt2[0] * r) + 0.5)
        y = int((pt1[1] * (1 - r) + pt2[1] * r) + 0.5)
        pts.append((x, y))
    if style == "dotted":
        for p in pts:
            cv2.circle(img, p, thickness, color, -1)
    else:  # dashed
        for i in range(0, len(pts) - 1, 2):
            cv2.line(img, pts[i], pts[i + 1], color, thickness)


def drawpoint(
    img: np.ndarray, position: Sequence[int], color: int, pad: int = 2
) -> None:
    """Filled square marker (maps.py: drawpoint)."""
    upper = (int(position[1]) - pad, int(position[0]) - pad)
    lower = (int(position[1]) + pad, int(position[0]) + pad)
    if cv2 is not None:
        cv2.rectangle(img, upper, lower, color, -1)


def draw_triangle(
    img: np.ndarray,
    centroid: Sequence[int],
    theta: float,
    color: int,
    radius: int = 6,
) -> None:
    """Oriented agent sprite (maps.py: draw_triangle). ``theta`` is the
    agent heading."""
    if cv2 is None:
        return
    row, col = int(centroid[0]), int(centroid[1])
    p1 = (
        col + int(radius * np.sin(theta)),
        row + int(radius * np.cos(theta)),
    )
    p2 = (
        col + int(radius * np.sin(theta + 2.0 * np.pi / 3)),
        row + int(radius * np.cos(theta + 2.0 * np.pi / 3)),
    )
    p3 = (
        col + int(radius * np.sin(theta - 2.0 * np.pi / 3)),
        row + int(radius * np.cos(theta - 2.0 * np.pi / 3)),
    )
    cv2.drawContours(
        img, [np.array([p1, p2, p3], np.int32)], 0, color, -1
    )


def draw_path(
    top_down_map: np.ndarray,
    path_points: Sequence[Tuple[int, int]],
    color: int = MAP_SHORTEST_PATH_WAYPOINT,
    thickness: int = 2,
    style: str = "dotted",
) -> None:
    """Poly-line through grid points (maps.py reference/shortest paths)."""
    for prev, nxt in zip(path_points[:-1], path_points[1:]):
        drawline(
            top_down_map,
            (prev[1], prev[0]),
            (nxt[1], nxt[0]),
            color,
            thickness=thickness,
            style=style,
        )


def draw_source_and_target(
    top_down_map: np.ndarray,
    source_grid: Tuple[int, int],
    target_grid: Tuple[int, int],
) -> None:
    drawpoint(top_down_map, source_grid, MAP_SOURCE_POINT_INDICATOR, 4)
    drawpoint(top_down_map, target_grid, MAP_TARGET_POINT_INDICATOR, 4)


# -----------------------------------------------------------------------------
# MP3D connectivity graph (maps.py:277-343)
# -----------------------------------------------------------------------------
def load_connectivity_graph(
    connectivity_dir: str, scene_id: str
):
    """Load an MP3D connectivity graph as a networkx graph (nodes hold
    world positions). Returns None when the file is absent (the fake
    backend ships no graphs)."""
    path = os.path.join(connectivity_dir, f"{scene_id}_connectivity.json")
    if not os.path.exists(path):
        return None
    import networkx as nx

    with open(path) as f:
        data = json.load(f)
    graph = nx.Graph()
    for i, item in enumerate(data):
        if not item.get("included", True):
            continue
        pos = np.array(
            [item["pose"][3], item["pose"][7], item["pose"][11]], np.float32
        )
        graph.add_node(item["image_id"], position=pos)
        for j, connected in enumerate(item.get("unobstructed", [])):
            if connected and j < len(data) and data[j].get("included", True):
                graph.add_edge(item["image_id"], data[j]["image_id"])
    return graph


def reveal_fog_of_war(
    top_down_map: np.ndarray,
    fog_of_war_mask: np.ndarray,
    current_point: Sequence[int],
    current_angle: float,
    fov: float = 90.0,
    max_line_len: float = 100.0,
) -> np.ndarray:
    """FOV-shaped fog-of-war reveal (habitat's fog_of_war.reveal_fog_of_war
    semantics, consumed by the reference measure, measures.py:294-305,
    423-434): cast rays across the [angle - fov/2, angle + fov/2] cone
    from the agent cell; each ray reveals cells until it leaves the map,
    exceeds ``max_line_len``, or passes a non-navigable cell.

    ``current_point`` is (row, col); ``current_angle`` is the polar angle
    where the ray direction is (cos a, sin a) in (row, col) space.
    Vectorized over rays x steps instead of habitat's numba loop.
    """
    h, w = top_down_map.shape[:2]
    half = np.radians(fov) / 2.0
    # enough rays that adjacent rays are < 1 cell apart at max range
    n_rays = max(8, int(np.ceil(2 * half * max_line_len)) * 2)
    angles = current_angle + np.linspace(-half, half, n_rays)
    steps = np.arange(0.0, float(max_line_len), 0.5)
    rr = current_point[0] + np.cos(angles)[:, None] * steps[None, :]
    cc = current_point[1] + np.sin(angles)[:, None] * steps[None, :]
    ri = np.clip(np.round(rr).astype(np.int64), 0, h - 1)
    ci = np.clip(np.round(cc).astype(np.int64), 0, w - 1)
    in_bounds = (
        (rr >= -0.5) & (rr < h - 0.5) & (cc >= -0.5) & (cc < w - 0.5)
    )
    navigable = top_down_map[ri, ci] != MAP_INVALID_POINT
    # a ray survives while every previous cell (inclusive) was navigable
    # and in bounds; the first blocked cell is still revealed (habitat
    # reveals the obstacle cell the ray terminates on)
    ok = in_bounds & navigable
    alive = np.cumprod(ok.astype(np.uint8), axis=1).astype(bool)
    reveal = alive.copy()
    reveal[:, 1:] |= alive[:, :-1] & in_bounds[:, 1:]  # terminal cell
    fog_of_war_mask[ri[reveal], ci[reveal]] = 1
    return fog_of_war_mask


def draw_mp3d_nodes(
    img: np.ndarray,
    graph,
    start_position: Sequence[float],
    world_to_grid,
    meters_per_px: float,
) -> None:
    """Paint MP3D connectivity nodes near the episode's floor
    (reference maps.py:321-343: nodes within 1 m of the start node's
    height, only over valid map cells)."""
    n = get_nearest_node(
        graph, np.array([start_position[0], start_position[2]])
    )
    starting_height = graph.nodes[n]["position"][1]
    pad = max(1, int(0.3 / max(meters_per_px, 1e-6)))
    for node in graph:
        pos = graph.nodes[node]["position"]
        if abs(pos[1] - starting_height) < 1.0:
            r, c = world_to_grid(pos[0], pos[2])
            if 0 <= r < img.shape[0] and 0 <= c < img.shape[1] and img[r, c]:
                drawpoint(img, (r, c), MAP_MP3D_WAYPOINT, pad)


def get_nearest_node(graph, current_position: np.ndarray) -> str:
    """Euclidean-nearest graph node (maps.py:321-330)."""
    nearest = None
    dist = float("inf")
    for node in graph:
        node_pos = graph.nodes[node]["position"]
        node_pos = np.take(node_pos, (0, 2))
        cur_dist = np.linalg.norm(
            np.array(node_pos) - np.array(current_position), ord=2
        )
        if cur_dist < dist:
            dist = cur_dist
            nearest = node
    return nearest


def update_nearest_node(
    graph, nearest_node: str, current_position: np.ndarray
) -> str:
    """Local update over the neighborhood of the previous nearest node
    (maps.py:333-343)."""
    nearest = nearest_node
    dist = np.linalg.norm(
        np.take(graph.nodes[nearest_node]["position"], (0, 2))
        - current_position,
        ord=2,
    )
    for node in graph.neighbors(nearest_node):
        node_pos = np.take(graph.nodes[node]["position"], (0, 2))
        cur_dist = np.linalg.norm(node_pos - current_position, ord=2)
        if cur_dist < dist:
            dist = cur_dist
            nearest = node
    return nearest
