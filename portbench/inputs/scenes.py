"""Seeded scenes, walks and frames: the benchmark's own copy of the
procedural simulator's geometry and analytic renderer.

A scene is a 16 m square room with seven labelled boxes. A walk is a
sequence of camera poses in it: a step forward of 0.25 m where the floor
ahead is free, else a turn of 15 degrees. Frames are rendered on the
device in bulk and kept on the host, in the form the simulator hands the
eval loop after its wire encode: depth as uint16 of the depth normalised
over 10 m, labels as uint8, RGB as uint8.

The camera looks along (-sin h, 0, -cos h) for heading h, with its right
at (cos h, 0, -sin h) and image rows going down; depth is the distance
along the optical axis, so a pixel's point is
``pose + depth * (u * right + (-v) * up + forward)``."""

from __future__ import annotations

import math
from typing import Dict, NamedTuple

import numpy as np
import torch

EXTENT = 16.0
N_BOXES = 7
WALL_HEIGHT = 3.0
CAMERA_HEIGHT = 1.25
MAX_DEPTH = 10.0
STEP_METERS = 0.25
TURN_RADIANS = math.radians(15.0)
DEPTH_WIRE_SCALE = 65535.0

PALETTE = np.array(
    [
        [200, 200, 200], [230, 25, 75], [60, 180, 75], [255, 225, 25],
        [0, 130, 200], [245, 130, 48], [145, 30, 180], [70, 240, 240],
        [240, 50, 230], [210, 245, 60], [250, 190, 212], [0, 128, 128],
        [220, 190, 255],
    ],
    np.uint8,
)


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A numpy generator for one stream of a run: any whole ``seed``,
    negative or beyond 64 bits included."""
    return np.random.default_rng([seed % (2 ** 64), *stream])


class Scenes(NamedTuple):
    boxes: np.ndarray  # (L, N_BOXES, 5) x0, z0, x1, z1, label


def make_scenes(seed: int, lanes: int) -> Scenes:
    """One seeded room per lane."""
    rng = rng_for(seed, 1)
    h = EXTENT / 2
    centre = rng.uniform(-h + 2, h - 2, (lanes, N_BOXES, 2))
    size = rng.uniform(0.5, 2.0, (lanes, N_BOXES, 2))
    label = rng.integers(1, 13, (lanes, N_BOXES))
    boxes = np.concatenate(
        [centre - size / 2, centre + size / 2, label[..., None]], -1)
    return Scenes(boxes.astype(np.float64))


def _free(boxes: np.ndarray, x: float, z: float, margin: float = 0.3) -> bool:
    h = EXTENT / 2 - margin
    if not (-h <= x <= h and -h <= z <= h):
        return False
    inside = ((boxes[:, 0] - margin < x) & (x < boxes[:, 2] + margin)
              & (boxes[:, 1] - margin < z) & (z < boxes[:, 3] + margin))
    return not inside.any()


def make_walks(seed: int, scenes: Scenes, frames: int) -> np.ndarray:
    """(frames, L, 3) float64 poses (x, z, heading) of one walk per lane:
    from a free start, forward where the floor ahead is free, else a turn
    in a seeded direction."""
    lanes = scenes.boxes.shape[0]
    rng = rng_for(seed, 2)
    out = np.zeros((frames, lanes, 3))
    for i in range(lanes):
        boxes = scenes.boxes[i]
        while True:
            x, z = rng.uniform(-EXTENT / 2 + 1, EXTENT / 2 - 1, 2)
            if _free(boxes, x, z):
                break
        h = rng.uniform(-math.pi, math.pi)
        turn = 1.0 if rng.random() < 0.5 else -1.0
        for f in range(frames):
            out[f, i] = (x, z, h)
            nx = x - STEP_METERS * math.sin(h)
            nz = z - STEP_METERS * math.cos(h)
            if rng.random() < 0.8 and _free(boxes, nx, nz):
                x, z = nx, nz
            else:
                if rng.random() < 0.2:
                    turn = -turn
                h = math.remainder(h + turn * TURN_RADIANS, 2 * math.pi)
    return out


def _pixel_rays(height: int, width: int, hfov_degrees: float):
    hfov = math.radians(hfov_degrees)
    vfov = hfov * height / width
    fx = width / (2 * math.tan(hfov / 2))
    fy = height / (2 * math.tan(vfov / 2))
    us = (torch.arange(width, dtype=torch.float64) + 0.5 - width / 2) / fx
    vs = (torch.arange(height, dtype=torch.float64) + 0.5 - height / 2) / fy
    return us, vs


def _wall_distance(x, z, dx, dz, boxes):
    """Horizontal distance along unit directions (F, W) from (F, 1)
    positions to the room's walls and the boxes (F, N_BOXES, 5), and the
    label of what is hit (0 for the room's walls)."""
    h = EXTENT / 2
    eps = 1e-9
    inf = torch.full_like(dx, math.inf)
    best = inf.clone()
    label = torch.zeros_like(dx)
    for val, is_x in ((h, True), (-h, True), (h, False), (-h, False)):
        d = dx if is_x else dz
        o = x if is_x else z
        t = torch.where(d.abs() > eps, (val - o) / d, inf)
        other = (z if is_x else x) + t * (dz if is_x else dx)
        hit = (t > eps) & (other.abs() <= h + 1e-6) & (t < best)
        best = torch.where(hit, t, best)
    for k in range(boxes.shape[1]):
        x0, z0, x1, z1, lbl = (boxes[:, k, j:j + 1] for j in range(5))
        for val, is_x, lo, hi in ((x0, True, z0, z1), (x1, True, z0, z1),
                                  (z0, False, x0, x1), (z1, False, x0, x1)):
            d = dx if is_x else dz
            o = x if is_x else z
            t = torch.where(d.abs() > eps, (val - o) / d, inf)
            other = (z if is_x else x) + t * (dz if is_x else dx)
            hit = ((t > eps) & (other >= lo - 1e-6) & (other <= hi + 1e-6)
                   & (t < best))
            best = torch.where(hit, t, best)
            label = torch.where(hit, lbl.expand_as(label), label)
    return best, label


def render(poses: torch.Tensor, boxes: torch.Tensor, height: int,
           width: int, hfov_degrees: float = 90.0):
    """Depth normalised to [0, 1] (F, H, W) float64 and labels (F, H, W)
    uint8 of F frames, on ``poses``' device: ``poses`` (F, 3) x, z,
    heading; ``boxes`` (F, N_BOXES, 5) the room of each."""
    us, vs = (r.to(poses.device) for r in _pixel_rays(height, width,
                                                        hfov_degrees))
    x, z, hd = poses[:, 0:1], poses[:, 1:2], poses[:, 2:3]
    ch, sh = torch.cos(hd), torch.sin(hd)
    dx = -sh + us[None] * ch
    dz = -ch - us[None] * sh
    norm = torch.sqrt(dx * dx + dz * dz)
    t_wall, label = _wall_distance(x, z, dx / norm, dz / norm, boxes)
    d_wall = (t_wall / norm)[:, None, :]  # (F, 1, W) optical depth
    v = vs[None, :, None]  # (1, H, 1)
    inf = torch.tensor(math.inf, dtype=torch.float64, device=poses.device)
    d_floor = torch.where(v > 1e-6, CAMERA_HEIGHT / v, inf)
    d_ceil = torch.where(v < -1e-6, (CAMERA_HEIGHT - WALL_HEIGHT) / v, inf)
    wall_y = CAMERA_HEIGHT - d_wall * v
    d_wall = torch.where((wall_y >= 0) & (wall_y <= WALL_HEIGHT), d_wall, inf)
    plane = torch.minimum(d_floor, d_ceil)
    depth = torch.minimum(plane, d_wall)
    sem = torch.where(d_wall <= plane, label[:, None, :], 0.0)
    depth = depth.clamp(0.0, MAX_DEPTH) / MAX_DEPTH
    return depth, sem.to(torch.uint8)


def depth_wire(depth: torch.Tensor) -> torch.Tensor:
    """Normalised depth as the values of the uint16 the eval loop uploads
    (held in int32)."""
    return (depth.float().clamp(0.0, 1.0) * DEPTH_WIRE_SCALE + 0.5).to(
        torch.int32)


def rgb_of(depth: torch.Tensor, sem: torch.Tensor) -> torch.Tensor:
    """The simulator's colouring: the label's palette colour shaded by
    depth, (F, H, W, 3) uint8."""
    palette = torch.from_numpy(PALETTE).to(depth.device).double()
    shade = 1.0 - 0.7 * depth[..., None]
    return (palette[sem.long() % 13] * shade).to(torch.uint8)


def render_pool(poses: np.ndarray, scenes: Scenes, sensors: Dict,
                device: torch.device, chunk: int = 64
                ) -> Dict[str, np.ndarray]:
    """Host arrays (P, L, ...) of every frame of the walks ``poses`` (P,
    L, 3): ``depth`` uint16 (P, L, H, W, 1), ``semantic12`` uint8 (P, L,
    H, W, 1) and, when ``sensors`` names ``rgb``, ``rgb`` uint8 (P, L, h,
    w, 3), rendered on ``device`` ``chunk`` frames at a time."""
    p, lanes = poses.shape[:2]
    dh, dw = sensors["depth"]
    out = {"depth": np.empty((p, lanes, dh, dw, 1), np.uint16)}
    if "semantic12" in sensors:
        out["semantic12"] = np.empty((p, lanes, dh, dw, 1), np.uint8)
    if "rgb" in sensors:
        rh, rw = sensors["rgb"]
        out["rgb"] = np.empty((p, lanes, rh, rw, 3), np.uint8)
    flat = torch.from_numpy(poses.reshape(-1, 3)).to(device)
    boxes = torch.from_numpy(scenes.boxes).to(device)
    for s in range(0, p * lanes, chunk):
        e = min(s + chunk, p * lanes)
        idx = torch.arange(s, e, device=device)
        fb = boxes[idx % lanes]
        depth, sem = render(flat[s:e], fb, dh, dw)
        rows = np.arange(s, e)
        fi, li = rows // lanes, rows % lanes
        out["depth"][fi, li] = depth_wire(depth)[..., None].cpu().numpy()
        if "semantic12" in out:
            out["semantic12"][fi, li] = sem[..., None].cpu().numpy()
        if "rgb" in out:
            rd, rs = render(flat[s:e], fb, rh, rw)
            out["rgb"][fi, li] = rgb_of(rd, rs).cpu().numpy()
    return out


def camera_pose(poses: np.ndarray) -> Dict[str, np.ndarray]:
    """The pose sensors of walk poses (..., 3): ``world_robot_pose`` (x,
    camera height, z) float32 and ``world_robot_orientation`` (elevation
    0, heading) float32."""
    pose = np.stack([poses[..., 0], np.full(poses.shape[:-1], CAMERA_HEIGHT),
                     poses[..., 1]], -1).astype(np.float32)
    orient = np.stack([np.zeros(poses.shape[:-1]), poses[..., 2]],
                      -1).astype(np.float32)
    return {"world_robot_pose": pose, "world_robot_orientation": orient}
