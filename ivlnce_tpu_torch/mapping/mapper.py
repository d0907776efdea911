"""Semantic mapping module: the PyTorch counterpart of
``ivlnce_tpu/mapping/mapper.py``.

Per step and lane: unproject the depth frame to world points, keep the
highest point per half-resolution world cell in a bounded world grid
(``ops.scatter.accumulate``), then rasterize the egocentric occupancy and
semantic maps around the robot (``ops.scatter.rasterize``). In known-map
mode a scene's point cloud is loaded into the grid once
(``load_points_into_state``, ``ops.scatter.known_load``) and steps only
rasterize.

State layout. The JAX package keeps a sorted compact list of recent cells
and flushes it into its dense grid now and then, because scatters
serialize on a TPU. Here the state is only the dense grid, updated by
atomics, one int64 word ``height key << 32 | low`` and one int32 payload
per cell. The maps are the same, because every rule the list and flush
follow is a rule of the dense grid as well:

- a stored point wins an equal key (list merge, flush and raster dedup
  all keep the incumbent), and within a frame the lowest pixel wins;
- a cell's highest point is resolved before the map height filter;
- raster ties go to the lowest grid cell id, which is row-major window
  order;
- the window covers every cell that can land on the map, for the default
  192-cell window and 6.4 m map.

``dropped`` (points that fell outside the grid) is cumulative and is not
cleared by a lane reset. Per-lane scalars (pose, angles, origin) live on
the host: they come from the simulator there, and the trigonometry must
be the C library's float32 ``cosf``/``sinf`` (see ``ops/geometry.py``).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ivlnce_tpu_torch.mapping.camera import CameraParameters
from ivlnce_tpu_torch.ops import geometry as G
from ivlnce_tpu_torch.ops import scatter as S
from ivlnce_tpu_torch.utils import upload as U

# reference filter constants
FRAME_DEPTH_MIN = 0.01  # normalized (mapper.py:417)
FRAME_DEPTH_MAX = 0.99
FRAME_HEIGHT_BELOW = 1.0  # keep h in (rob-1.0, rob+0.5) (mapper.py:420-424)
FRAME_HEIGHT_ABOVE = 0.5
MAP_HEIGHT_BELOW = 1.25  # keep h in (rob-1.25, rob+0.75) (mapper.py:884-901)
MAP_HEIGHT_ABOVE = 0.75
DEPTH_SCALE_METERS = 10.0  # (mapper.py:381-384)

_F32 = np.float32


class MapperParams(NamedTuple):
    """Static mapper geometry."""

    camera: CameraParameters
    map_height_meters: float
    map_width_meters: float
    resolution_meters: float
    grid_cells: int = 1024  # world grid side, in half-resolution cells
    window_cells: int = 192  # raster window side (>= map diagonal + slack)

    @property
    def half_res(self) -> float:
        # voxel dedup runs at half the map resolution (mapper.py:464)
        return self.resolution_meters / 2

    @property
    def map_dims(self) -> G.MapDims:
        return G.MapDims(
            self.map_height_meters,
            self.map_width_meters,
            self.resolution_meters,
        )

    def validate(self) -> None:
        if not 0 < self.window_cells <= self.grid_cells:
            raise ValueError(
                f"MapperParams: window_cells ({self.window_cells}) must lie "
                f"in (0, grid_cells={self.grid_cells}]"
            )
        if self.window_cells ** 2 > S.MAX_WINDOW_CELLS:
            raise ValueError(
                f"MapperParams: window_cells ({self.window_cells}) squared "
                f"exceeds {S.MAX_WINDOW_CELLS}"
            )


@dataclass
class MapperState:
    """Per-lane world map. ``word`` and ``aux`` are updated in place."""

    word: torch.Tensor  # (B, G, G) int64: sortable height key << 32 | low
    aux: torch.Tensor  # (B, G, G) int32: packed [qx | qz | sem]
    origin: np.ndarray  # (B, 2) int32 world half-res cell of grid [0, 0]
    origin_set: np.ndarray  # (B,) bool
    dropped: torch.Tensor  # (B,) int32 cumulative out-of-grid point count

    @property
    def batch_size(self) -> int:
        return self.word.shape[0]

    def key(self) -> torch.Tensor:
        """(B, G, G) int32 height keys; EMPTY_KEY marks an empty cell."""
        return (self.word >> 32).to(torch.int32)


def init_state(
    batch_size: int, grid_cells: int, device="cpu"
) -> MapperState:
    g = grid_cells
    return MapperState(
        word=torch.full(
            (batch_size, g, g), S.EMPTY_WORD, dtype=torch.int64, device=device
        ),
        aux=torch.zeros((batch_size, g, g), dtype=torch.int32, device=device),
        origin=np.zeros((batch_size, 2), np.int32),
        origin_set=np.zeros((batch_size,), bool),
        dropped=torch.zeros((batch_size,), dtype=torch.int32, device=device),
    )


@functools.lru_cache(maxsize=16)
def _rays(w: int, h: int, vfov: float,
          device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pixel rays (W,) and (H,) of a frame on ``device``, depth scale
    folded in: uploaded at a shape's first step, then read, never
    written, by every step."""
    rays_x, rays_y = G.pixel_ray_scaling(w, h, vfov, DEPTH_SCALE_METERS)
    with torch.inference_mode(False):
        got = U.blocking({"x": rays_x[0].numpy(),
                          "y": rays_y[:, 0].contiguous().numpy()}, device)
    return got["x"], got["y"]


def clear_lanes(state: MapperState, keep_mask,
                upload: Optional[U.Upload] = None) -> MapperState:
    """Reset lanes where keep_mask == 0, in place (the reference's
    clear_completed_episode_data, mapper.py:310-326). Only those lanes'
    grids are written; their indices go through ``upload`` (blocking by
    default). ``dropped`` is telemetry and stays."""
    keep = np.asarray(keep_mask).reshape(-1).astype(bool)
    lanes = np.nonzero(~keep)[0]
    if len(lanes):
        upload = upload or U.blocking_to(state.word.device)
        idx = upload({"lanes": lanes})["lanes"]
        # the fill values as launch arguments (an indexed assignment would
        # copy each from the host and wait for the stream)
        state.word.index_fill_(0, idx, S.EMPTY_WORD)
        state.aux.index_fill_(0, idx, 0)
        state.origin[lanes] = 0
        state.origin_set[lanes] = False
    return state


def _world_cells(x_m, z_m, half_res: float) -> Tuple[np.ndarray, np.ndarray]:
    """Absolute world half-res cells of host coordinates: rows keyed by z,
    cols by x."""
    inv = _F32(G.f32_reciprocal(half_res))
    r = np.round(np.asarray(z_m, _F32) * inv).astype(np.int32)
    c = np.round(np.asarray(x_m, _F32) * inv).astype(np.int32)
    return r, c


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, _F32)


class StepInputs(NamedTuple):
    """Per-step device inputs of the accumulate and rasterize ops."""

    depth: torch.Tensor  # (B, H, W) float32
    semantics: Optional[torch.Tensor]  # (B, H, W) uint8; None: no accumulate
    lane_acc: torch.Tensor  # (B, ACC_LANE_COLS) float32
    origin: torch.Tensor  # (B, 2) int32
    rays_x: torch.Tensor  # (W,) float32, depth scale folded in
    rays_y: torch.Tensor  # (H,) float32
    start: torch.Tensor  # (B, 2) int32 raster window corner
    lane_ras: torch.Tensor  # (B, RAS_LANE_COLS) float32


def _grid_origins(center_x, center_z, params: MapperParams) -> np.ndarray:
    """(B, 2) grid origin cells centring the grid on world (x, z)."""
    r, c = _world_cells(center_x, center_z, params.half_res)
    half = params.grid_cells // 2
    return np.stack([r - half, c - half], -1).astype(np.int32)


def step_inputs(
    params: MapperParams,
    state: MapperState,
    depth: torch.Tensor,
    semantics: Optional[torch.Tensor],
    pose,
    elevation,
    heading,
    not_done_masks,
    scene_center=None,
    upload: Optional[U.Upload] = None,
) -> StepInputs:
    """Host half of a step: clear finished lanes, set new lanes' origins
    (both in place) and build the ops' per-lane inputs, sent in one
    ``upload`` call (blocking copies by default). New origins centre the
    grid on ``scene_center`` (B, 2) world (x, z) when given, else on the
    robot; the raster window always centres on the robot. The pixel rays
    stay on the device once per (width, height, field of view)."""
    params.validate()
    if depth.dim() == 4:
        depth = depth[..., 0]
    if semantics is not None and semantics.dim() == 4:
        semantics = semantics[..., 0]
    pose = _host(pose)
    elevation = _host(elevation)
    if heading is None:
        elevation, heading = elevation[:, 0], elevation[:, 1]
    heading = _host(heading)
    device = depth.device
    upload = upload or U.blocking_to(device)
    b, h, w = depth.shape
    g = params.grid_cells
    half = params.half_res
    clear_lanes(state, _host(not_done_masks) != 0, upload)

    # a lane's grid is centred on its scene or its robot at the first step
    # after reset
    r0, c0 = _world_cells(pose[:, 0], pose[:, 2], half)
    center = pose[:, [0, 2]] if scene_center is None else _host(scene_center)
    new_origin = _grid_origins(center[:, 0], center[:, 1], params)
    state.origin = np.where(
        state.origin_set[:, None], state.origin, new_origin
    ).astype(np.int32)
    state.origin_set = np.ones((b,), bool)

    # camera matrix with the reference's elevation + pi (mapper.py:350),
    # then the frame-time height window
    T = G.transform3d(
        torch.from_numpy(pose), elevation + _F32(np.pi), heading
    )
    lane_acc = np.concatenate(
        [
            T[:, :3, :3].reshape(b, 9).numpy(),
            pose,
            (pose[:, 1] + _F32(-FRAME_HEIGHT_BELOW))[:, None],
            (pose[:, 1] + _F32(FRAME_HEIGHT_ABOVE))[:, None],
        ],
        1,
    ).astype(_F32)

    # the raster window around the robot, clamped into the grid
    wc = params.window_cells
    start = np.stack(
        [
            np.clip(r0 - state.origin[:, 0] - wc // 2, 0, g - wc),
            np.clip(c0 - state.origin[:, 1] - wc // 2, 0, g - wc),
        ],
        -1,
    ).astype(np.int32)
    lane_ras = np.stack(
        [
            pose[:, 0],
            pose[:, 1],
            pose[:, 2],
            G.cos32(-heading),
            G.sin32(-heading),
            pose[:, 1] + _F32(-MAP_HEIGHT_BELOW),
            pose[:, 1] + _F32(MAP_HEIGHT_ABOVE),
        ],
        1,
    ).astype(_F32)

    got = upload({"lane_acc": lane_acc, "origin": state.origin,
                  "start": start, "lane_ras": lane_ras})
    rays_x, rays_y = _rays(w, h, params.camera.vertical_fov_radians, device)
    return StepInputs(
        depth=depth.float().contiguous(),
        semantics=(None if semantics is None
                   else semantics.to(torch.uint8).contiguous()),
        lane_acc=got["lane_acc"],
        origin=got["origin"],
        rays_x=rays_x,
        rays_y=rays_y,
        start=got["start"],
        lane_ras=got["lane_ras"],
    )


def mapper_step(
    params: MapperParams,
    state: MapperState,
    depth: torch.Tensor,  # (B, H, W) or (B, H, W, 1) normalized [0, 1]
    semantics: Optional[torch.Tensor],  # (B, H, W) uint8 labels
    pose,  # (B, 3) host array: world camera position
    elevation,  # (B,) host array, or (B, 2) orientation [elev, heading]
    heading: Optional[np.ndarray],  # (B,), or None with (B, 2) above
    not_done_masks,  # (B,) host array: 0 clears the lane's world state
    update_world: bool = True,
    scene_center=None,  # (B, 2) host array: world (x, z)
    upload: Optional[U.Upload] = None,  # the per-lane inputs' copy
) -> Tuple[MapperState, torch.Tensor, torch.Tensor]:
    """One mapping step on ``depth``'s device: returns (state,
    occupancy_map, semantic_map), maps (B, rows, cols) uint8. ``state`` is
    updated in place.

    ``update_world=False`` skips the frame accumulation (known-map mode,
    where the grid was preloaded by ``load_points_into_state``);
    ``semantics`` may then be None. ``scene_center`` centres new lanes'
    grids on their scene instead of the robot (``step_inputs``)."""
    inp = step_inputs(params, state, depth, semantics, pose, elevation,
                      heading, not_done_masks, scene_center, upload)
    if update_world:
        S.accumulate(
            state.word, state.aux, state.dropped, inp.depth, inp.semantics,
            inp.lane_acc, inp.origin, inp.rays_x, inp.rays_y,
            FRAME_DEPTH_MIN, FRAME_DEPTH_MAX, DEPTH_SCALE_METERS,
            params.half_res,
        )
    occ, sem = S.rasterize(
        state.word, state.aux, inp.start, inp.origin, inp.lane_ras,
        params.window_cells, params.map_dims, params.half_res,
    )
    return state, occ, sem


def prepare_load(
    params: MapperParams,
    state: MapperState,
    lanes,  # (L,) host ints: state rows to load, distinct
    center_xz,  # (L, 2) host array: world (x, z) each grid centres on
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Host half of a known-map load, in place: centre the grids of rows
    ``lanes`` on ``center_xz``. K3 overwrites those rows whole, their clear
    included, so nothing here touches the grid. Returns K3's ``rows`` (L,)
    and ``origin`` (L, 2) int32 on the state's device."""
    lanes = np.asarray(lanes, np.int64).reshape(-1)
    if len(np.unique(lanes)) != len(lanes):
        raise ValueError(f"prepare_load: lanes {lanes.tolist()} repeat a row")
    center = _host(center_xz)
    origin = _grid_origins(center[:, 0], center[:, 1], params)
    state.origin[lanes] = origin
    state.origin_set[lanes] = True
    got = U.blocking({"rows": lanes.astype(np.int32), "origin": origin},
                     state.word.device)
    return got["rows"], got["origin"]


def load_lanes(
    params: MapperParams,
    state: MapperState,
    lanes,  # (L,) host ints: state rows to load, distinct
    xyz: torch.Tensor,  # (L, N, 3) float32 world points, on the state's device
    sem: torch.Tensor,  # (L, N) uint8
    counts: torch.Tensor,  # (L,) int32 points per cloud
    center_xz,  # (L, 2) host array: world (x, z) each grid centres on
) -> MapperState:
    """Preload known point clouds into state rows ``lanes``, in place:
    ``prepare_load``, then K3 (``ops.scatter.known_load``), which clears
    the rows as it loads them (``dropped`` stays)."""
    if not len(np.asarray(lanes).reshape(-1)):
        return state
    rows, origin = prepare_load(params, state, lanes, center_xz)
    S.known_load(state.word, state.aux, state.dropped, rows, origin, xyz,
                 sem, counts, params.half_res)
    return state


def load_points_into_state(
    params: MapperParams,
    state: MapperState,
    lane_mask,  # (B,) host bool: lanes to load into
    xyz: torch.Tensor,  # (B, N, 3) padded point clouds (world frame)
    sem: torch.Tensor,  # (B, N) uint8
    num_points,  # (B,) host ints: actual point counts
    origin_pose,  # (B, 3) host array: pose used to centre the grid
    scene_center=None,  # (B, 2) host array: world (x, z)
) -> MapperState:
    """The JAX package's ``load_points_into_state`` (known-map mode,
    reference mapper.py:851-881): load lanes where ``lane_mask``, their
    grids centred on ``scene_center`` when given, else on
    ``origin_pose``. Updates ``state`` in place and returns it."""
    lanes = np.nonzero(np.asarray(lane_mask).reshape(-1).astype(bool))[0]
    if scene_center is None:
        center = _host(origin_pose)[:, [0, 2]]
    else:
        center = _host(scene_center)
    dev = state.word.device
    idx = torch.from_numpy(lanes).to(xyz.device)
    counts = np.asarray(num_points, np.int32).reshape(-1)[lanes]
    return load_lanes(
        params, state, lanes,
        xyz.index_select(0, idx).to(dev, torch.float32).contiguous(),
        sem.index_select(0, idx).to(dev, torch.uint8).contiguous(),
        torch.from_numpy(counts).to(dev), center[lanes],
    )
