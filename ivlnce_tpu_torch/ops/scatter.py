"""Packed-key helpers and the mapper's three device ops: the PyTorch
counterpart of what ``mapping/mapper.py`` needs from
``ivlnce_tpu/ops/scatter.py``.

Keys are exact order-preserving int32 images of float32 heights
(``sortable_from_float``); a cell's payload packs the point's world
(x, z) as 14-bit offsets from its half-resolution cell centre plus a
4-bit label (``pack_aux``). Arithmetic follows the JAX reference as XLA
compiles it inside ``mapper_step`` (see ``ops/geometry.py``): divisions
by constants are reciprocal multiplications and a multiply feeding an add
is one fused multiply-add.

The ops, ``accumulate`` (K1), ``rasterize`` (K2) and ``known_load``
(K3), each have a plain PyTorch version here and a CUDA kernel in
``csrc/mapper_kernels.cu``. The wrapper picks by the tensors' device: CPU
tensors run the plain version, CUDA tensors the kernel (there is no
other path).

K4, the JAX package's older scatter-argmax forms (``segment_argmax``,
``keep_highest_dedup``, ``scatter_argmax_grid_update``,
``rasterize_argmax``), lies on no eval or training path: here it has its
plain versions only, which take CPU tensors and raise on any other.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ivlnce_tpu_torch.ops import geometry as G
from ivlnce_tpu_torch.ops.geometry import fma32

# Empty-cell key: below sortable(-inf).
EMPTY_KEY = -(2 ** 31)
# Low word of an incumbent grid cell: beats every new point's low word
# (0xFFFFFFFE - pixel index), so a stored point wins equal keys.
INCUMBENT_LOW = 0xFFFFFFFF
EMPTY_WORD = (EMPTY_KEY << 32) | INCUMBENT_LOW

# aux packing layout: | qx : 14 | qz : 14 | sem : 4 |
_Q_BITS = 14
_Q_MAX = (1 << _Q_BITS) - 1

# rasterize candidate word: | nonfloor : 1 | key ^ 2^31 : 32 |
# (2^20 - 1 - window index) : 20 | label : 4 |
_RASTER_IDX_BITS = 20
MAX_WINDOW_CELLS = 1 << _RASTER_IDX_BITS


def sortable_from_float(x: torch.Tensor) -> torch.Tensor:
    """EXACT monotone f32 -> int32 key: integer order equals float order,
    -inf included."""
    s = x.float().contiguous().view(torch.int32)
    return torch.where(s >= 0, s, s ^ 0x7FFFFFFF)


def float_from_sortable(k: torch.Tensor) -> torch.Tensor:
    s = torch.where(k >= 0, k, k ^ 0x7FFFFFFF)
    return s.contiguous().view(torch.float32)


def pack_aux(
    x: torch.Tensor,
    z: torch.Tensor,
    sem: torch.Tensor,
    cell_r: torch.Tensor,
    cell_c: torch.Tensor,
    half_res: float,
) -> torch.Tensor:
    """Pack a point's world (x, z) and label into one int32 holding the
    reference's uint32 bits: ``qx << 18 | qz << 4 | sem``, where
    ``q = round((d / half_res + 0.5) * 16383)`` clipped to [0, 16383] and
    d is the offset from the cell centre."""
    inv = G.f32_reciprocal(half_res)

    def quant(v, cell):
        d = v - cell.float() * half_res
        u = fma32(d, torch.full_like(v, inv), torch.full_like(v, 0.5))
        return torch.clamp(torch.round(u * float(_Q_MAX)), 0, _Q_MAX).to(
            torch.int32
        )

    return (
        (quant(x, cell_c) << (4 + _Q_BITS))
        | (quant(z, cell_r) << 4)
        | (sem.to(torch.int32) & 0xF)
    )


def unpack_aux(
    aux: torch.Tensor,
    cell_r: torch.Tensor,
    cell_c: torch.Tensor,
    half_res: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Inverse of pack_aux -> (x, z, sem uint8). int32 shifts are
    arithmetic, so every field is masked after its shift."""
    rq = G.f32_reciprocal(_Q_MAX)

    def coord(q, cell):
        # (q / 16383 - 0.5) * h + cell * h, as two FMAs
        t = fma32(q.float(), torch.full_like(q, rq, dtype=torch.float32),
                  torch.full_like(q, -0.5, dtype=torch.float32))
        return fma32(t, torch.full_like(t, half_res), cell.float() * half_res)

    qx = (aux >> (4 + _Q_BITS)) & _Q_MAX
    qz = (aux >> 4) & _Q_MAX
    sem = (aux & 0xF).to(torch.uint8)
    return coord(qx, cell_c), coord(qz, cell_r), sem


# -----------------------------------------------------------------------------
# K1 accumulate: plain version
# -----------------------------------------------------------------------------
# lane_acc columns: R (row-major 3x3), t (3), height window lo, hi
ACC_LANE_COLS = 14
# lane_ras columns: pose (3), cos(-heading), sin(-heading), height lo, hi
RAS_LANE_COLS = 7


def world_points(
    depth: torch.Tensor, lane_acc: torch.Tensor, rays_x: torch.Tensor,
    rays_y: torch.Tensor, depth_scale: float,
) -> torch.Tensor:
    """(B, H, W) normalized depth -> (B, H*W, 3) world points, with the
    depth scale folded into the rays (``geometry.depth_to_world_points``)."""
    b, h, w = depth.shape
    cam = torch.stack(
        [
            depth * rays_x[None, None, :],
            depth * rays_y[None, :, None],
            depth * depth_scale,
        ],
        -1,
    ).reshape(b, h * w, 3)
    rot = lane_acc[:, :9].reshape(b, 3, 3)
    return G.apply_matrix3(rot, cam) + lane_acc[:, None, 9:12]


def accumulate_plain(
    word: torch.Tensor,
    aux: torch.Tensor,
    dropped: torch.Tensor,
    depth: torch.Tensor,
    semantics: torch.Tensor,
    lane_acc: torch.Tensor,
    origin: torch.Tensor,
    rays_x: torch.Tensor,
    rays_y: torch.Tensor,
    depth_min: float,
    depth_max: float,
    depth_scale: float,
    half_res: float,
) -> None:
    """Merge one depth frame per lane into the dense world grid, in place.

    Per pixel: world point, depth window (depth_min, depth_max), height
    window (lane lo, hi), half-resolution cell ``round(z / h), round(x /
    h)`` relative to the lane origin. Points outside the grid add to
    ``dropped``. Per cell the highest point wins: a 64-bit max over
    ``key << 32 | low``, where a stored point's low word is 0xFFFFFFFF and
    a new point's is 0xFFFFFFFE - pixel index, so stored points win equal
    keys and the lowest pixel wins among new ones. Winners then write
    their payload and become stored points."""
    b, h, w = depth.shape
    g = word.shape[1]
    n = h * w
    pts = world_points(depth, lane_acc, rays_x, rays_y, depth_scale)
    d = depth.reshape(b, n)
    hy = pts[:, :, 1]
    valid = (
        (d > depth_min) & (d < depth_max)
        & (hy > lane_acc[:, 12:13]) & (hy < lane_acc[:, 13:14])
    )
    inv = G.f32_reciprocal(half_res)
    r_abs = torch.round(pts[:, :, 2] * inv).to(torch.int32)
    c_abs = torch.round(pts[:, :, 0] * inv).to(torch.int32)
    r = r_abs - origin[:, 0:1]
    c = c_abs - origin[:, 1:2]
    inside = (r >= 0) & (r < g) & (c >= 0) & (c < g)
    dropped += (valid & ~inside).sum(1, dtype=torch.int32)
    valid &= inside

    payload = pack_aux(
        pts[:, :, 0], pts[:, :, 2], semantics.reshape(b, n), r_abs, c_abs,
        half_res,
    )
    lane = torch.arange(b, device=depth.device, dtype=torch.int64)
    _argmax_merge(word, aux, lane, r, c, hy, payload, valid)


def _argmax_merge(word, aux, rows, r, c, height, payload, valid) -> None:
    """The argmax-by-height merge K1 and K3 share, in place: point j of
    ``rows[i]`` goes to grid cell (r, c) when ``valid``. Per cell a 64-bit
    max over ``key << 32 | (0xFFFFFFFE - j)`` against the stored word
    (low word 0xFFFFFFFF), then the winners write their payload and become
    stored points."""
    g = word.shape[1]
    key = sortable_from_float(height)
    idx = torch.arange(key.shape[1], device=key.device, dtype=torch.int64)
    new_word = (key.to(torch.int64) << 32) | (0xFFFFFFFE - idx)[None, :]
    cell = (rows[:, None] * g * g + r.to(torch.int64) * g
            + c.to(torch.int64))[valid]
    new_word = new_word[valid]
    flat_word = word.view(-1)
    flat_word.scatter_reduce_(0, cell, new_word, "amax")
    win = flat_word[cell] == new_word
    cell = cell[win]
    aux.view(-1)[cell] = payload[valid][win]
    flat_word[cell] = (key[valid][win].to(torch.int64) << 32) | INCUMBENT_LOW


# -----------------------------------------------------------------------------
# K3 known-map load: plain version
# -----------------------------------------------------------------------------
def known_load_plain(
    word: torch.Tensor,
    aux: torch.Tensor,
    dropped: torch.Tensor,
    rows: torch.Tensor,
    origin: torch.Tensor,
    xyz: torch.Tensor,
    sem: torch.Tensor,
    counts: torch.Tensor,
    half_res: float,
) -> None:
    """Overwrite grid rows ``rows`` (distinct) with one known point cloud
    each, in place (the JAX package's ``load_points_into_state``: its
    ``clear_lanes``, then ``sorted_argmax_grid_update``).

    Each row is first cleared (word ``EMPTY_WORD``, payload 0). Point j of
    cloud i counts when j < counts[i]. Its half-resolution cell is
    ``round(z / h), round(x / h)`` less the row's ``origin[i]``; points
    off the grid add to ``dropped[rows[i]]``. A point takes its cell only
    with a word above the empty one, so a height whose key is
    ``EMPTY_KEY`` leaves the cell empty, and among equal keys the lowest j
    wins (``_argmax_merge``). Other rows are untouched."""
    n = xyz.shape[1]
    g = word.shape[1]
    rows = rows.to(torch.int64)
    if torch.unique(rows).numel() != rows.numel():
        raise ValueError(f"known_load: rows {rows.tolist()} repeat a row")
    word[rows] = EMPTY_WORD
    aux[rows] = 0
    j = torch.arange(n, device=xyz.device)
    valid = j[None, :] < counts[:, None]
    inv = G.f32_reciprocal(half_res)
    r_abs = torch.round(xyz[:, :, 2] * inv).to(torch.int32)
    c_abs = torch.round(xyz[:, :, 0] * inv).to(torch.int32)
    r = r_abs - origin[:, 0:1]
    c = c_abs - origin[:, 1:2]
    inside = (r >= 0) & (r < g) & (c >= 0) & (c < g)
    dropped.index_add_(0, rows, (valid & ~inside).sum(1, dtype=torch.int32))
    valid &= inside
    payload = pack_aux(xyz[:, :, 0], xyz[:, :, 2], sem, r_abs, c_abs,
                       half_res)
    _argmax_merge(word, aux, rows, r, c, xyz[:, :, 1], payload, valid)


# -----------------------------------------------------------------------------
# K2 rasterize: plain version
# -----------------------------------------------------------------------------
def rasterize_plain(
    word: torch.Tensor,
    aux: torch.Tensor,
    start: torch.Tensor,
    origin: torch.Tensor,
    lane_ras: torch.Tensor,
    window: int,
    dims: G.MapDims,
    half_res: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Egocentric occupancy and semantic maps (B, rows, cols) uint8 from
    the ``window``^2 grid cells starting at ``start`` (B, 2).

    A stored point counts when its height lies in (lo, hi); it is moved by
    -pose, rotated by -heading and rounded to the map. Occupancy = any
    point; semantic = label of the winner of the max over (non-floor,
    height, -window index), or 0 when that winner is floor. The window
    index runs row-major, which is ascending grid cell id."""
    b = word.shape[0]
    dev = word.device
    ar = torch.arange(window, device=dev, dtype=torch.int64)
    rows = start[:, 0:1].to(torch.int64) + ar[None, :]
    cols = start[:, 1:2].to(torch.int64) + ar[None, :]
    lane = torch.arange(b, device=dev)[:, None, None]
    win_word = word[lane, rows[:, :, None], cols[:, None, :]].reshape(b, -1)
    win_aux = aux[lane, rows[:, :, None], cols[:, None, :]].reshape(b, -1)
    key = (win_word >> 32).to(torch.int32)
    valid = key != EMPTY_KEY
    height = float_from_sortable(key)
    r_abs = (rows[:, :, None] + origin[:, 0, None, None]).expand(
        b, window, window).reshape(b, -1).to(torch.int32)
    c_abs = (cols[:, None, :] + origin[:, 1, None, None]).expand(
        b, window, window).reshape(b, -1).to(torch.int32)
    x, z, label = unpack_aux(win_aux, r_abs, c_abs, half_res)
    valid &= (height > lane_ras[:, 5:6]) & (height < lane_ras[:, 6:7])

    shifted = torch.stack([x, height, z], -1) - lane_ras[:, None, 0:3]
    cos, sin = lane_ras[:, 3], lane_ras[:, 4]
    zero, one = torch.zeros_like(cos), torch.ones_like(cos)
    rot = torch.stack(
        [
            torch.stack([cos, zero, sin], -1),
            torch.stack([zero, one, zero], -1),
            torch.stack([-sin, zero, cos], -1),
        ],
        1,
    )
    ego = G.apply_matrix3(rot, shifted)
    map_r, map_c, in_map = G.project_to_map_indices(
        ego[:, :, 2], ego[:, :, 0], dims
    )
    valid &= in_map

    idx = torch.arange(window * window, device=dev, dtype=torch.int64)
    label64 = label.to(torch.int64)
    cand = (
        ((label64 != 0).to(torch.int64) << 56)
        | ((key.to(torch.int64) + 2 ** 31) << 24)
        | ((MAX_WINDOW_CELLS - 1 - idx)[None, :] << 4)
        | label64
    )
    n_cells = dims.num_rows * dims.num_cols
    cell = torch.where(valid, map_r * dims.num_cols + map_c, 0).to(torch.int64)
    best = torch.zeros((b, n_cells), dtype=torch.int64, device=dev)
    best.scatter_reduce_(1, cell, torch.where(valid, cand, 0), "amax")
    occupancy = (best != 0).to(torch.uint8)
    semantic = torch.where((best >> 56) & 1 == 1, best & 0xF, 0).to(
        torch.uint8
    )
    shape = (b, dims.num_rows, dims.num_cols)
    return occupancy.reshape(shape), semantic.reshape(shape)


# -----------------------------------------------------------------------------
# wrappers: CPU tensors -> plain version, CUDA tensors -> kernel
# -----------------------------------------------------------------------------
class LaunchCounter:
    """Kernel launches per op; the plain version never counts."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.accumulate = 0
        self.rasterize = 0
        self.known_load = 0


launches = LaunchCounter()


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_arg(device: torch.device) -> ctypes.c_void_p:
    """``device``'s current stream. The C entry points launch on the
    current device, so each wrapper calls them under
    ``torch.cuda.device(device)``: a tensor on another card than the
    current one would otherwise be read on the wrong card's stream."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _check_accumulate(word, aux, dropped, depth, semantics, lane_acc,
                      origin, rays_x, rays_y) -> None:
    b, h, w = depth.shape
    g = word.shape[1]
    dev = depth.device
    _check(word, "word", torch.int64, (b, g, g), dev)
    _check(aux, "aux", torch.int32, (b, g, g), dev)
    _check(dropped, "dropped", torch.int32, (b,), dev)
    _check(depth, "depth", torch.float32, (b, h, w), dev)
    _check(semantics, "semantics", torch.uint8, (b, h, w), dev)
    _check(lane_acc, "lane_acc", torch.float32, (b, ACC_LANE_COLS), dev)
    _check(origin, "origin", torch.int32, (b, 2), dev)
    _check(rays_x, "rays_x", torch.float32, (w,), dev)
    _check(rays_y, "rays_y", torch.float32, (h,), dev)


def accumulate_args(
    word, aux, dropped, depth, semantics, lane_acc, origin, rays_x, rays_y,
    depth_min: float, depth_max: float, depth_scale: float, half_res: float,
) -> tuple:
    """K1's arguments checked, as the C arguments of a launch in three
    parts: nine pointers; B, H, W, G; five floats. Each entry point takes
    its own arguments between and after them."""
    tensors = (word, aux, dropped, depth, semantics, lane_acc, origin,
               rays_x, rays_y)
    _check_accumulate(*tensors)
    f = ctypes.c_float
    return (
        tuple(_ptr(t) for t in tensors),
        (*depth.shape, word.shape[1]),
        (f(depth_min), f(depth_max), f(depth_scale), f(half_res),
         f(G.f32_reciprocal(half_res))),
    )


def accumulate(
    word, aux, dropped, depth, semantics, lane_acc, origin, rays_x, rays_y,
    depth_min: float, depth_max: float, depth_scale: float, half_res: float,
) -> None:
    """K1: merge one depth frame per lane into the world grid, in place
    (see ``accumulate_plain`` for the semantics)."""
    tensors = (word, aux, dropped, depth, semantics, lane_acc, origin,
               rays_x, rays_y)
    consts = (depth_min, depth_max, depth_scale, half_res)
    dev = depth.device
    if dev.type == "cpu":
        _check_accumulate(*tensors)
        accumulate_plain(*tensors, *consts)
        return
    if dev.type != "cuda":
        raise ValueError(f"accumulate: unsupported device {dev}")
    from ivlnce_tpu_torch.ops import kernels

    pointers, sizes, floats = accumulate_args(*tensors, *consts)
    lib = kernels.library()
    # the candidates' warp ballots between the kernel's two passes
    scratch = torch.empty(lib.mapper_accumulate_scratch_bytes(*sizes[:3]),
                          dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        err = lib.mapper_accumulate(*pointers, _ptr(scratch), *sizes,
                                    *floats, stream_arg(dev))
    launches.accumulate += 1
    kernels.check(err, "mapper_accumulate")


def _check_rasterize(word, aux, start, origin, lane_ras, window: int) -> None:
    b, g = word.shape[0], word.shape[1]
    dev = word.device
    _check(word, "word", torch.int64, (b, g, g), dev)
    _check(aux, "aux", torch.int32, (b, g, g), dev)
    _check(start, "start", torch.int32, (b, 2), dev)
    _check(origin, "origin", torch.int32, (b, 2), dev)
    _check(lane_ras, "lane_ras", torch.float32, (b, RAS_LANE_COLS), dev)
    if not 0 < window <= g or window * window > MAX_WINDOW_CELLS:
        raise ValueError(f"rasterize: window {window} for grid {g}")


def rasterize_args(
    word, aux, start, origin, lane_ras, window: int, dims: G.MapDims,
    half_res: float,
) -> tuple:
    """K2's arguments checked; the two maps to fill (empty, on the grid's
    device) and the C arguments of a launch up to the stream."""
    _check_rasterize(word, aux, start, origin, lane_ras, window)
    b, g = word.shape[0], word.shape[1]
    shape = (b, dims.num_rows, dims.num_cols)
    occupancy = torch.empty(shape, dtype=torch.uint8, device=word.device)
    semantic = torch.empty(shape, dtype=torch.uint8, device=word.device)
    f = ctypes.c_float
    c_args = (
        _ptr(word), _ptr(aux), _ptr(start), _ptr(origin), _ptr(lane_ras),
        _ptr(occupancy), _ptr(semantic),
        b, g, window, dims.num_rows, dims.num_cols,
        f(half_res), f(G.f32_reciprocal(_Q_MAX)),
        f(np.float32(dims.height_meters / 2)),
        f(np.float32(dims.width_meters / 2)),
        f(G.f32_reciprocal(dims.resolution_meters)),
    )
    return occupancy, semantic, c_args


def rasterize(
    word, aux, start, origin, lane_ras, window: int, dims: G.MapDims,
    half_res: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: egocentric occupancy and semantic maps (see ``rasterize_plain``)."""
    dev = word.device
    if dev.type == "cpu":
        _check_rasterize(word, aux, start, origin, lane_ras, window)
        return rasterize_plain(word, aux, start, origin, lane_ras, window,
                               dims, half_res)
    if dev.type != "cuda":
        raise ValueError(f"rasterize: unsupported device {dev}")
    from ivlnce_tpu_torch.ops import kernels

    occupancy, semantic, c_args = rasterize_args(
        word, aux, start, origin, lane_ras, window, dims, half_res)
    with torch.cuda.device(dev):
        err = kernels.library().mapper_rasterize(*c_args, stream_arg(dev))
    launches.rasterize += 1
    kernels.check(err, "mapper_rasterize")
    return occupancy, semantic


def known_load_args(
    word, aux, dropped, rows, origin, xyz, sem, counts, half_res: float,
) -> tuple:
    """K3's arguments checked, as the C arguments of a launch in three
    parts: eight pointers; L, N, G; two floats. Each entry point takes its
    own arguments between and after them."""
    l, n = sem.shape
    b, g = word.shape[0], word.shape[1]
    dev = word.device
    _check(word, "word", torch.int64, (b, g, g), dev)
    _check(aux, "aux", torch.int32, (b, g, g), dev)
    _check(dropped, "dropped", torch.int32, (b,), dev)
    _check(rows, "rows", torch.int32, (l,), dev)
    _check(origin, "origin", torch.int32, (l, 2), dev)
    _check(xyz, "xyz", torch.float32, (l, n, 3), dev)
    _check(sem, "sem", torch.uint8, (l, n), dev)
    _check(counts, "counts", torch.int32, (l,), dev)
    tensors = (word, aux, dropped, rows, origin, xyz, sem, counts)
    f = ctypes.c_float
    return (tuple(_ptr(t) for t in tensors), (l, n, g),
            (f(half_res), f(G.f32_reciprocal(half_res))))


def known_load(
    word, aux, dropped, rows, origin, xyz, sem, counts, half_res: float,
) -> None:
    """K3: overwrite grid rows with known point clouds, in place, the
    rows' clear included (see ``known_load_plain`` for the semantics).
    ``rows``, ``origin`` and ``counts`` are per cloud; ``xyz`` is
    (L, N, 3). The rows must be distinct; on CUDA tensors the kernel takes
    that on trust, as reading ``rows`` would wait on the card."""
    dev = word.device
    if dev.type == "cpu":
        known_load_args(word, aux, dropped, rows, origin, xyz, sem, counts,
                        half_res)
        known_load_plain(word, aux, dropped, rows, origin, xyz, sem, counts,
                         half_res)
        return
    if dev.type != "cuda":
        raise ValueError(f"known_load: unsupported device {dev}")
    from ivlnce_tpu_torch.ops import kernels

    pointers, sizes, floats = known_load_args(
        word, aux, dropped, rows, origin, xyz, sem, counts, half_res)
    lib = kernels.library()
    # each chunk's records sorted by tile, and each tile's run per chunk
    scratch = torch.empty(lib.mapper_known_load_scratch_bytes(*sizes),
                          dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        err = lib.mapper_known_load(*pointers, _ptr(scratch), *sizes,
                                    *floats, stream_arg(dev))
    launches.known_load += 1
    kernels.check(err, "mapper_known_load")


# -----------------------------------------------------------------------------
# K4: the older scatter-argmax forms (ivlnce_tpu/ops/scatter.py:45-205),
# plain versions
# -----------------------------------------------------------------------------
# Each is a scatter-max of the keys, a gather back (a point is a candidate
# iff it is valid and equals its cell's new max), then a scatter-min of
# the candidates' indices, so ties go to the lowest point index. Invalid
# points are parked at index 0 with -inf keys, as in the JAX package;
# valid points must lie on the grid.
class SegmentArgmax(NamedTuple):
    max_values: torch.Tensor  # (num_segments,) max per segment (-inf if empty)
    argmax: torch.Tensor  # (num_segments,) int32 winner index (N if empty)
    winner_mask: torch.Tensor  # (N,) True for the unique winner of its segment


def _k4_cpu(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type != "cpu":
            raise ValueError(
                f"{name}: K4 has no kernel (no ported path calls it); its "
                f"plain version takes CPU tensors, not {t.device} ones"
            )


def _first_winners(flat: torch.Tensor, is_max: torch.Tensor,
                   cells: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(per-cell lowest candidate index (n where none), per-point winner
    mask) for (..., n) points at ``flat`` cells."""
    n = is_max.shape[-1]
    idx = torch.arange(n, dtype=torch.int32).expand_as(is_max)
    first = torch.full((cells,), n, dtype=torch.int32).scatter_reduce(
        0, flat.reshape(-1), torch.where(is_max, idx, n).reshape(-1), "amin")
    winner = is_max & (first[flat] == idx)
    return first, winner


def segment_argmax(values: torch.Tensor, segment_ids: torch.Tensor,
                   num_segments: int, valid: torch.Tensor) -> SegmentArgmax:
    """Per-segment max of the valid (N,) ``values`` and the lowest-index
    argmax; ``segment_ids`` in [0, num_segments)."""
    _k4_cpu("segment_argmax", values, segment_ids, valid)
    ids = torch.where(valid, segment_ids, 0).long()
    vals = torch.where(valid, values, float("-inf"))
    maxes = torch.full((num_segments,), float("-inf"),
                       dtype=values.dtype).scatter_reduce(0, ids, vals, "amax")
    is_max = valid & (vals == maxes[ids])
    argmaxes, winner = _first_winners(ids, is_max, num_segments)
    return SegmentArgmax(maxes, argmaxes, winner)


def keep_highest_dedup(heights: torch.Tensor, cell_ids: torch.Tensor,
                       num_cells: int, valid: torch.Tensor) -> torch.Tensor:
    """The mask of the single highest valid point per voxel cell (the
    reference's KeepHighestSemanticPointcloud, mapper.py:428-474)."""
    return segment_argmax(heights, cell_ids, num_cells, valid).winner_mask


def _grid_cells(rows, cols, valid, shape) -> torch.Tensor:
    """(B, N) flat cell indices into a (B, R, C) grid; invalid points at
    each lane's cell (0, 0)."""
    b, r_n, c_n = shape
    r = torch.where(valid, rows, 0).long()
    c = torch.where(valid, cols, 0).long()
    return (torch.arange(b)[:, None] * r_n + r) * c_n + c


def scatter_argmax_grid_update(
    grid_key: torch.Tensor, grid_payload: torch.Tensor, rows: torch.Tensor,
    cols: torch.Tensor, keys: torch.Tensor, payload: torch.Tensor,
    valid: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """New (B, R, C) keys and (B, R, C, P) payloads: a valid point whose
    key beats its cell's incumbent takes the cell; ties keep the
    incumbent, and ties among new points go to the lowest index."""
    _k4_cpu("scatter_argmax_grid_update", grid_key, grid_payload, rows, cols,
            keys, payload, valid)
    flat = _grid_cells(rows, cols, valid, grid_key.shape)
    k = torch.where(valid, keys, float("-inf"))
    old = grid_key.reshape(-1)
    new_key = old.scatter_reduce(0, flat.reshape(-1), k.reshape(-1), "amax")
    is_max = valid & (k == new_key[flat]) & (k > old[flat])
    _, winner = _first_winners(flat, is_max, old.numel())
    new_payload = grid_payload.reshape(old.numel(), -1).clone()
    new_payload[flat[winner]] = payload[winner].to(new_payload.dtype)
    return (new_key.reshape(grid_key.shape),
            new_payload.reshape(grid_payload.shape))


def rasterize_argmax(
    rows: torch.Tensor, cols: torch.Tensor, keys: torch.Tensor,
    values: torch.Tensor, valid: torch.Tensor, num_rows: int, num_cols: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """A fresh (B, R, C) grid of (B, N) points: occupancy (uint8) is "any
    valid point", the value the highest-key point's (ties to the lowest
    index)."""
    _k4_cpu("rasterize_argmax", rows, cols, keys, values, valid)
    shape = (keys.shape[0], num_rows, num_cols)
    cells = shape[0] * num_rows * num_cols
    flat = _grid_cells(rows, cols, valid, shape)
    occupancy = torch.zeros(cells, dtype=torch.uint8)
    occupancy[flat[valid]] = 1
    k = torch.where(valid, keys, float("-inf"))
    key_grid = torch.full((cells,), float("-inf"), dtype=keys.dtype)
    key_grid = key_grid.scatter_reduce(0, flat.reshape(-1), k.reshape(-1),
                                       "amax")
    _, winner = _first_winners(flat, valid & (k == key_grid[flat]), cells)
    value_map = torch.zeros(cells, dtype=values.dtype)
    value_map[flat[winner]] = values[winner]
    return occupancy.reshape(shape), value_map.reshape(shape)
