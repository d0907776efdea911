"""The plain egocentric mapper, frozen with the benchmark: a world grid
per lane that keeps the highest point of each half-resolution cell, and
the egocentric occupancy and semantic maps rasterized from it.

Its arithmetic is that of the JAX package's mapper as XLA compiles it on
the CPU, written out in plain torch: a division by a constant is a
multiplication by its float32 reciprocal, a 3x3 product is three fused
multiply-adds in index order (``fma32``), and the angles go through the C
library's float32 ``cosf`` / ``sinf``. So its maps are exactly those of a
correct mapper, and any cell that differs is a fault.

Per step and lane: world points of the depth frame, filtered to the depth
window (0.01, 0.99) and to heights within (-1.0, +0.5) m of the camera;
each point's half-resolution cell ``round(z / h), round(x / h)`` relative
to the lane's grid origin; per cell the highest point wins, a stored
point keeps an equal height and the lowest pixel wins among new ones.
The raster reads the ``window`` cells around the robot, keeps points
within (-1.25, +0.75) m of the camera, turns them into the robot's frame
and rounds them to the map; occupancy is any point, the label that of the
best point by (not floor, height, lowest cell), 0 when that is floor."""

from __future__ import annotations

import ctypes
import ctypes.util
import math
from typing import Tuple

import numpy as np
import torch

FRAME_DEPTH_MIN, FRAME_DEPTH_MAX = 0.01, 0.99
FRAME_BELOW, FRAME_ABOVE = 1.0, 0.5
MAP_BELOW, MAP_ABOVE = 1.25, 0.75
DEPTH_SCALE = 10.0
EMPTY_KEY = -(2 ** 31)
Q_BITS = 14
Q_MAX = (1 << Q_BITS) - 1
WINDOW_IDX = 1 << 20

_libm = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
_libm.cosf.restype = _libm.sinf.restype = ctypes.c_float
_libm.cosf.argtypes = _libm.sinf.argtypes = [ctypes.c_float]


def cosf(x) -> np.ndarray:
    x = np.asarray(x, np.float32)
    return np.array([_libm.cosf(float(v)) for v in x.reshape(-1)],
                    np.float32).reshape(x.shape)


def sinf(x) -> np.ndarray:
    x = np.asarray(x, np.float32)
    return np.array([_libm.sinf(float(v)) for v in x.reshape(-1)],
                    np.float32).reshape(x.shape)


def recip(v: float) -> float:
    return float(np.float32(1.0) / np.float32(v))


def fma32(a, b, c):
    """float32 ``a * b + c`` with one rounding: exact product in float64,
    the sum rounded to odd, then to float32."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    fix = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.where(err > 0, torch.full_like(s, math.inf),
                         torch.full_like(s, -math.inf))
    return torch.where(fix, torch.nextafter(s, toward), s).float()


def mat3(m, v):
    """(B, 3, 3) x (B, N, 3): three FMAs per output in index order."""
    out = []
    for i in range(3):
        acc = m[:, None, i, 0] * v[..., 0]
        acc = fma32(m[:, None, i, 1].expand_as(acc), v[..., 1], acc)
        acc = fma32(m[:, None, i, 2].expand_as(acc), v[..., 2], acc)
        out.append(acc)
    return torch.stack(out, -1)


def sortable(x):
    s = x.float().contiguous().view(torch.int32)
    return torch.where(s >= 0, s, s ^ 0x7FFFFFFF)


def unsortable(k):
    return torch.where(k >= 0, k, k ^ 0x7FFFFFFF).contiguous().view(
        torch.float32)


def rays(depth_hw: Tuple[int, int], hfov_degrees: float, device):
    """Per-column and per-row ray scales with the depth scale folded in."""
    h, w = depth_hw
    vfov = math.radians(hfov_degrees * h / w)
    hfov = w / h * vfov
    fx = w / (2.0 * math.tan(hfov / 2.0))
    fy = h / (2.0 * math.tan(vfov / 2.0))
    kx = np.float32(DEPTH_SCALE) * np.float32(recip(fx))
    ky = np.float32(DEPTH_SCALE) * np.float32(recip(fy))
    rx = (torch.arange(w, dtype=torch.float32) + (0.5 - w / 2)) * float(kx)
    ry = (torch.arange(h, dtype=torch.float32) + (0.5 - h / 2)) * float(ky)
    return rx.to(device), ry.to(device)


def world_points(depth_u16, pose, orient, rays_x, rays_y, half):
    """World points (B, H * W, 3) of wire depth frames (B, H, W), the
    depth and height filter, and each point's absolute half-resolution
    cell (row by z, column by x)."""
    dev = rays_x.device
    b, h, w = depth_u16.shape
    pose = np.asarray(pose, np.float32)
    elev = np.asarray(orient[:, 0], np.float32) + np.float32(np.pi)
    head = np.asarray(orient[:, 1], np.float32)
    cx, sx = torch.from_numpy(cosf(elev)), torch.from_numpy(sinf(elev))
    cy, sy = torch.from_numpy(cosf(head)), torch.from_numpy(sinf(head))
    zero = torch.zeros_like(cx)
    rot = torch.stack([
        torch.stack([cy, sx * sy, cx * sy], -1),
        torch.stack([zero, cx, -sx], -1),
        torch.stack([-sy, cy * sx, cy * cx], -1)], 1).to(dev)
    d = depth_u16.float() * (1.0 / 65535.0)
    cam = torch.stack([d * rays_x[None, None, :], d * rays_y[None, :, None],
                       d * DEPTH_SCALE], -1).reshape(b, h * w, 3)
    pts = mat3(rot, cam) + torch.from_numpy(pose).to(dev)[:, None, :]
    dflat = d.reshape(b, -1)
    hy = pts[:, :, 1]
    py = torch.from_numpy(pose[:, 1]).to(dev)[:, None]
    valid = ((dflat > FRAME_DEPTH_MIN) & (dflat < FRAME_DEPTH_MAX)
             & (hy > py + np.float32(-FRAME_BELOW))
             & (hy < py + np.float32(FRAME_ABOVE)))
    inv = recip(half)
    r_abs = torch.round(pts[:, :, 2] * inv).long()
    c_abs = torch.round(pts[:, :, 0] * inv).long()
    return pts, valid, r_abs, c_abs


def touched_cells(depth_u16: np.ndarray, pose: dict, frame: int,
                  widths: dict, device, chunk: int = 32) -> int:
    """Distinct grid cells the kept points of one step's frames (L, H, W,
    1) land in, lane by lane: the words K1 must read."""
    lanes = depth_u16.shape[0]
    rx, ry = rays((widths["depth_side"], widths["depth_side"]),
                  widths["hfov"], device)
    half = widths["map_resolution"] / 2
    total = 0
    for s in range(0, lanes, chunk):
        e = min(s + chunk, lanes)
        d = torch.from_numpy(depth_u16[s:e, ..., 0].astype(np.int32))
        d = d.to(device)
        _, valid, r, c = world_points(
            d, pose["world_robot_pose"][frame, s:e],
            pose["world_robot_orientation"][frame, s:e], rx, ry, half)
        lane = torch.arange(e - s, device=device)[:, None]
        key = (lane * 2 ** 42 + (r + 2 ** 20) * 2 ** 21 + (c + 2 ** 20))[valid]
        total += int(torch.unique(key).numel())
    return total


class RefMapper:
    """World grids of ``lanes`` lanes on ``device`` and the step that
    updates them and rasterizes the maps."""

    def __init__(self, lanes: int, grid: int, depth_hw: Tuple[int, int],
                 hfov_degrees: float, map_meters: float, resolution: float,
                 window: int, device):
        self.g = grid
        self.window = window
        self.res = resolution
        self.half = resolution / 2
        self.side = math.ceil(map_meters / resolution)
        self.map_meters = map_meters
        self.device = device
        self.rays_x, self.rays_y = rays(depth_hw, hfov_degrees, device)
        self.word = torch.empty((lanes, grid, grid), dtype=torch.int64,
                                device=device)
        self.aux = torch.zeros((lanes, grid, grid), dtype=torch.int32,
                               device=device)
        self.origin = np.zeros((lanes, 2), np.int64)
        self.origin_set = np.zeros(lanes, bool)
        self.clear(np.ones(lanes, bool))

    def clear(self, lanes: np.ndarray) -> None:
        idx = np.nonzero(lanes)[0]
        if len(idx):
            t = torch.as_tensor(idx, device=self.device)
            self.word[t] = (EMPTY_KEY << 32) | 0xFFFFFFFF
            self.aux[t] = 0
            self.origin_set[idx] = False

    def _cells(self, v):
        return np.round(np.asarray(v, np.float32)
                        * np.float32(recip(self.half))).astype(np.int64)

    def step(self, depth_u16: torch.Tensor, labels: torch.Tensor,
             pose: np.ndarray, orient: np.ndarray, keep: np.ndarray):
        """One step: ``depth_u16`` (B, H, W) wire depth, ``labels`` (B, H,
        W) uint8, ``pose`` (B, 3) and ``orient`` (B, 2) float32 host
        arrays, ``keep`` (B,) 0 where the lane's grid is cleared. Returns
        the (B, side, side) uint8 occupancy and semantic maps."""
        dev = self.device
        b, h, w = depth_u16.shape
        g = self.g
        self.clear(np.asarray(keep).reshape(-1) == 0)
        pose = np.asarray(pose, np.float32)
        r0 = self._cells(pose[:, 2])
        c0 = self._cells(pose[:, 0])
        new = np.stack([r0 - g // 2, c0 - g // 2], -1)
        self.origin = np.where(self.origin_set[:, None], self.origin, new)
        self.origin_set[:] = True
        origin = torch.from_numpy(self.origin).to(dev)

        head = np.asarray(orient[:, 1], np.float32)
        pts, valid, r_abs, c_abs = world_points(
            depth_u16, pose, orient, self.rays_x, self.rays_y, self.half)
        inv = recip(self.half)
        r = r_abs - origin[:, 0:1]
        c = c_abs - origin[:, 1:2]
        valid &= (r >= 0) & (r < g) & (c >= 0) & (c < g)

        def quant(v, cell):
            dd = v - cell.float() * self.half
            u = fma32(dd, torch.full_like(v, inv), torch.full_like(v, 0.5))
            return torch.clamp(torch.round(u * float(Q_MAX)), 0, Q_MAX).long()

        payload = ((quant(pts[:, :, 0], c_abs) << (4 + Q_BITS))
                   | (quant(pts[:, :, 2], r_abs) << 4)
                   | (labels.reshape(b, -1).long() & 0xF)).to(torch.int32)
        key = sortable(pts[:, :, 1])
        j = torch.arange(h * w, device=dev, dtype=torch.int64)
        cand = (key.long() << 32) | (0xFFFFFFFE - j)[None, :]
        lane = torch.arange(b, device=dev)[:, None]
        cell = ((lane * g + r) * g + c)[valid]
        cand = cand[valid]
        flat = self.word.view(-1)
        flat.scatter_reduce_(0, cell, cand, "amax")
        win = flat[cell] == cand
        self.aux.view(-1)[cell[win]] = payload[valid][win]
        flat[cell[win]] = (key[valid][win].long() << 32) | 0xFFFFFFFF
        return self._raster(pose, head, r0, c0, origin)

    def _raster(self, pose, head, r0, c0, origin):
        dev = self.device
        b = pose.shape[0]
        wc, g = self.window, self.g
        start = np.stack(
            [np.clip(r0 - self.origin[:, 0] - wc // 2, 0, g - wc),
             np.clip(c0 - self.origin[:, 1] - wc // 2, 0, g - wc)], -1)
        ar = torch.arange(wc, device=dev)
        st = torch.from_numpy(start).to(dev)
        rows = st[:, 0:1] + ar[None]
        cols = st[:, 1:2] + ar[None]
        lane = torch.arange(b, device=dev)[:, None, None]
        cells = (lane, rows[:, :, None], cols[:, None, :])
        word = self.word[cells].reshape(b, -1)
        aux = self.aux[cells].reshape(b, -1)
        key = (word >> 32).to(torch.int32)
        valid = key != EMPTY_KEY
        height = unsortable(key)
        r_abs = (rows[:, :, None] + origin[:, 0, None, None]).expand(
            b, wc, wc).reshape(b, -1)
        c_abs = (cols[:, None, :] + origin[:, 1, None, None]).expand(
            b, wc, wc).reshape(b, -1)
        rq = recip(Q_MAX)

        def coord(q, cell):
            t = fma32(q.float(), torch.full_like(q, rq, dtype=torch.float32),
                      torch.full_like(q, -0.5, dtype=torch.float32))
            return fma32(t, torch.full_like(t, self.half),
                         cell.float() * self.half)

        x = coord((aux >> (4 + Q_BITS)) & Q_MAX, c_abs)
        z = coord((aux >> 4) & Q_MAX, r_abs)
        label = (aux & 0xF).long()
        py = torch.from_numpy(pose[:, 1]).to(dev)[:, None]
        valid &= ((height > py + np.float32(-MAP_BELOW))
                  & (height < py + np.float32(MAP_ABOVE)))
        p = torch.from_numpy(pose).to(dev)
        shifted = torch.stack([x, height, z], -1) - p[:, None, :]
        cos = torch.from_numpy(cosf(-head)).to(dev)
        sin = torch.from_numpy(sinf(-head)).to(dev)
        zero, one = torch.zeros_like(cos), torch.ones_like(cos)
        rot = torch.stack([torch.stack([cos, zero, sin], -1),
                           torch.stack([zero, one, zero], -1),
                           torch.stack([-sin, zero, cos], -1)], 1)
        ego = mat3(rot, shifted)
        half_map = float(np.float32(self.map_meters / 2))
        inv = recip(self.res)
        mr = torch.round((ego[:, :, 2] + half_map) * inv).long()
        mc = torch.round((ego[:, :, 0] + half_map) * inv).long()
        n = self.side
        valid &= (mr >= 0) & (mr < n) & (mc >= 0) & (mc < n)
        idx = torch.arange(wc * wc, device=dev)
        cand = (((label != 0).long() << 56) | ((key.long() + 2 ** 31) << 24)
                | ((WINDOW_IDX - 1 - idx)[None] << 4) | label)
        cell = torch.where(valid, mr * n + mc, 0)
        best = torch.zeros((b, n * n), dtype=torch.int64, device=dev)
        best.scatter_reduce_(1, cell, torch.where(valid, cand, 0), "amax")
        occ = (best != 0).to(torch.uint8)
        sem = torch.where((best >> 56) & 1 == 1, best & 0xF, 0).to(torch.uint8)
        return occ.reshape(b, n, n), sem.reshape(b, n, n)
