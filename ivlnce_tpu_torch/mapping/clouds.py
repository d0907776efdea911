"""Seeded known-map loads for checking the known-map load (K3).

A load is what ``mapping.mapper.load_lanes`` takes from the host: the
state rows to load, one padded cloud per row (world xyz float32, labels
uint8), the clouds' point counts and the world (x, z) each row's grid
centres on. Resolution 0.1 m (half-resolution cells of 0.05 m).

- ``edge_cases``: loads at the edges of K3's tiled design (64 x 64-cell
  tiles of the row). Every case first fills its rows with a stale cloud,
  so the case's own load must clear them.
- ``val_seen_clouds``: the fake val_seen scenes' clouds, as the known-map
  evaluation loads them.
"""

from __future__ import annotations

import os
from typing import Iterator, NamedTuple, Sequence, Tuple

import numpy as np

HEIGHTS = np.float32([0.2, 0.5, 0.8, 1.1])
# the float32 height whose sortable key is EMPTY_KEY (the all-ones -NaN)
EMPTY_KEY_HEIGHT = np.array([0xFFFFFFFF], np.uint32).view(np.float32)[0]


class Load(NamedTuple):
    lanes: np.ndarray  # (L,) int: state rows
    xyz: np.ndarray  # (L, N, 3) float32
    sem: np.ndarray  # (L, N) uint8
    counts: np.ndarray  # (L,) int32
    centers: np.ndarray  # (L, 2) float32 world (x, z)


class Case(NamedTuple):
    name: str
    grid: int  # G: cells per side of a row
    batch: int  # state rows
    loads: Tuple[Load, ...]


def _cloud(rng, lanes: int, n: int, lo: float, hi: float) -> Tuple:
    """Points with (x, z) uniform in [lo, hi)^2, heights from HEIGHTS (so
    cells hold equal keys), labels 0..12."""
    xyz = np.empty((lanes, n, 3), np.float32)
    xyz[:, :, [0, 2]] = rng.uniform(lo, hi, (lanes, n, 2))
    xyz[:, :, 1] = rng.choice(HEIGHTS, (lanes, n))
    sem = rng.integers(0, 13, (lanes, n)).astype(np.uint8)
    return xyz, sem


def _load(lanes: Sequence[int], xyz, sem, counts=None) -> Load:
    lanes = np.asarray(lanes, np.int64)
    if counts is None:
        counts = np.full(len(lanes), xyz.shape[1], np.int32)
    centers = np.zeros((len(lanes), 2), np.float32)
    return Load(lanes, xyz, sem, np.asarray(counts, np.int32), centers)


def edge_cases(seed: int = 0) -> Iterator[Case]:
    """The cases, each grid centred on the world origin."""
    rng = np.random.default_rng(seed)

    def stale(lanes, g):
        # a cloud over the whole row, to be cleared by the case's load
        half = g * 0.025
        return _load(lanes, *_cloud(rng, len(lanes), 1500, -half, half))

    # a row with counts 0 is cleared and stores nothing
    xyz, sem = _cloud(rng, 2, 1024, -3.0, 3.0)
    yield Case("a lane with counts 0", 128, 2,
               (stale([0, 1], 128), _load([0, 1], xyz, sem, [0, 1024])))

    # every point in one cell: equal keys go to the lowest index
    xyz, sem = _cloud(rng, 1, 1000, 0.0, 1.0)
    xyz[:, :, 0], xyz[:, :, 2] = np.float32(0.31), np.float32(-0.22)
    yield Case("all points in one cell", 128, 1,
               (stale([0], 128), _load([0], xyz, sem)))

    # every point past the grid's edge: all dropped, the row cleared
    xyz, sem = _cloud(rng, 1, 1000, 10.0, 20.0)
    yield Case("all points off the grid", 128, 1,
               (stale([0], 128), _load([0], xyz, sem)))

    # nine in ten points in one 64 x 64 tile (x, z in [0, 3.175) m)
    xyz, sem = _cloud(rng, 2, 4096, -6.0, 6.0)
    hot = rng.random((2, 4096)) < 0.9
    xyz[:, :, 0] = np.where(hot, rng.uniform(0.1, 3.0, (2, 4096)),
                            xyz[:, :, 0])
    xyz[:, :, 2] = np.where(hot, rng.uniform(0.1, 3.0, (2, 4096)),
                            xyz[:, :, 2])
    yield Case("one tile holding most of the cloud", 256, 2,
               (stale([0, 1], 256), _load([0, 1], xyz, sem)))

    # ragged grids: edge tiles of 36 and of 1 cell per side
    xyz, sem = _cloud(rng, 2, 3000, -3.0, 3.0)
    yield Case("G=100", 100, 2, (stale([0, 1], 100), _load([0, 1], xyz, sem)))
    xyz, sem = _cloud(rng, 2, 3000, -7.0, 7.0)
    yield Case("G=257, rows 0 and 2 of 3", 257, 3,
               (stale([0, 1, 2], 257), _load([0, 2], xyz, sem, [3000, 2100])))

    # N a multiple of no block size, padding past the count
    xyz, sem = _cloud(rng, 1, 777, -3.0, 3.0)
    xyz[:, 700:] = rng.uniform(-1e3, 1e3, (1, 77, 3))
    yield Case("N not a multiple of the block", 128, 1,
               (stale([0], 128), _load([0], xyz, sem, [700])))

    # row 1 loaded twice into disjoint areas: the first cloud's cells go
    first = _load([1], *_cloud(rng, 1, 2000, -3.0, -1.0))
    second = _load([1], *_cloud(rng, 1, 2000, 1.0, 3.0))
    yield Case("a row loaded twice", 128, 2, (first, second))

    # heights whose key is EMPTY_KEY never store; -inf and +inf do
    xyz, sem = _cloud(rng, 1, 600, -1.0, 1.0)
    y = xyz[0, :, 1]
    y[:200] = EMPTY_KEY_HEIGHT
    y[200:220] = -np.inf
    y[220:240] = np.inf
    xyz[0, :100, [0, 2]] = np.float32(-2.0)  # a cell with only those
    yield Case("heights whose key is EMPTY_KEY", 128, 1,
               (stale([0], 128), _load([0], xyz, sem)))


def val_seen_clouds(root: str = ".", lanes: int = 3) -> Load:
    """The first ``lanes`` fake val_seen scenes' clouds
    (``data/known_maps/gt_semantics``), padded to the largest, into rows
    0..lanes-1, each grid centred on the world origin."""
    clouds = []
    for i in range(lanes):
        path = os.path.join(root, "data", "known_maps", "gt_semantics",
                            f"fakeval_seen{i}.npz")
        with np.load(path) as f:
            clouds.append((f["xyz"].astype(np.float32),
                           f["semantics"].astype(np.uint8)))
    n = max(len(c[0]) for c in clouds)
    xyz = np.zeros((lanes, n, 3), np.float32)
    sem = np.zeros((lanes, n), np.uint8)
    for i, (x, s) in enumerate(clouds):
        xyz[i, :len(x)], sem[i, :len(s)] = x, s
    return _load(range(lanes), xyz, sem, [len(c[0]) for c in clouds])
