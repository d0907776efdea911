"""The port's mapper (ivlnce_tpu_torch/mapping/mapper.py, dense world grid
and the plain versions of the accumulate and rasterize kernels) against
the JAX ``mapper_step`` (compact list plus flush), exactly, on the
fixtures of tests/test_mapper.py.

Per step the occupancy and semantic maps and the ``dropped`` counts must
be equal; after the JAX list is flushed into its grid (``_flush_list``),
the dense (key, aux) grids and the lane origins must be equal too."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivlnce_tpu.mapping import mapper as JM
from ivlnce_tpu.mapping.camera import CameraParameters as JCamera
from ivlnce_tpu.ops import scatter as JS
from ivlnce_tpu_torch.mapping import mapper as TM
from ivlnce_tpu_torch.mapping.camera import CameraParameters as TCamera
from ivlnce_tpu_torch.ops import scatter as TS
from tests.test_torch_train import one_torch_thread  # noqa: F401  (autouse)


def make_params(hw=16, grid=512, window=192, map_m=6.4, vfov_deg=79.0,
                list_capacity=131072):
    jp = JM.MapperParams(
        camera=JCamera(math.radians(vfov_deg), (hw, hw), 0.1),
        map_height_meters=map_m, map_width_meters=map_m,
        resolution_meters=0.1, grid_cells=grid, window_cells=window,
        list_capacity=max(list_capacity, hw * hw),
    )
    tp = TM.MapperParams(
        camera=TCamera(math.radians(vfov_deg), (hw, hw), 0.1),
        map_height_meters=map_m, map_width_meters=map_m,
        resolution_meters=0.1, grid_cells=grid, window_cells=window,
    )
    return jp, tp


class Both:
    """One JAX and one port mapper state, stepped together."""

    def __init__(self, jp, tp, batch):
        self.jp, self.tp = jp, tp
        self.js = JM.init_state(batch, jp.grid_cells, jp.list_capacity)
        self.ts = TM.init_state(batch, tp.grid_cells, "cpu")

    def step(self, depth, sem, pose, elevation, heading, masks, label=""):
        self.js, jocc, jsem = JM.mapper_step(
            self.jp, self.js, jnp.asarray(depth), jnp.asarray(sem),
            jnp.asarray(pose), jnp.asarray(elevation), jnp.asarray(heading),
            jnp.asarray(masks),
        )
        self.ts, tocc, tsem = TM.mapper_step(
            self.tp, self.ts, torch.from_numpy(depth), torch.from_numpy(sem),
            pose, elevation, heading, masks,
        )
        np.testing.assert_array_equal(
            tocc.numpy(), np.asarray(jocc), err_msg=f"occupancy {label}")
        np.testing.assert_array_equal(
            tsem.numpy(), np.asarray(jsem), err_msg=f"semantic {label}")
        np.testing.assert_array_equal(
            self.ts.dropped.numpy(), np.asarray(self.js.dropped),
            err_msg=f"dropped {label}")
        return tocc.numpy(), tsem.numpy()

    def assert_grids_equal(self, label=""):
        flushed = JM._flush_list(self.js)
        np.testing.assert_array_equal(
            self.ts.key().numpy(), np.asarray(flushed.key),
            err_msg=f"grid key {label}")
        np.testing.assert_array_equal(
            self.ts.aux.numpy(), np.asarray(flushed.aux).view(np.int32),
            err_msg=f"grid aux {label}")
        np.testing.assert_array_equal(
            self.ts.origin, np.asarray(flushed.origin))
        np.testing.assert_array_equal(
            self.ts.origin_set, np.asarray(flushed.origin_set))


def synth_frame(rng, b, hw, near=0.05, far=0.6):
    depth = rng.uniform(near, far, (b, hw, hw)).astype(np.float32)
    sem = rng.integers(0, 13, (b, hw, hw)).astype(np.uint8)
    return depth, sem


@pytest.mark.parametrize("hw,far", [(16, 0.6), (32, 1.0)])
def test_walk_with_teleport_matches_jax(rng, hw, far):
    """tests/test_mapper.py's 12-step walk, lane 0 teleporting at step 6;
    the second case uses the whole depth range, so the frame filters'
    edges and their drops are crossed."""
    jp, tp = make_params(hw=hw)
    both = Both(jp, tp, 2)
    pose = np.array([[0.0, 1.25, 0.0], [5.0, 1.25, -3.0]], np.float32)
    heading = np.array([0.0, 1.1], np.float32)
    occupied = 0
    for t in range(12):
        depth, sem = synth_frame(rng, 2, hw, far=far)
        occ, _ = both.step(depth, sem, pose, np.zeros(2, np.float32),
                           heading, np.ones(2, np.float32), f"step {t}")
        occupied += int(occ.sum())
        pose = pose + np.array([[0.2, 0.0, -0.15], [-0.1, 0.0, 0.2]],
                               np.float32)
        heading = heading + np.array([0.13, -0.2], np.float32)
        if t == 5:
            pose = pose + np.array([[4.0, 0.0, -3.5], [0.0, 0.0, 0.0]],
                                   np.float32)
    assert occupied > 0
    both.assert_grids_equal("after the walk")


def test_lane_reset_matches_jax(rng):
    """tests/test_mapper.py's reset of lane 0 only, then a third step with
    a new pose so the re-established origin is exercised."""
    jp, tp = make_params()
    both = Both(jp, tp, 2)
    pose = np.zeros((2, 3), np.float32)
    pose[:, 1] = 1.25
    depth, sem = synth_frame(rng, 1, 16)
    depth = np.concatenate([depth, depth])
    sem = np.concatenate([sem, sem])
    zeros = np.zeros(2, np.float32)
    occ1, _ = both.step(depth, sem, pose, zeros, zeros,
                        np.ones(2, np.float32), "first")
    occ2, _ = both.step(depth, sem, pose, zeros, zeros,
                        np.array([0.0, 1.0], np.float32), "reset lane 0")
    np.testing.assert_array_equal(occ2, occ1)
    both.assert_grids_equal("after reset")
    pose2 = pose + np.array([[3.0, 0.0, 2.0]], np.float32)
    both.step(depth, sem, pose2, zeros, zeros, np.array([0.0, 1.0],
              np.float32), "reset with a moved robot")
    both.assert_grids_equal("after the second reset")


def test_duplicate_resolved_before_height_filter_matches_jax():
    """tests/test_mapper.py's grid/list duplicate: the JAX raster on a
    state whose cell is both in the grid and in the list equals the
    port's raster of the flushed (dense) state."""
    g = 128
    jp, tp = make_params(hw=4, grid=g, window=64, map_m=1.6,
                         list_capacity=8192)
    state = JM.init_state(1, g, jp.list_capacity)
    origin = np.array([[-g // 2, -g // 2]], np.int32)
    rel_r, rel_c = g // 2, g // 2 + 2

    def packed(x, z, label):
        return int(JS.pack_aux(jnp.float32(x), jnp.float32(z),
                               jnp.uint32(label), jnp.int32(0), jnp.int32(2),
                               jp.half_res))

    def keyed(h):
        return int(JS.sortable_from_float(jnp.float32(h)))

    key = np.full((1, g, g), JS.EMPTY_KEY, np.int32)
    aux = np.zeros((1, g, g), np.uint32)
    key[0, rel_r, rel_c] = keyed(1.7)
    aux[0, rel_r, rel_c] = packed(0.1, 0.0, 3)
    lcell = np.full((1, jp.list_capacity), JS.LIST_EMPTY, np.int32)
    lkey = np.full((1, jp.list_capacity), JS.EMPTY_KEY, np.int32)
    laux = np.zeros((1, jp.list_capacity), np.uint32)
    lcell[0, 0] = rel_r * g + rel_c
    lkey[0, 0] = keyed(0.5)
    laux[0, 0] = packed(0.1, 0.0, 2)
    state = state._replace(
        key=jnp.asarray(key), aux=jnp.asarray(aux),
        origin=jnp.asarray(origin), origin_set=jnp.ones((1,), bool),
        lcell=jnp.asarray(lcell), lkey=jnp.asarray(lkey),
        laux=jnp.asarray(laux), fill=jnp.ones((1,), jnp.int32),
    )
    flip = state._replace(lkey=jnp.asarray(np.where(
        lcell == rel_r * g + rel_c, keyed(1.9), lkey).astype(np.int32)))

    cases = [(state, 0.8, 0), (state, 1.25, 3), (flip, 1.25, 2)]
    for jstate, robot_y, label in cases:
        pose = np.array([[0.0, robot_y, 0.0]], np.float32)
        heading = np.zeros(1, np.float32)
        jocc, jsem = JM._rasterize_egocentric(
            jp, jstate, jnp.asarray(pose), jnp.asarray(heading))
        flushed = JM._flush_list(jstate)
        tstate = TM.init_state(1, g, "cpu")
        tstate.word.copy_(
            (torch.from_numpy(np.array(flushed.key)).long() << 32)
            | TS.INCUMBENT_LOW)
        tstate.aux.copy_(torch.from_numpy(
            np.array(flushed.aux).view(np.int32)))
        tstate.origin = origin.copy()
        tstate.origin_set = np.ones(1, bool)
        inp = TM.step_inputs(tp, tstate, torch.zeros(1, 4, 4),
                             torch.zeros(1, 4, 4, dtype=torch.uint8), pose,
                             np.zeros(1, np.float32), heading,
                             np.ones(1, np.float32))
        tocc, tsem = TS.rasterize(tstate.word, tstate.aux, inp.start,
                                  inp.origin, inp.lane_ras, tp.window_cells,
                                  tp.map_dims, tp.half_res)
        np.testing.assert_array_equal(tocc.numpy(), np.asarray(jocc))
        np.testing.assert_array_equal(tsem.numpy(), np.asarray(jsem))
        assert int(tsem.numpy().max()) == label


def test_flush_boundary_matches_jax(rng):
    """tests/test_mapper.py's flush every step (list capacity of one
    frame) while the robot oscillates and its height wanders."""
    hw = 16
    jp, tp = make_params(hw=hw, list_capacity=hw * hw)
    assert jp.list_capacity == hw * hw
    both = Both(jp, tp, 1)
    pose = np.array([[0.0, 1.25, 0.0]], np.float32)
    heading = np.array([0.0], np.float32)
    for t in range(8):
        depth, sem = synth_frame(rng, 1, hw)
        both.step(depth, sem, pose, np.zeros(1, np.float32), heading,
                  np.ones(1, np.float32), f"step {t}")
        both.assert_grids_equal(f"step {t}")
        pose = pose + np.array(
            [[0.15 if t % 2 == 0 else -0.15, 0.25 if t % 2 else -0.25,
              0.05]], np.float32)
        heading = heading + np.array([0.4 if t % 2 else -0.3], np.float32)


def test_out_of_extent_drops_match_jax():
    """tests/test_mapper.py's bounded grid (64 cells = 3.2 m): far frames
    are counted as dropped, a lane reset keeps the count, near frames add
    nothing."""
    hw = 16
    jp, tp = make_params(hw=hw, grid=64, window=32)
    both = Both(jp, tp, 2)
    sem = np.ones((2, hw, hw), np.uint8)
    pose = np.array([[0.0, 1.25, 0.0]] * 2, np.float32)
    zeros = np.zeros(2, np.float32)
    ones = np.ones(2, np.float32)
    both.step(np.full((2, hw, hw), 0.8, np.float32), sem, pose, zeros,
              zeros, ones, "far")
    dropped = both.ts.dropped.numpy().copy()
    assert (dropped > 0).all()
    both.step(np.full((2, hw, hw), 0.05, np.float32), sem, pose, zeros,
              zeros, np.array([1.0, 0.0], np.float32), "near, lane 1 reset")
    np.testing.assert_array_equal(both.ts.dropped.numpy(), dropped)
    both.assert_grids_equal("after the near frame")


def test_clear_lanes_writes_only_cleared_lanes():
    _, tp = make_params()
    state = TM.init_state(3, 8, "cpu")
    state.word.fill_(7)
    state.aux.fill_(5)
    state.origin_set[:] = True
    state.dropped.fill_(2)
    TM.clear_lanes(state, np.array([1, 0, 1]))
    assert (state.word[1] == TS.EMPTY_WORD).all()
    assert (state.aux[1] == 0).all()
    assert (state.word[[0, 2]] == 7).all() and (state.aux[[0, 2]] == 5).all()
    assert state.origin_set.tolist() == [True, False, True]
    assert state.dropped.tolist() == [2, 2, 2]


def test_obs_transform_keeps_lane_state_full_width(rng):
    """The trainer pauses lanes on the host only: it keeps passing the
    full lane count, so every lane's map and drop count stay."""
    from ivlnce_tpu_torch.mapping.obs_transforms import (
        GTSemanticsIterativeMapper,
    )
    from ivlnce_tpu_torch.ops.geometry import MapDims

    _, tp = make_params(grid=64, window=48)
    mapper = GTSemanticsIterativeMapper(tp.camera, MapDims(6.4, 6.4, 0.1),
                                        torch.device("cpu"), grid_cells=64,
                                        window_cells=48)
    mapper.host_prepare({}, np.ones(3), num_rows=3)
    state = mapper.state
    state.word[:, 0, 0] = torch.arange(3)
    state.dropped[:] = torch.tensor([4, 5, 6], dtype=torch.int32)
    mapper.host_prepare({}, np.ones(3), num_rows=3)
    assert mapper.state is state
    assert mapper.state.word[:, 0, 0].tolist() == [0, 1, 2]
    assert mapper.dropped_point_count() == 15
    assert mapper.warn_if_dropped("test") == 15
