"""The mapper's tie rules on frames built to tie
(``ivlnce_tpu_torch/mapping/walks.py::tie_walk``): the port's plain
versions of the accumulate and rasterize kernels (``mapper_step`` on the
CPU) against the JAX package's ``mapper_step``, exactly.

In these frames many pixels share a grid cell and an exact float32 height
key (the lowest pixel must win), every second frame repeats the first's
points with new labels (the stored point must keep an equal key), many
window cells of one key meet in a map cell (the lowest window index must
win), lane 0 walks off the grid (its points are dropped) and, with three
lanes, lane 2 sees nothing (its window stays empty). The 100-cell raster
window does not divide into the CUDA rasterize's 8-block cluster."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivlnce_tpu.mapping import mapper as JM
from ivlnce_tpu.mapping.camera import CameraParameters as JCamera
from ivlnce_tpu_torch.mapping import mapper as TM
from ivlnce_tpu_torch.mapping import walks
from ivlnce_tpu_torch.mapping.camera import CameraParameters as TCamera
from ivlnce_tpu_torch.ops import geometry as TG
from ivlnce_tpu_torch.ops import scatter as TS
from tests.test_torch_train import one_torch_thread  # noqa: F401  (autouse)

HW, GRID, WINDOW, MAP_M, STEPS = 32, 256, 100, 3.2, 8


def tied_pixels(params, state, depth, pose, orient, masks) -> int:
    """Kept pixels of a frame that share their grid cell and their height
    key with a lower pixel of the same lane."""
    inp = TM.step_inputs(params, state, torch.from_numpy(depth), None, pose,
                         orient, None, masks)
    pts = TS.world_points(inp.depth, inp.lane_acc, inp.rays_x, inp.rays_y,
                          TM.DEPTH_SCALE_METERS)
    b = pts.shape[0]
    d = inp.depth.reshape(b, -1)
    hy = pts[:, :, 1]
    keep = ((d > TM.FRAME_DEPTH_MIN) & (d < TM.FRAME_DEPTH_MAX)
            & (hy > inp.lane_acc[:, 12:13]) & (hy < inp.lane_acc[:, 13:14]))
    inv = TG.f32_reciprocal(params.half_res)
    r = torch.round(pts[:, :, 2] * inv).long()
    c = torch.round(pts[:, :, 0] * inv).long()
    key = TS.sortable_from_float(hy).long()
    lane = torch.arange(b)[:, None].expand_as(r)
    rows = torch.stack([lane, r, c, key], -1)[keep]
    return int(rows.shape[0] - torch.unique(rows, dim=0).shape[0])


@pytest.mark.parametrize("batch,empty_lanes", [(1, ()), (3, (2,))])
def test_tie_frames_match_jax(batch, empty_lanes):
    camera = (math.radians(90.0), (HW, HW), 0.1)
    jp = JM.MapperParams(camera=JCamera(*camera), map_height_meters=MAP_M,
                         map_width_meters=MAP_M, resolution_meters=0.1,
                         grid_cells=GRID, window_cells=WINDOW,
                         list_capacity=4 * HW * HW)
    tp = TM.MapperParams(camera=TCamera(*camera), map_height_meters=MAP_M,
                         map_width_meters=MAP_M, resolution_meters=0.1,
                         grid_cells=GRID, window_cells=WINDOW)
    js = JM.init_state(batch, GRID, jp.list_capacity)
    ts = TM.init_state(batch, GRID, "cpu")
    probe = TM.init_state(batch, GRID, "cpu")
    tied = occupied = 0
    for t, (depth, sem, pose, orient, masks) in enumerate(walks.tie_walk(
            batch, HW, STEPS, seed=7, edge_step=2.0,
            empty_lanes=empty_lanes)):
        tied += tied_pixels(tp, probe, depth, pose, orient, masks)
        js, jocc, jsem = JM.mapper_step(
            jp, js, jnp.asarray(depth), jnp.asarray(sem), jnp.asarray(pose),
            jnp.asarray(orient[:, 0]), jnp.asarray(orient[:, 1]),
            jnp.asarray(masks))
        ts, tocc, tsem = TM.mapper_step(tp, ts, torch.from_numpy(depth),
                                        torch.from_numpy(sem), pose, orient,
                                        None, masks)
        np.testing.assert_array_equal(tocc.numpy(), np.asarray(jocc),
                                      err_msg=f"occupancy, step {t}")
        np.testing.assert_array_equal(tsem.numpy(), np.asarray(jsem),
                                      err_msg=f"semantic, step {t}")
        np.testing.assert_array_equal(ts.dropped.numpy(),
                                      np.asarray(js.dropped),
                                      err_msg=f"dropped, step {t}")
        occupied += int(tocc[0].sum())
        for lane in empty_lanes:
            assert int(tocc[lane].sum()) == 0
    flushed = JM._flush_list(js)
    np.testing.assert_array_equal(ts.key().numpy(), np.asarray(flushed.key))
    np.testing.assert_array_equal(ts.aux.numpy(),
                                  np.asarray(flushed.aux).view(np.int32))
    # the frames did what they are for
    assert tied > 40 * batch * STEPS, tied
    assert occupied > 0
    assert int(ts.dropped[0]) > 0
