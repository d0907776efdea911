"""The port's geometry core (ivlnce_tpu_torch/ops/geometry.py) against the
JAX package's, bit for bit, on the inputs of tests/test_geometry.py.

The JAX functions run under ``jax.jit``, the form the mapper runs them in
(inside ``mapper_step``): there XLA turns a division by a constant into a
multiplication by its reciprocal and a 3x3 product into fused
multiply-adds, and the port reproduces that compiled arithmetic."""

import math

import jax
import numpy as np
import pytest
import torch

from ivlnce_tpu.ops import geometry as JG
from ivlnce_tpu_torch.ops import geometry as TG
from tests.test_torch_train import one_torch_thread  # noqa: F401  (autouse)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_transform3d_equal(rng):
    pose = rng.normal(size=(5, 3)).astype(np.float32)
    elev = rng.normal(size=(5,)).astype(np.float32)
    head = rng.normal(size=(5,)).astype(np.float32)
    ref = np.asarray(jax.jit(JG.transform3d)(pose, elev, head))
    ours = _np(TG.transform3d(torch.from_numpy(pose), elev, head))
    np.testing.assert_array_equal(ours, ref)
    eye = _np(TG.transform3d(torch.zeros(1, 3), np.zeros(1), np.zeros(1)))
    np.testing.assert_array_equal(eye[0], np.eye(4, dtype=np.float32))


def test_rotate_around_y_equal(rng):
    ang = rng.normal(size=(7,)).astype(np.float32)
    ref = np.asarray(jax.jit(JG.rotate_around_y_matrix)(ang))
    np.testing.assert_array_equal(_np(TG.rotate_around_y_matrix(ang)), ref)


@pytest.mark.parametrize("w,h", [(256, 256), (640, 480), (4, 4)])
def test_intrinsics_equal(w, h):
    vfov = math.radians(90)
    assert TG.intrinsics_from_vfov(w, h, vfov) == JG.intrinsics_from_vfov(
        w, h, vfov
    )


@pytest.mark.parametrize("hw,vfov_deg", [(4, 90.0), (16, 79.0), (64, 90.0)])
def test_pixel_ray_scaling_equal(hw, vfov_deg):
    vfov = math.radians(vfov_deg)
    ref_x, ref_y = jax.jit(lambda: JG.pixel_ray_scaling(hw, hw, vfov))()
    xs, ys = TG.pixel_ray_scaling(hw, hw, vfov)
    np.testing.assert_array_equal(_np(xs), np.asarray(ref_x))
    np.testing.assert_array_equal(_np(ys), np.asarray(ref_y))


@pytest.mark.parametrize("hw,vfov_deg", [(8, 90.0), (16, 79.0)])
def test_depth_to_world_points_equal(rng, hw, vfov_deg):
    vfov = math.radians(vfov_deg)
    b = 3
    depth = rng.uniform(0.0, 1.0, (b, hw, hw)).astype(np.float32)
    depth[0] = 0.1  # tests/test_geometry.py's straight-ahead frame
    pose = rng.normal(size=(b, 3)).astype(np.float32)
    pose[0] = (0.0, 2.0, 0.0)
    elev = (rng.normal(size=(b,)) * 0.1 + np.pi).astype(np.float32)
    head = rng.normal(size=(b,)).astype(np.float32)
    elev[0], head[0] = np.float32(np.pi), 0.0

    @jax.jit
    def ref_fn(d, p, e, h):
        xs, ys = JG.pixel_ray_scaling(hw, hw, vfov)
        return JG.depth_to_world_points(d, JG.transform3d(p, e, h), xs, ys,
                                        10.0)

    ref = np.asarray(ref_fn(depth, pose, elev, head))
    T = TG.transform3d(torch.from_numpy(pose), elev, head)
    ours = _np(TG.depth_to_world_points(torch.from_numpy(depth), T, vfov))
    assert ours.shape == (b, hw, hw, 3)
    np.testing.assert_array_equal(ours, ref)


def test_camera_to_world_equal(rng):
    b, n = 3, 17
    xyz = rng.normal(size=(b, n, 3)).astype(np.float32)
    T = np.array(jax.jit(JG.transform3d)(
        rng.normal(size=(b, 3)).astype(np.float32),
        rng.normal(size=(b,)).astype(np.float32),
        rng.normal(size=(b,)).astype(np.float32),
    ))
    ref = np.asarray(jax.jit(JG.camera_to_world)(xyz, T))
    ours = _np(TG.camera_to_world(torch.from_numpy(xyz), torch.from_numpy(T)))
    np.testing.assert_array_equal(ours, ref)


def test_meters_to_cell_index_equal(rng):
    vals = np.concatenate([
        np.array([-0.25, -0.15, -0.05, 0.05, 0.15, 0.25, 0.35], np.float32),
        rng.uniform(-30, 30, 200).astype(np.float32),
    ])
    for res in (0.1, 0.05):
        ref = np.asarray(jax.jit(
            lambda v: JG.meters_to_cell_index(v, res))(vals))
        ours = _np(TG.meters_to_cell_index(torch.from_numpy(vals), res))
        np.testing.assert_array_equal(ours, ref)


def test_project_to_map_indices_equal(rng):
    dims = JG.MapDims(6.4, 6.4, 0.1)
    tdims = TG.MapDims(6.4, 6.4, 0.1)
    assert (tdims.num_rows, tdims.num_cols) == (dims.num_rows, dims.num_cols)
    rows_m = np.concatenate([
        np.array([0.0, -3.2, 3.14, 3.19, 5.0], np.float32),
        rng.uniform(-4, 4, 300).astype(np.float32),
    ])
    cols_m = np.concatenate([
        np.array([0.0, -3.2, 3.14, 3.19, -5.0], np.float32),
        rng.uniform(-4, 4, 300).astype(np.float32),
    ])
    ref = jax.jit(lambda r, c: JG.project_to_map_indices(r, c, dims))(
        rows_m, cols_m)
    ours = TG.project_to_map_indices(
        torch.from_numpy(rows_m), torch.from_numpy(cols_m), tdims)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


def test_egocentric_shift_equal(rng):
    b, n = 2, 9
    xyz = rng.normal(size=(b, n, 3)).astype(np.float32)
    pose = rng.normal(size=(b, 3)).astype(np.float32)
    heading = rng.normal(size=(b,)).astype(np.float32)
    ref = np.asarray(jax.jit(JG.egocentric_shift)(xyz, pose, heading))
    ours = _np(TG.egocentric_shift(
        torch.from_numpy(xyz), torch.from_numpy(pose), heading))
    np.testing.assert_array_equal(ours, ref)


def test_fma32_is_correctly_rounded(rng):
    a = rng.normal(size=4096).astype(np.float32)
    b = rng.normal(size=4096).astype(np.float32)
    c = rng.normal(size=4096).astype(np.float32)
    exact = (a.astype(np.float64) * b.astype(np.float64)
             + c.astype(np.float64))
    # float64 keeps the exact product; its sum with c is off by at most
    # half a float64 ulp, far below half a float32 ulp except at ties,
    # which random normals do not hit
    ref = exact.astype(np.float32)
    ours = _np(TG.fma32(torch.from_numpy(a), torch.from_numpy(b),
                        torch.from_numpy(c)))
    np.testing.assert_array_equal(ours, ref)


def test_heading_from_quaternion_equal():
    for theta in [0.0, 0.5, 1.5, math.pi, -0.5, 5.0]:
        q = (0.0, math.sin(theta / 2), 0.0, math.cos(theta / 2))
        assert TG.heading_from_quaternion(*q) == JG.heading_from_quaternion(
            *q)
