"""K4, the JAX package's older scatter-argmax forms, in the port: the
plain versions in ``ivlnce_tpu_torch/ops/scatter.py`` against the JAX
functions of ``ivlnce_tpu/ops/scatter.py`` on the inputs of
``tests/test_scatter.py``, exactly. No ported path calls them, so they
have no kernel and refuse tensors off the CPU."""

import jax
import numpy as np
import pytest
import torch

from ivlnce_tpu.ops import scatter as J
from ivlnce_tpu_torch.ops import scatter as S


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _assert_equal(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)


def _segments(rng, ties):
    n, num_segments = 257, 19
    values = rng.normal(size=(n,)).astype(np.float32)
    if ties:  # a third of the values on a few levels
        values[::3] = rng.integers(-2, 3, values[::3].shape)
    ids = rng.integers(0, num_segments, size=(n,)).astype(np.int32)
    valid = rng.random(n) > 0.3
    return values, ids, num_segments, valid


@pytest.mark.parametrize("ties", [False, True])
def test_segment_argmax_equals_jax(rng, ties):
    values, ids, num_segments, valid = _segments(rng, ties)
    want = J.segment_argmax(values, ids, num_segments, valid)
    got = S.segment_argmax(*_t(values, ids), num_segments, *_t(valid))
    _assert_equal(got, want)
    assert int(got.winner_mask.sum()) == int(
        np.isfinite(np.asarray(want.max_values)).sum())


def test_segment_argmax_ties_pick_lowest_index():
    values = np.array([1.0, 2.0, 2.0, 0.5], np.float32)
    ids = np.array([0, 0, 0, 1], np.int32)
    valid = np.ones(4, bool)
    got = S.segment_argmax(*_t(values, ids), 2, *_t(valid))
    _assert_equal(got, J.segment_argmax(values, ids, 2, valid))
    assert int(got.argmax[0]) == 1
    assert got.winner_mask.tolist() == [False, True, False, True]


def test_keep_highest_dedup_equals_jax(rng):
    n, res = 500, 0.1
    xyz = (rng.random((n, 3)) * 4 - 2).astype(np.float32)
    rows = np.round(xyz[:, 2] / (res / 2)).astype(np.int64)
    cols = np.round(xyz[:, 0] / (res / 2)).astype(np.int64)
    rows -= rows.min()
    cols -= cols.min()
    flat = (rows * (cols.max() + 1) + cols).astype(np.int32)
    num_cells = int(flat.max()) + 1
    valid = np.ones(n, bool)
    want = np.asarray(J.keep_highest_dedup(xyz[:, 1], flat, num_cells, valid))
    got = S.keep_highest_dedup(*_t(xyz[:, 1], flat), num_cells, *_t(valid))
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.sum()) == len(np.unique(flat))


@pytest.mark.parametrize("ties", [False, True])
def test_scatter_argmax_grid_update_equals_jax(rng, ties):
    """Three frames streamed into the grid by both, with ties among new
    points and against incumbents when ``ties``."""
    B, R, C, P, n = 2, 16, 16, 2, 64
    jkey = np.full((B, R, C), -np.inf, np.float32)
    jpay = np.zeros((B, R, C, P), np.float32)
    tkey, tpay = _t(jkey, jpay)
    for _ in range(3):
        rows = rng.integers(0, R, size=(B, n)).astype(np.int32)
        cols = rng.integers(0, C, size=(B, n)).astype(np.int32)
        keys = rng.normal(size=(B, n)).astype(np.float32)
        if ties:
            keys[:, ::2] = rng.integers(0, 3, (B, n // 2))
        payload = rng.normal(size=(B, n, P)).astype(np.float32)
        valid = rng.random((B, n)) > 0.2
        jkey, jpay = jax.tree_util.tree_map(
            np.asarray, J.scatter_argmax_grid_update(
                jkey, jpay, rows, cols, keys, payload, valid))
        tkey, tpay = S.scatter_argmax_grid_update(
            tkey, tpay, *_t(rows, cols, keys, payload, valid))
        _assert_equal((tkey, tpay), (jkey, jpay))
    assert np.isfinite(jkey).any()


def test_rasterize_argmax_equals_jax(rng):
    B, n, R, C = 2, 200, 8, 8
    rows = rng.integers(0, R, size=(B, n)).astype(np.int32)
    cols = rng.integers(0, C, size=(B, n)).astype(np.int32)
    keys = rng.normal(size=(B, n)).astype(np.float32)
    keys[:, ::4] = 0.5  # ties go to the lowest index
    values = rng.integers(1, 13, size=(B, n)).astype(np.uint8)
    valid = rng.random((B, n)) > 0.5
    want = J.rasterize_argmax(rows, cols, keys, values, valid, R, C)
    got = S.rasterize_argmax(*_t(rows, cols, keys, values, valid), R, C)
    _assert_equal(got, want)
    assert 0 < int(got[0].sum()) < B * R * C


def test_k4_refuses_tensors_off_the_cpu():
    values = torch.zeros(4, device="meta")
    ids = torch.zeros(4, dtype=torch.int32, device="meta")
    valid = torch.ones(4, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="K4 has no kernel"):
        S.segment_argmax(values, ids, 2, valid)
