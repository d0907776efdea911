"""The port's CUDA kernels (the mapper's K1-K3, the instruction bi-LSTM's
K5) against their plain PyTorch versions, on the card (marker ``cuda``;
these skip where there is no card or no nvcc).
Run them on a machine with an NVIDIA GPU:

    python -m pytest tests/test_torch_kernels.py -q --noconftest

(``--noconftest`` because tests/conftest.py sets up JAX, which a machine
with the card need not have.)

The mapper kernels' outputs must be exactly equal (they repeat the plain
versions' float32 arithmetic operation for operation); K5's features agree
within 2e-6 (its sums run in another order than the plain version's
matrix products)."""

import math
import os
import shutil

import numpy as np
import pytest
import torch

from ivlnce_tpu_torch.mapping import clouds
from ivlnce_tpu_torch.mapping import mapper as M
from ivlnce_tpu_torch.mapping.camera import CameraParameters
from ivlnce_tpu_torch.ops import scatter as S

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    if not (shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc")):
        pytest.skip("no nvcc to build the kernels")
    return torch.device("cuda")


@pytest.mark.parametrize("hw,grid,window", [(64, 256, 96), (256, 1024, 192)])
def test_kernels_equal_plain_versions_over_a_walk(card, hw, grid, window):
    rng = np.random.default_rng(hw)
    params = M.MapperParams(CameraParameters(math.radians(90.0), (hw, hw),
                                             0.1), 6.4, 6.4, 0.1,
                            grid_cells=grid, window_cells=window)
    b = 4
    kern = M.init_state(b, grid, card)
    plain = M.init_state(b, grid, card)
    consts = (M.FRAME_DEPTH_MIN, M.FRAME_DEPTH_MAX, M.DEPTH_SCALE_METERS,
              params.half_res)
    rargs = (params.window_cells, params.map_dims, params.half_res)
    pose = np.zeros((b, 3), np.float32)
    pose[:, 1] = 1.25
    heading = rng.uniform(0, 2 * np.pi, b).astype(np.float32)
    before = (S.launches.accumulate, S.launches.rasterize)
    for t in range(6):
        depth = torch.from_numpy(rng.uniform(0, 1, (b, hw, hw)).astype(
            np.float32)).to(card)
        sem = torch.from_numpy(rng.integers(0, 13, (b, hw, hw)).astype(
            np.uint8)).to(card)
        masks = np.ones(b, np.float32)
        masks[t % b] = float(t < 4)
        orient = np.stack([np.zeros(b, np.float32), heading], -1)
        ik = M.step_inputs(params, kern, depth, sem, pose, orient, None,
                           masks)
        ip = M.step_inputs(params, plain, depth, sem, pose, orient, None,
                           masks)
        S.accumulate(kern.word, kern.aux, kern.dropped, ik.depth,
                     ik.semantics, ik.lane_acc, ik.origin, ik.rays_x,
                     ik.rays_y, *consts)
        S.accumulate_plain(plain.word, plain.aux, plain.dropped, ip.depth,
                           ip.semantics, ip.lane_acc, ip.origin, ip.rays_x,
                           ip.rays_y, *consts)
        occ_k, sem_k = S.rasterize(kern.word, kern.aux, ik.start, ik.origin,
                                   ik.lane_ras, *rargs)
        occ_p, sem_p = S.rasterize_plain(plain.word, plain.aux, ip.start,
                                         ip.origin, ip.lane_ras, *rargs)
        torch.cuda.synchronize()
        assert torch.equal(kern.word, plain.word), t
        assert torch.equal(kern.aux, plain.aux), t
        assert torch.equal(kern.dropped, plain.dropped), t
        assert torch.equal(occ_k, occ_p) and torch.equal(sem_k, sem_p), t
        pose[:, 0] += np.float32(0.3)
        heading = (heading + np.float32(0.2)).astype(np.float32)
    assert (S.launches.accumulate, S.launches.rasterize) == (
        before[0] + 6, before[1] + 6)


def test_wrapper_refuses_mixed_devices(card):
    state = M.init_state(1, 64, card)
    with pytest.raises(ValueError, match="rays_x: on cpu"):
        S.accumulate(state.word, state.aux, state.dropped,
                     torch.zeros(1, 8, 8, device=card),
                     torch.zeros(1, 8, 8, dtype=torch.uint8, device=card),
                     torch.zeros(1, S.ACC_LANE_COLS, device=card),
                     torch.zeros(1, 2, dtype=torch.int32, device=card),
                     torch.zeros(8), torch.zeros(8, device=card),
                     0.01, 0.99, 10.0, 0.05)


def test_known_load_equals_plain_version(card):
    """K3 over two loads (the second into lanes 0 and 2 only) of clouds
    with off-grid points, equal-height runs and padding past the counts."""
    from ivlnce_tpu_torch.mapping.camera import CameraParameters

    rng = np.random.default_rng(3)
    g, b, n = 256, 3, 8192
    params = M.MapperParams(CameraParameters(1.2, (16, 16), 0.1), 6.4, 6.4,
                            0.1, grid_cells=g, window_cells=192)
    kern = M.init_state(b, g, card)
    plain = M.init_state(b, g, card)
    pose = np.array([[0.0, 1.25, 0.0], [2.0, 1.25, -1.0],
                     [-3.0, 1.25, 4.0]], np.float32)
    before = S.launches.known_load
    for lane_mask in ([1, 1, 1], [1, 0, 1]):
        xyz = rng.uniform(-8, 8, (b, n, 3)).astype(np.float32)
        xyz[:, :, 1] = rng.choice(np.float32([0.2, 0.5, 0.8]), (b, n))
        xyz[:, : n // 4, 0] = np.round(xyz[:, : n // 4, 0] * 40) / 40
        sem = rng.integers(0, 13, (b, n)).astype(np.uint8)
        counts = np.array([n, n // 2, n // 3], np.int32)
        lanes = np.nonzero(lane_mask)[0]
        d_xyz = torch.from_numpy(xyz[lanes]).to(card)
        d_sem = torch.from_numpy(sem[lanes]).to(card)
        d_counts = torch.from_numpy(counts[lanes]).to(card)
        M.load_lanes(params, kern, lanes, d_xyz, d_sem, d_counts,
                     pose[lanes][:, [0, 2]])
        rows, origin = M.prepare_load(params, plain, lanes,
                                      pose[lanes][:, [0, 2]])
        S.known_load_plain(plain.word, plain.aux, plain.dropped, rows,
                           origin, d_xyz, d_sem, d_counts, params.half_res)
        torch.cuda.synchronize()
        assert torch.equal(kern.word, plain.word)
        assert torch.equal(kern.aux, plain.aux)
        assert torch.equal(kern.dropped, plain.dropped)
    assert int(kern.dropped.sum()) > 0
    assert S.launches.known_load == before + 2


def _equal_plain_over(card, params, batch, frames):
    """Each step of ``frames`` through K1 and K2 and through the plain
    versions: grids, drop counts and maps exactly equal. Returns the drop
    counts."""
    kern = M.init_state(batch, params.grid_cells, card)
    plain = M.init_state(batch, params.grid_cells, card)
    consts = (M.FRAME_DEPTH_MIN, M.FRAME_DEPTH_MAX, M.DEPTH_SCALE_METERS,
              params.half_res)
    rargs = (params.window_cells, params.map_dims, params.half_res)
    for t, (depth, sem, pose, orient, masks) in enumerate(frames):
        d = torch.from_numpy(depth).to(card)
        s = torch.from_numpy(sem).to(card)
        ik = M.step_inputs(params, kern, d, s, pose, orient, None, masks)
        ip = M.step_inputs(params, plain, d, s, pose, orient, None, masks)
        S.accumulate(kern.word, kern.aux, kern.dropped, ik.depth,
                     ik.semantics, ik.lane_acc, ik.origin, ik.rays_x,
                     ik.rays_y, *consts)
        S.accumulate_plain(plain.word, plain.aux, plain.dropped, ip.depth,
                           ip.semantics, ip.lane_acc, ip.origin, ip.rays_x,
                           ip.rays_y, *consts)
        occ_k, sem_k = S.rasterize(kern.word, kern.aux, ik.start, ik.origin,
                                   ik.lane_ras, *rargs)
        occ_p, sem_p = S.rasterize_plain(plain.word, plain.aux, ip.start,
                                         ip.origin, ip.lane_ras, *rargs)
        torch.cuda.synchronize()
        assert torch.equal(kern.word, plain.word), t
        assert torch.equal(kern.aux, plain.aux), t
        assert torch.equal(kern.dropped, plain.dropped), t
        assert torch.equal(occ_k, occ_p) and torch.equal(sem_k, sem_p), t
    return kern.dropped.cpu()


# batch, frame side (40 does not divide into the accumulate's 32^2
# tiles), grid, window (100 does not divide into the raster's 8-block
# cluster), lanes that see nothing, lane 0's step off the grid
TIE_CASES = [
    (1, 64, 256, 100, (), 2.0),
    (3, 40, 256, 100, (2,), 2.0),
    (3, 256, 1024, 192, (1,), 6.0),
]


@pytest.mark.parametrize("batch,hw,grid,window,empty,edge", TIE_CASES)
def test_kernels_equal_plain_versions_on_tie_frames(card, batch, hw, grid,
                                                    window, empty, edge):
    from ivlnce_tpu_torch.mapping import walks

    params = M.MapperParams(CameraParameters(math.radians(90.0), (hw, hw),
                                             0.1), 6.4, 6.4, 0.1,
                            grid_cells=grid, window_cells=window)
    frames = walks.tie_walk(batch, hw, 10, seed=batch, edge_step=edge,
                            empty_lanes=empty)
    dropped = _equal_plain_over(card, params, batch, frames)
    assert int(dropped[0]) > 0


@pytest.mark.parametrize("batch", [1, 3])
def test_kernels_equal_plain_versions_on_fakesim_frames(card, batch):
    from ivlnce_tpu_torch.mapping import walks

    params = M.MapperParams(CameraParameters(math.radians(90.0), (256, 256),
                                             0.1), 6.4, 6.4, 0.1,
                            grid_cells=1024, window_cells=192)
    frames = walks.fakesim_walk(batch, 256, 8, seed=batch)
    _equal_plain_over(card, params, batch, frames)


def _known_loads_equal_plain(card, grid, batch, loads):
    """Each load through ``load_lanes`` (K3) and through the same host
    steps with K3's plain version, on the card: word, aux and dropped
    exactly equal after every load. Returns the kernel's state."""
    params = M.MapperParams(CameraParameters(1.2, (16, 16), 0.1), 6.4, 6.4,
                            0.1, grid_cells=grid,
                            window_cells=min(96, grid))
    kern = M.init_state(batch, grid, card)
    plain = M.init_state(batch, grid, card)
    before = S.launches.known_load
    for t, load in enumerate(loads):
        args = (torch.from_numpy(load.xyz).to(card),
                torch.from_numpy(load.sem).to(card),
                torch.from_numpy(load.counts).to(card))
        M.load_lanes(params, kern, load.lanes, *args, load.centers)
        rows, origin = M.prepare_load(params, plain, load.lanes, load.centers)
        S.known_load_plain(plain.word, plain.aux, plain.dropped, rows,
                           origin, *args, params.half_res)
        torch.cuda.synchronize()
        assert torch.equal(kern.word, plain.word), t
        assert torch.equal(kern.aux, plain.aux), t
        assert torch.equal(kern.dropped, plain.dropped), t
    assert S.launches.known_load == before + len(loads)
    return kern


EDGE_CASES = list(clouds.edge_cases())


@pytest.mark.parametrize("case", EDGE_CASES, ids=[c.name for c in EDGE_CASES])
def test_known_load_equals_plain_version_on_edge_cases(card, case):
    """K3 on the edge cases of its tiled design (``mapping/clouds.py``),
    each load into rows a first load filled."""
    kern = _known_loads_equal_plain(card, case.grid, case.batch, case.loads)
    last = case.loads[-1]
    rows = torch.as_tensor(last.lanes, device=card)
    stored = (kern.word[rows] != S.EMPTY_WORD).sum()
    if case.name in ("a lane with counts 0", "all points off the grid"):
        assert int((kern.word[0] != S.EMPTY_WORD).sum()) == 0
    elif case.name == "all points in one cell":
        assert int(stored) == 1
    else:
        assert int(stored) > 0


@pytest.mark.parametrize("lanes", [1, 3])
def test_known_load_equals_plain_version_on_val_seen_clouds(card, lanes):
    """K3 at the known-map evaluation's size: the fake val_seen scenes'
    clouds into 1 or 3 rows of G=1024, twice (the second a reload)."""
    load = clouds.val_seen_clouds(REPO, lanes)
    _known_loads_equal_plain(card, 1024, lanes, (load, load))


def test_chip_smoke_times_the_card_not_the_host(card):
    """``chip_smoke.cuda_ms`` times the card's work only: a call that
    spends 1 ms on the host before launching a small kernel times well
    under 1 ms, while the same call timed on an idle card (the spin left
    out) counts the host's millisecond."""
    import time

    import chip_smoke

    def slow_enqueue():
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 1e-3:
            pass
        torch.ones(1024, device=card).add_(1)

    assert chip_smoke.cuda_ms(slow_enqueue) < 0.5
    assert chip_smoke.cuda_ms(slow_enqueue, waits_on_card=True) >= 1.0


@pytest.mark.parametrize("k", [5, 256])
def test_instruction_lstm_equals_plain_version(card, k):
    """K5 (``models/rnn.py::bi_lstm_rows``) writes k changed rows of a
    256-row cache at 200 tokens, E 50, H 128, lengths 0-200 (0, 1 and 200
    among them), reading each token's gates from a (vocab, 8H) table:
    every feature within 2e-6 of the plain version, the other rows
    untouched."""
    from ivlnce_tpu_torch.models import rnn as R

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(0)
    lstm = torch.nn.LSTM(50, 128, bidirectional=True, batch_first=True).to(
        card)
    embedding = torch.nn.Embedding(2504, 50, padding_idx=0).to(card)
    rng = np.random.default_rng(k)
    b, t = 256, 200
    lengths = rng.integers(0, t + 1, k)
    lengths[:3] = (0, 1, t)[:k]
    tokens = np.zeros((k, t), np.int64)
    for i, n in enumerate(lengths):
        tokens[i, :n] = rng.integers(1, 2504, n)
    rows = torch.from_numpy(rng.choice(b, k, replace=False)).to(card)
    start = torch.from_numpy(rng.normal(size=(b, t, 256)).astype(
        np.float32)).to(card)
    kern, plain = start.clone(), start.clone()
    index = torch.from_numpy(tokens).to(card)
    lens = torch.from_numpy(lengths).to(card)
    before = R.launches.bi_lstm_rows
    with torch.no_grad():
        w = torch.cat([lstm.weight_ih_l0, lstm.weight_ih_l0_reverse])
        bias = torch.cat([lstm.bias_ih_l0 + lstm.bias_hh_l0,
                          lstm.bias_ih_l0_reverse + lstm.bias_hh_l0_reverse])
        table = torch.addmm(bias, embedding.weight, w.t())
        w_hh_t = torch.stack([lstm.weight_hh_l0.t(),
                              lstm.weight_hh_l0_reverse.t()])
        R.bi_lstm_rows(table, index, w_hh_t, lens, rows, kern)
        R.bi_lstm_rows_plain(table, index, w_hh_t, lens, rows, plain)
    torch.cuda.synchronize()
    assert R.launches.bi_lstm_rows == before + 1
    assert float((kern - plain).abs().max()) <= 2e-6
    others = torch.ones(b, dtype=torch.bool, device=card)
    others[rows] = False
    assert torch.equal(kern[others], start[others])
    assert (kern[rows[0]] == 0).all()  # the empty row
