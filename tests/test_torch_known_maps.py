"""The port's known-map mode against the JAX package's, exactly: the
plain version of the known-map load (K3) under ``load_points_into_state``,
the ``GTSemanticsKnownMapper`` transform over a sequence with scene
changes, a tour reset and a paused lane, scene-bounds grid sizing, the
known-map iterative evaluation end to end, and the preload cap's
telemetry.

Clouds and frames come from numpy seeds. Grid words, payloads, origins,
drop counts, maps, per-step actions and stats JSONs must be equal."""

import math
import os
import random

import jax
import numpy as np
import pytest
import torch

import ivlnce_tpu.mapping.obs_transforms as JOT
from ivlnce_tpu.mapping import mapper as JM
from ivlnce_tpu.mapping.camera import CameraParameters as JCamera
from ivlnce_tpu.ops.geometry import MapDims as JDims
from ivlnce_tpu_torch.mapping import clouds as TC
from ivlnce_tpu_torch.mapping import mapper as TM
from ivlnce_tpu_torch.mapping import obs_transforms as TOT
from ivlnce_tpu_torch.mapping.camera import CameraParameters as TCamera
from ivlnce_tpu_torch.ops import scatter as TS
from ivlnce_tpu_torch.ops.geometry import MapDims as TDims
from tests.test_torch_eval import (
    _configure,
    _load,
    _tiny_dataset,
)
from tests.test_torch_train import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KNOWN = "configs/fake/map_cma_eval_known.yaml"
HALF = np.float32(0.05)



def make_params(hw=16, grid=128, window=96):
    jp = JM.MapperParams(
        camera=JCamera(math.radians(79.0), (hw, hw), 0.1),
        map_height_meters=3.2, map_width_meters=3.2, resolution_meters=0.1,
        grid_cells=grid, window_cells=window, list_capacity=8192,
    )
    tp = TM.MapperParams(
        camera=TCamera(math.radians(79.0), (hw, hw), 0.1),
        map_height_meters=3.2, map_width_meters=3.2, resolution_meters=0.1,
        grid_cells=grid, window_cells=window,
    )
    return jp, tp


def make_cloud(rng, n, center=(0.0, 0.0), spread=4.0):
    """A cloud with points past a 6.4 m grid's edge, runs of equal-height
    points in one cell, and points on half-cell boundaries."""
    xyz = np.empty((n, 3), np.float32)
    xyz[:, 0] = rng.uniform(-spread, spread, n) + center[0]
    xyz[:, 2] = rng.uniform(-spread, spread, n) + center[1]
    xyz[:, 1] = rng.choice(np.float32([0.2, 0.5, 0.8, 1.1]), n)
    q = n // 4
    # half-cell boundaries (k + 1/2) h and their float32 neighbours, where
    # a division by h and a multiplication by 1/h round apart
    k = rng.integers(-40, 40, (q, 2)).astype(np.float32)
    edge = (k + np.float32(0.5)) * HALF
    step = rng.integers(-1, 2, (q, 2))
    edge = np.where(step > 0, np.nextafter(edge, np.float32(np.inf)), edge)
    edge = np.where(step < 0, np.nextafter(edge, np.float32(-np.inf)), edge)
    xyz[:q, 0], xyz[:q, 2] = edge[:, 0], edge[:, 1]
    # a line at 0.01 m spacing over few heights: many equal keys per cell
    m = n // 4
    xyz[q:q + m, 0] = np.float32(center[0]) + np.arange(m, dtype=np.float32) \
        * np.float32(0.01)
    xyz[q:q + m, 2] = np.float32(center[1] + 0.3)
    xyz[q:q + m, 1] = np.float32(0.5)
    sem = rng.integers(0, 13, n).astype(np.uint8)
    return xyz, sem


def assert_states_equal(ts, js, label=""):
    key = ts.key().numpy()
    np.testing.assert_array_equal(key, np.asarray(js.key),
                                  err_msg=f"key {label}")
    low = (ts.word & 0xFFFFFFFF).numpy()
    assert (low == TS.INCUMBENT_LOW).all(), label
    np.testing.assert_array_equal(ts.aux.numpy(),
                                  np.asarray(js.aux).view(np.int32),
                                  err_msg=f"aux {label}")
    np.testing.assert_array_equal(ts.origin, np.asarray(js.origin))
    np.testing.assert_array_equal(ts.origin_set, np.asarray(js.origin_set))
    np.testing.assert_array_equal(ts.dropped.numpy(),
                                  np.asarray(js.dropped),
                                  err_msg=f"dropped {label}")


@pytest.mark.parametrize("centred", [False, True])
def test_load_points_matches_jax(centred):
    """Load all three lanes, then lanes 0 and 2 again with new clouds:
    lane 1 keeps its first cloud, drops add up, padding beyond the counts
    (garbage here) is never read."""
    rng = np.random.default_rng(7)
    jp, tp = make_params(grid=128)
    b, n = 3, 4096
    js = JM.init_state(b, jp.grid_cells, jp.list_capacity)
    ts = TM.init_state(b, tp.grid_cells, "cpu")
    pose = np.array([[0.3, 1.25, -0.2], [1.0, 1.25, 2.0],
                     [-2.5, 1.25, 0.4]], np.float32)
    center = np.array([[0.0, 0.0], [0.5, -0.5], [-1.0, 1.0]], np.float32)
    for t, lane_mask in enumerate(([1, 1, 1], [1, 0, 1])):
        clouds = [make_cloud(rng, n, center[i]) for i in range(b)]
        xyz = np.stack([c[0] for c in clouds])
        sem = np.stack([c[1] for c in clouds])
        counts = np.array([n, 3000, 2500], np.int32)
        for i in range(b):
            xyz[i, counts[i]:] = rng.uniform(-1e3, 1e3,
                                             (n - counts[i], 3))
        mask = np.array(lane_mask, bool)
        sc = center if centred else None
        js = JM.load_points_into_state(
            jp, js, mask, xyz, sem, counts, pose,
            scene_center=None if sc is None else sc)
        TM.load_points_into_state(
            tp, ts, mask, torch.from_numpy(xyz), torch.from_numpy(sem),
            counts, pose, scene_center=sc)
        assert_states_equal(ts, js, f"load {t}")
    assert int(ts.dropped.sum()) > 0
    assert int((ts.key() != TS.EMPTY_KEY).sum()) > 1000


EDGE_CASES = list(TC.edge_cases())


@pytest.mark.parametrize("case", EDGE_CASES, ids=[c.name for c in EDGE_CASES])
def test_reloading_stale_rows_matches_jax(case):
    """K3's edge cases (``mapping/clouds.py``: a lane with counts 0, one
    cell, all off the grid, one tile, ragged grids, rows 0 and 2 of 3, N
    off the block size, a row loaded twice, EMPTY_KEY heights), each load
    into rows a first load filled, through both packages'
    ``load_points_into_state``: the port's load clears what it loads, as
    the JAX function does."""
    jp, tp = make_params(grid=case.grid, window=min(96, case.grid))
    b = case.batch
    js = JM.init_state(b, jp.grid_cells, jp.list_capacity)
    ts = TM.init_state(b, tp.grid_cells, "cpu")
    pose = np.zeros((b, 3), np.float32)
    for t, load in enumerate(case.loads):
        n = load.xyz.shape[1]
        mask = np.zeros(b, bool)
        mask[load.lanes] = True
        xyz = np.zeros((b, n, 3), np.float32)
        sem = np.zeros((b, n), np.uint8)
        counts = np.zeros(b, np.int32)
        center = np.zeros((b, 2), np.float32)
        xyz[load.lanes], sem[load.lanes] = load.xyz, load.sem
        counts[load.lanes], center[load.lanes] = load.counts, load.centers
        js = JM.load_points_into_state(jp, js, mask, xyz, sem, counts, pose,
                                       scene_center=center)
        TM.load_points_into_state(tp, ts, mask, torch.from_numpy(xyz),
                                  torch.from_numpy(sem), counts, pose,
                                  scene_center=center)
        assert_states_equal(ts, js, f"{case.name}, load {t}")


def test_known_load_wrapper_takes_the_plain_version_on_cpu():
    rng = np.random.default_rng(1)
    g = 64
    xyz, sem = make_cloud(rng, 512)
    args = (torch.tensor([1], dtype=torch.int32),
            torch.tensor([[-32, -32]], dtype=torch.int32),
            torch.from_numpy(xyz)[None], torch.from_numpy(sem)[None],
            torch.tensor([500], dtype=torch.int32), 0.05)
    a = TM.init_state(2, g, "cpu")
    b = TM.init_state(2, g, "cpu")
    before = TS.launches.known_load
    TS.known_load(a.word, a.aux, a.dropped, *args)
    TS.known_load_plain(b.word, b.aux, b.dropped, *args)
    assert TS.launches.known_load == before
    for x, y in ((a.word, b.word), (a.aux, b.aux), (a.dropped, b.dropped)):
        assert torch.equal(x, y)
    assert (a.word[0] == TS.EMPTY_WORD).all() and int(a.dropped[0]) == 0
    assert int(a.dropped[1]) > 0
    with pytest.raises(TypeError, match="xyz"):
        TS.known_load(a.word, a.aux, a.dropped, args[0], args[1],
                      args[2].double(), *args[3:])


def write_scenes(root, rng, n=3000):
    centers = {"sceneA": (0.0, 0.0), "sceneB": (1.0, -1.0),
               "sceneC": (-1.5, 0.5)}
    for name, c in centers.items():
        xyz, sem = make_cloud(rng, n, c)
        np.savez(os.path.join(root, f"{name}.npz"), xyz=xyz, semantics=sem)
    return centers


def make_transforms(maps_dir, cap=2 ** 18, scene_centers=None, hw=16,
                    jax_cls=JOT.GTSemanticsKnownMapper,
                    torch_cls=TOT.GTSemanticsKnownMapper):
    jp, tp = make_params(hw=hw)
    jt = jax_cls(jp.camera, JDims(3.2, 3.2, 0.1), grid_cells=jp.grid_cells,
                 window_cells=jp.window_cells, maps_location=maps_dir,
                 known_map_max_points=cap, scene_centers=scene_centers)
    tt = torch_cls(tp.camera, TDims(3.2, 3.2, 0.1), torch.device("cpu"),
                   grid_cells=tp.grid_cells, window_cells=tp.window_cells,
                   maps_location=maps_dir, known_map_max_points=cap,
                   scene_centers=scene_centers)
    return jt, tt


# per step: live lanes' env names, tour masks, and the live state rows
SEQUENCE = [
    (["sceneA", "sceneB", "sceneC"], [0, 0, 0], [0, 1, 2]),
    (["sceneA", "sceneB", "sceneC"], [1, 1, 1], [0, 1, 2]),
    (["sceneA", "sceneA", "sceneC"], [1, 1, 1], [0, 1, 2]),  # scene change
    (["sceneA", "sceneA", "sceneC"], [0, 1, 1], [0, 1, 2]),  # tour reset
    (["sceneA", "sceneC"], [1, 1], [0, 2]),  # lane 1 paused
    (["sceneA", "sceneB"], [1, 1], [0, 2]),  # row 2 changes scene
]


@pytest.mark.parametrize("with_centers", [False, True])
def test_known_mapper_transform_matches_jax(tmp_path, with_centers):
    rng = np.random.default_rng(3)
    centers = write_scenes(str(tmp_path), rng)
    jt, tt = make_transforms(str(tmp_path),
                             scene_centers=centers if with_centers else None)
    j_step = jax.jit(jt.make_device_step())
    t_step = tt.make_device_step()
    hw, rows_total = 16, 3
    pose = np.array([[0.0, 1.25, 0.0], [0.8, 1.25, -0.6],
                     [-1.2, 1.25, 0.7]], np.float32)
    heading = np.array([0.0, 1.1, -2.0], np.float32)
    for t, (names, masks, rows) in enumerate(SEQUENCE):
        rows = np.array(rows)
        live = {"env_name": list(names),
                "world_robot_pose": pose[rows].copy()}
        masks = np.array(masks, np.float32)
        jobs, tobs = dict(live), dict(live)
        jt.host_prepare(jobs, masks, rows=rows, num_rows=rows_total)
        before = TS.launches.known_load
        tt.host_prepare(tobs, masks, rows=rows, num_rows=rows_total)
        assert TS.launches.known_load == before  # CPU: plain version
        full = {
            "depth": np.zeros((rows_total, hw, hw, 1), np.float32),
            "world_robot_pose": np.zeros((rows_total, 3), np.float32),
            "world_robot_orientation": np.zeros((rows_total, 2), np.float32),
        }
        full["depth"][rows] = rng.uniform(0.05, 0.6, (len(rows), hw, hw, 1))
        full["world_robot_pose"][rows] = pose[rows]
        full["world_robot_orientation"][rows, 1] = heading[rows]
        if with_centers:
            assert "scene_center" in tobs
            full["scene_center"] = np.zeros((rows_total, 2), np.float32)
            full["scene_center"][rows] = tobs["scene_center"]
            np.testing.assert_array_equal(tobs["scene_center"],
                                          jobs["scene_center"])
        reset = np.zeros(rows_total, np.float32)
        reset[rows] = masks
        jstate, jocc, jsem = j_step(
            jt.state, {k: jax.numpy.asarray(v) for k, v in full.items()},
            jax.numpy.asarray(reset), {})
        jt.state = jstate
        tdev = dict(full, depth=torch.from_numpy(full["depth"]))
        tstate, tocc, tsem = t_step(tt.state, tdev, reset, None)
        tt.state = tstate
        np.testing.assert_array_equal(tocc.numpy(), np.asarray(jocc),
                                      err_msg=f"occupancy step {t}")
        np.testing.assert_array_equal(tsem.numpy(), np.asarray(jsem),
                                      err_msg=f"semantic step {t}")
        assert_states_equal(tt.state, jt.state, f"step {t}")
        pose = pose + np.array([0.1, 0.0, -0.05], np.float32)
        heading = heading + np.float32(0.3)
    assert tt._loaded_env_names == ["sceneA", "sceneA", "sceneB"]
    assert int(tt.state.dropped.sum()) > 0
    # a scene's cloud is read from disk once and kept on the device
    assert sorted(tt._known_map_cache) == ["sceneA", "sceneB", "sceneC"]
    assert tt.device_obs_keys == jt.device_obs_keys


def test_preload_cap_truncation_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    write_scenes(str(tmp_path), rng, n=3000)
    jt, tt = make_transforms(str(tmp_path), cap=1000)
    obs = {"env_name": ["sceneA", "sceneB"],
           "world_robot_pose": np.zeros((2, 3), np.float32)}
    masks = np.zeros(2, np.float32)
    jt.host_prepare(dict(obs), masks)
    tt.host_prepare(dict(obs), masks)
    assert tt.preload_truncated_count() == jt.preload_truncated_count() \
        == 4000
    assert tt.warn_if_dropped("test") == jt.warn_if_dropped("test")
    assert_states_equal(tt.state, jt.state, "capped load")
    assert all(c[2] == 1000 and c[0].shape == (1000, 3)
               for c in tt._known_map_cache.values())


def _configs(opts):
    from ivlnce_tpu.config import get_config as jax_config
    from ivlnce_tpu_torch.config import get_config as torch_config

    return jax_config(KNOWN, opts), torch_config(KNOWN, opts)


def test_scene_bounds_grid_matches_jax():
    """world_grid_cells 0: the grid sized from the fake val_seen split's
    episode geometry, lanes' grids centred on their scenes, and one GT
    iterative mapper step with scene centres equal to JAX's."""
    from ivlnce_tpu.mapping import scene_bounds as JB
    from ivlnce_tpu_torch.mapping import scene_bounds as TB
    from ivlnce_tpu_torch.run import register_all

    os.chdir(REPO)
    register_all()
    hw = 32
    opts = ["TPU.world_grid_cells", "0",
            "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.HEIGHT", str(hw),
            "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.WIDTH", str(hw)]
    jcfg, tcfg = _configs(opts)
    jc, js = JB.scene_geometry_from_dataset(jcfg.TASK_CONFIG.DATASET)
    tc, ts = TB.scene_geometry_from_dataset(tcfg.TASK_CONFIG.DATASET)
    assert tc == jc and ts == js and len(tc) == 3
    assert TB.auto_grid_cells(ts, 5.0, 0.05, 192) == JB.auto_grid_cells(
        js, 5.0, 0.05, 192)

    jt = JOT.GTSemanticsIterativeMapper.from_config(jcfg)
    tt = TOT.GTSemanticsIterativeMapper.from_config(tcfg, torch.device("cpu"))
    assert tt.params.grid_cells == jt.params.grid_cells == 512
    assert tt.scene_centers == jt.scene_centers
    assert "scene_center" in tt.device_obs_keys
    rng = np.random.default_rng(11)
    names = sorted(tc)[:2]
    obs = {"env_name": names,
           "world_robot_pose": np.array([[3.0, 1.25, -4.0],
                                         [-6.0, 1.25, 2.0]], np.float32)}
    masks = np.zeros(2, np.float32)
    jobs, tobs = dict(obs), dict(obs)
    jt.host_prepare(jobs, masks)
    tt.host_prepare(tobs, masks)
    depth = rng.uniform(0.05, 0.9, (2, hw, hw, 1)).astype(np.float32)
    sem = rng.integers(0, 13, (2, hw, hw, 1)).astype(np.uint8)
    orient = np.array([[0.0, 0.4], [0.0, -2.0]], np.float32)
    full = {"depth": depth, "semantic12": sem, "world_robot_orientation":
            orient, "world_robot_pose": obs["world_robot_pose"],
            "scene_center": tobs["scene_center"]}
    _, jocc, jsem = jax.jit(jt.make_device_step())(
        jt.state, {k: jax.numpy.asarray(v) for k, v in full.items()},
        jax.numpy.asarray(masks), {})
    _, tocc, tsem = tt.make_device_step()(
        tt.state, dict(full, depth=torch.from_numpy(depth),
                       semantic12=torch.from_numpy(sem)), masks)
    np.testing.assert_array_equal(tocc.numpy(), np.asarray(jocc))
    np.testing.assert_array_equal(tsem.numpy(), np.asarray(jsem))
    assert int(tocc.numpy().sum()) > 0
    # the grid centres on the scene, not on the robot
    centre = np.asarray(tobs["scene_center"])
    expect = np.round(centre[:, ::-1] * np.float32(20.0)).astype(np.int32) \
        - 256
    np.testing.assert_array_equal(tt.state.origin, expect)


def test_known_map_eval_matches_jax(tmp_path, one_torch_thread):
    """configs/fake/map_cma_eval_known.yaml at test size (2 lanes, 64x64
    sensors, hidden 64): the same weights on both sides, every step's
    actions identical, the stats JSONs equal, and both kernels' plain
    versions on the path."""
    import pickle

    from ivlnce_tpu.config import get_config as jax_config
    from ivlnce_tpu.utils.registry import registry as jax_registry
    from ivlnce_tpu_torch.config import get_config as torch_config
    from ivlnce_tpu_torch.models.convert import params_from_jax
    from ivlnce_tpu_torch.run import register_all
    from ivlnce_tpu_torch.utils.registry import registry as torch_registry

    import ivlnce_tpu.envs.env  # noqa: F401
    import ivlnce_tpu.models  # noqa: F401
    import ivlnce_tpu.tasks  # noqa: F401
    import ivlnce_tpu.trainers  # noqa: F401

    os.chdir(REPO)
    ds = os.path.join(str(tmp_path), "ds")
    _tiny_dataset(ds)

    def configure(config, side):
        config = _configure(config, ds, side)
        config.defrost()
        config.TPU.known_map_max_points = 16384
        config.freeze()
        return config

    jcfg = configure(jax_config(KNOWN), "jax")
    register_all()
    tcfg = configure(torch_config(KNOWN), "torch")
    info = {"depth_hw": 64, "map_hw": 64}
    jpol = jax_registry.get_policy("MapCMAPolicy").from_config(jcfg, info)
    params = jax.device_get(jpol.init_params(jax.random.PRNGKey(3)))
    with open(jcfg.EVAL_CKPT_PATH_DIR, "wb") as f:
        pickle.dump({"params": params, "config": jcfg.to_dict()}, f)
    torch.save({"state_dict": params_from_jax(params),
                "config": tcfg.to_dict()}, tcfg.EVAL_CKPT_PATH_DIR)

    actions = {"jax": [], "torch": []}
    jt = jax_registry.get_trainer(jcfg.TRAINER_NAME)(jcfg)
    j_step = jt._policy_step

    def jax_step(*args, **kwargs):
        out, batch = j_step(*args, **kwargs)
        actions["jax"].append(np.asarray(out.actions).ravel().tolist())
        return out, batch

    jt._policy_step = jax_step
    random.seed(0)
    jt.eval()

    tt = torch_registry.get_trainer(tcfg.TRAINER_NAME)(tcfg, "cpu")
    t_step = tt._policy_step

    def torch_step(*args, **kwargs):
        acts, rnn = t_step(*args, **kwargs)
        actions["torch"].append(acts.ravel().tolist())
        return acts, rnn

    tt._policy_step = torch_step
    random.seed(0)
    tt.eval()

    assert len(actions["torch"]) > 10
    assert actions["torch"] == actions["jax"]
    for pattern in ("iterative_stats_ckpt_0_val_seen.json",
                    "iterative_all_stats_ckpt_0_val_seen.json",
                    "dtw_data_ckpt_0_val_seen.json"):
        assert _load(tcfg.RESULTS_DIR, pattern) == _load(jcfg.RESULTS_DIR,
                                                         pattern), pattern
    mapper = tt.obs_transforms[0]
    assert isinstance(mapper, TOT.GTSemanticsKnownMapper)
    # the lanes' last preloaded grids, whatever the actions made of them
    jstate = jt.obs_transforms[0].state
    np.testing.assert_array_equal(mapper.state.key().numpy(),
                                  np.asarray(jstate.key))
    np.testing.assert_array_equal(mapper.state.aux.numpy(),
                                  np.asarray(jstate.aux).view(np.int32))
    assert mapper.known_map_loads == 2  # one tour per lane
    assert mapper._loaded_env_names == jt.obs_transforms[0]._loaded_env_names
    assert mapper.dropped_point_count() == \
        jt.obs_transforms[0].dropped_point_count()
