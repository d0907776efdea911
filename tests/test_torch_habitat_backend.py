"""The port's habitat-sim adapter (``envs/habitat_backend.py``) against the
JAX package's, over the stubbed ``habitat_sim`` modules of
``tests/test_habitat_trace_replay.py`` and ``tests/test_habitat_backend.py``:
the replayed trace (``data/fixtures/habitat_trace.npz``) gives equal
observations, collision flags and agent states through both, and both
packages' ``make_sim`` pick the adapter exactly when ``habitat_sim``
imports."""

import json
import sys

import numpy as np
import pytest

from ivlnce_tpu.config.task_default import get_extended_config as jax_task
from ivlnce_tpu.envs import env as jax_env
from ivlnce_tpu.envs import fake_sim as jax_fake_sim
from ivlnce_tpu.envs import habitat_backend as jax_backend
from ivlnce_tpu_torch.config.task_default import (
    get_extended_config as torch_task,
)
from ivlnce_tpu_torch.envs import env as torch_env
from ivlnce_tpu_torch.envs import fake_sim as torch_fake_sim
from ivlnce_tpu_torch.envs import habitat_backend as torch_backend
from tests.test_habitat_backend import _install_mock_habitat_sim
from tests.test_habitat_trace_replay import (  # noqa: F401 (a fixture)
    _install_trace_habitat_sim,
    trace,
)
from tests.test_torch_train import one_torch_thread  # noqa: F401  (autouse)

SIDES = {
    "jax": (jax_task, jax_env, jax_fake_sim, jax_backend),
    "torch": (torch_task, torch_env, torch_fake_sim, torch_backend),
}
SENSORS = ["RGB_SENSOR", "DEPTH_SENSOR", "SEMANTIC_SENSOR"]


def _sim_config(side):
    cfg = SIDES[side][0]()
    cfg.defrost()
    cfg.SIMULATOR.AGENT_0.SENSORS = list(SENSORS)
    cfg.freeze()
    return cfg


def _adapters(scene):
    return {side: SIDES[side][3].HabitatSimAdapter(
        _sim_config(side).SIMULATOR, scene) for side in SIDES}


def _assert_obs_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _state(adapter):
    s = adapter.get_agent_state()
    return np.asarray(s.position, np.float64), np.asarray(s.rotation)


@pytest.mark.parametrize("frame_idx", [0, 1])
def test_replayed_observations_match_jax(monkeypatch, trace, frame_idx):
    _install_trace_habitat_sim(monkeypatch, trace, frame_idx)
    adapters = _adapters("trace_scene")
    obs = {side: a.reset() for side, a in adapters.items()}
    _assert_obs_equal(obs["torch"], obs["jax"])
    np.testing.assert_array_equal(obs["torch"]["semantic12"][..., 0],
                                  trace["sem_expected"][frame_idx])


def test_replayed_collisions_and_states_match_jax(monkeypatch, trace):
    """The trace's step script (collided flags, blocked moves, STOPs)
    through both adapters: the same collision record and agent state
    after every step."""
    _install_trace_habitat_sim(monkeypatch, trace, 0)
    import habitat_sim as hsim_mock

    steps = json.loads(str(trace["collision_steps"]))

    class _CollisionSim(hsim_mock.Simulator):
        def __init__(self, configuration):
            super().__init__(configuration)
            self.cursor = -1

        def step(self, action):
            self.cursor += 1
            case = steps[self.cursor]
            s = self._agent.get_state()
            s.position = np.asarray(s.position, np.float64) + np.array(
                [0.0, 0.0, -float(case["moved"])])
            self._agent.set_state(s)
            raw = dict(self.get_sensor_observations())
            if case["collided"] is not None:
                raw["collided"] = case["collided"]
            return raw

    monkeypatch.setattr(hsim_mock, "Simulator", _CollisionSim)
    adapters = _adapters("trace_scene")
    record = {side: [] for side in adapters}
    for side, adapter in adapters.items():
        for case in steps:
            if case["action"] == 0:  # STOP never reaches the sim's step()
                adapter._sim.cursor += 1
            obs = adapter.step(case["action"])
            record[side].append(
                (adapter.previous_step_collided, *_state(adapter), obs))
    assert [r[0] for r in record["torch"]] == [c["expected"] for c in steps]
    for got, want in zip(record["torch"], record["jax"]):
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
        _assert_obs_equal(got[3], want[3])


def test_navmesh_walk_matches_jax(monkeypatch):
    """The mock navmesh: teleport, waypoint queries and a follower's walk
    to a goal give the same actions and states through both adapters."""
    _install_mock_habitat_sim(monkeypatch)
    from ivlnce_tpu.envs.shortest_path import ShortestPathFollower as JaxSPF
    from ivlnce_tpu_torch.envs.shortest_path import (
        ShortestPathFollower as TorchSPF,
    )

    adapters = _adapters("scene_a")
    walks = {}
    for side, follower_cls in (("jax", JaxSPF), ("torch", TorchSPF)):
        adapter = adapters[side]
        adapter.set_agent_state([0.0, 0.0, 0.0], [0, 0, 0, 1])
        follower = follower_cls(adapter, goal_radius=0.25)
        goal = [1.5, 0.0, 2.5]
        walk = [(adapter.geodesic_distance([0.0, 0.0, 0.0], goal),
                 adapter.get_straight_shortest_path_points([0, 0, 0], goal))]
        for _ in range(120):
            action = follower.get_next_action(goal)
            walk.append((action, *_state(adapter)))
            if action == 0:
                break
            adapter.step(action)
        walks[side] = walk
    assert walks["torch"][-1][0] == 0  # reached the goal
    assert len(walks["torch"]) == len(walks["jax"])
    assert walks["torch"][0][0] == walks["jax"][0][0]
    np.testing.assert_array_equal(np.asarray(walks["torch"][0][1]),
                                  np.asarray(walks["jax"][0][1]))
    for got, want in zip(walks["torch"][1:], walks["jax"][1:]):
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_make_sim_returns_the_adapter_when_habitat_sim_imports(
        monkeypatch, side):
    _install_mock_habitat_sim(monkeypatch)
    _, env, _, backend = SIDES[side]
    sim = env.make_sim(_sim_config(side), "scene_a")
    assert type(sim) is backend.HabitatSimAdapter


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_make_sim_falls_back_to_fakesim_without_habitat_sim(
        monkeypatch, side):
    monkeypatch.setitem(sys.modules, "habitat_sim", None)
    _, env, fake_sim, _ = SIDES[side]
    sim = env.make_sim(_sim_config(side), "scene_a")
    assert type(sim) is fake_sim.FakeSim
