"""Tests of the benchmark itself, on the CPU at a tiny size; those marked
``cuda`` run the benchmark on the card and skip without one. Run them:

    python -m pytest portbench/tests -q -p no:cacheprovider
"""

import copy
import time

import pytest
import torch

from portbench import harness

# the tiny size: 3 lanes of 64 x 64 frames, short episodes and tours, a
# 256-cell world grid, every lane compared
TINY_OPTS = {
    "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.HEIGHT": 64,
    "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.WIDTH": 64,
    "TASK_CONFIG.SIMULATOR.RGB_SENSOR.HEIGHT": 64,
    "TASK_CONFIG.SIMULATOR.RGB_SENSOR.WIDTH": 64,
    "TPU.world_grid_cells": 256,
}
TINY_TRAFFIC = {
    "lanes": 3, "pool_frames": 4, "episode_steps": [2, 4],
    "episodes_per_tour": 2, "warmup_steps": 2, "trace_steps": 2,
    "sample_lanes": 3, "check_every": 2, "trajectories": 4,
    "trajectory_steps": [3, 5], "batches": 3,
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped without a card")


def tiny_context(cell_name, seed=7, control="", fault=None, trace=False,
                 seconds=0.5):
    """A run of ``cell_name`` on the CPU at the tiny size."""
    torch.set_num_threads(2)
    cell = copy.deepcopy(harness.load("workloads", cell_name))
    config = copy.deepcopy(harness.load("configs", cell["config"]))
    config["widths"].update(depth_side=64, world_grid_cells=256, rgb_side=64)
    return harness.RunContext(
        cell=cell, config=config, seed=seed, seconds=seconds, trace=trace,
        device=torch.device("cpu"), started=time.perf_counter(),
        control=control, overrides={"opts": TINY_OPTS,
                                    "traffic": TINY_TRAFFIC},
        fault=fault)


@pytest.fixture
def tiny():
    from portbench.run import driver

    def run(cell_name, **kw):
        ctx = tiny_context(cell_name, **kw)
        return driver(ctx.cell["driver"]).run(ctx)

    return run
