"""On the card: each cell's run at its own size is correct, and its
control (TF32, and for the evals the port's bfloat16) is not. Marked
``cuda``: these skip where there is no card.

    python -m pytest portbench/tests/test_portbench_card.py -q \
        -p no:cacheprovider
"""

import json
import subprocess
import sys

import pytest

from portbench import harness

pytestmark = pytest.mark.cuda

SEEDS = (2147483659, 2147483777, 1999999973)


def _run(cell, seed, control=""):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    cmd = [sys.executable, "-m", "portbench.run", "--workload", cell,
           "--seed", str(seed), "--seconds", "5", "--trace", "0"]
    if control:
        cmd += ["--control", control]
    out = subprocess.run(cmd, cwd=harness.ROOT, capture_output=True,
                         text=True, check=True).stdout
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  harness.benchmark()["workloads"]])
def test_the_cell_is_correct(cell):
    assert _run(cell, SEEDS[0])["correct"]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell,control", [
    ("map_cma.tour_eval", "tf32"), ("map_cma.tour_eval", "bf16"),
    ("latent_cma.tour_eval", "tf32"), ("latent_cma.tour_eval", "bf16"),
    ("map_cma.train_step", "tf32"),
])
def test_the_control_is_not_correct(cell, control, seed):
    assert not _run(cell, seed, control)["correct"]


def _faulted(cell, seed, fault):
    import time

    import torch

    from portbench.run import driver

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    ctx = harness.RunContext(
        cell=harness.load("workloads", cell),
        config=harness.load("configs", harness.load("workloads",
                                                    cell)["config"]),
        seed=seed, seconds=5, trace=False, device=torch.device("cuda", 0),
        started=time.perf_counter(), fault=fault)
    out = driver(ctx.cell["driver"]).run(ctx)
    print(cell, fault.__name__, seed,
          {c.name: c.value for c in out.checks})
    return out


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("fault", ["_no_update", "_half_lanes"])
def test_a_broken_update_is_not_correct_at_the_cell_size(fault, seed):
    from portbench.tests import test_portbench_reference as faults

    assert not _faulted("map_cma.train_step", seed,
                        getattr(faults, fault)).correct
