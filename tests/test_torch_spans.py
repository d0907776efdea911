"""The port's spans at the host boundaries of a policy step and its
instruction counters (``utils/profiling.py``,
``trainers/base_trainer.py``, ``models/instruction_encoder.py``): one
``_policy_step`` of a tiny MapCMA trainer under ``torch.profiler`` holds
``host_prepare``, ``wire_obs``, ``upload``, ``instruction_cache`` and
``device_sync`` inside its one ``policy_step`` range, and a scripted
token sequence through the trainer's ``InstructionCache`` gives exact
counts of the rows encoded, which are the rows whose tokens changed."""

import numpy as np
import pytest
import torch

from ivlnce_tpu_torch.config import get_config
from ivlnce_tpu_torch.run import register_all
from ivlnce_tpu_torch.trainers.base_trainer import BaseVLNCETrainer
from ivlnce_tpu_torch.utils import profiling

CONFIG = "configs/fake/map_cma_eval_iterative.yaml"
LANES = 3
INPUT_SPANS = ("host_prepare", "wire_obs", "upload", "instruction_cache",
               "device_sync")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def trainer(tmp_path_factory):
    """A MapCMA trainer with the GT-semantics mapper at 64² sensors."""
    register_all()
    root = tmp_path_factory.mktemp("spans")
    opts = ["TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.HEIGHT", 64,
            "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.WIDTH", 64,
            "TASK_CONFIG.SIMULATOR.RGB_SENSOR.HEIGHT", 64,
            "TASK_CONFIG.SIMULATOR.RGB_SENSOR.WIDTH", 64,
            "MODEL.STATE_ENCODER.hidden_size", 64,
            "TPU.world_grid_cells", 256, "NUM_ENVIRONMENTS", LANES,
            "CHECKPOINT_FOLDER", str(root / "ckpts"),
            "RESULTS_DIR", str(root / "results")]
    config = get_config(CONFIG, opts)
    t = BaseVLNCETrainer(config, "cpu")
    t._setup_obs_transforms(config)
    t._initialize_policy(config, None)
    return t


def _tokens(rng, rows=LANES, length=12):
    tok = rng.integers(1, 30, (rows, length)).astype(np.int64)
    tok[0, 7:] = 0
    return tok


def _batch(rng):
    return {
        "depth": rng.random((LANES, 64, 64, 1), dtype=np.float32),
        "semantic12": rng.integers(0, 13, (LANES, 64, 64, 1), np.uint8),
        "world_robot_pose": np.stack(
            [rng.random(LANES), np.full(LANES, 1.25), rng.random(LANES)], 1),
        "world_robot_orientation": np.stack(
            [np.zeros(LANES), rng.random(LANES)], 1),
        "instruction": _tokens(rng),
    }


def _ranges(prof, name):
    return [(e.time_range.start, e.time_range.end)
            for e in prof.events() if e.name == name]


def test_policy_step_spans_inside_one_policy_step(trainer):
    rng = np.random.default_rng(0)
    trainer.instruction_cache.clear()
    start = (trainer.instruction_encodes, trainer.instruction_rows_encoded)
    rnn = trainer.policy.initial_rnn_states(LANES, "cpu")
    prev = np.zeros((LANES, 1), np.int64)
    ones = np.ones((LANES, 1), np.uint8)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.inference_mode(), \
            torch.profiler.profile(activities=acts) as prof:
        actions, _ = trainer._policy_step(
            _batch(rng), ones * 0, rnn, prev, (ones, ones, ones * 0, ones))
    assert actions.shape == (LANES, 1)
    # the trainer's own counts: one encode of every lane
    assert (trainer.instruction_encodes - start[0],
            trainer.instruction_rows_encoded - start[1]) == (1, LANES)
    (step,) = _ranges(prof, "policy_step")
    for name in INPUT_SPANS + ("instruction_encoder", "mapper"):
        found = _ranges(prof, name)
        assert found, name
        assert all(step[0] <= s and e <= step[1] for s, e in found), name
    # the uploads: the wire obs, the tokens with their rows and lengths,
    # the masks and previous actions
    assert len(_ranges(prof, "upload")) == 3
    # the actions' readback alone: the bi-LSTM's lengths come from the
    # host tokens
    syncs = _ranges(prof, "device_sync")
    (encoder,) = _ranges(prof, "instruction_encoder")
    (cache,) = _ranges(prof, "instruction_cache")
    assert len(syncs) == 1
    assert not any(cache[0] <= s and e <= cache[1] for s, e in syncs)
    assert cache[0] <= encoder[0] and encoder[1] <= cache[1]
    got = profiling.traced()
    rows = {k: got["counts"][k] for k in ("instruction_rows_encoded",
                                          "instruction_rows_changed")}
    assert rows == {"instruction_rows_encoded": LANES,
                    "instruction_rows_changed": LANES}
    # the step's copies go through its arena (tests/test_torch_staged_upload.py
    # counts their bytes)
    assert got["counts"]["upload_bytes_staged"] > 0
    assert got["host_us"]["policy_step"] >= got["host_us"]["upload"] > 0


def test_instruction_row_counts_on_scripted_tokens(trainer):
    """Rows are counted at each encode only: the changed rows, those that
    differ from the cached tokens (all of them with no cache, or when the
    lane count changes), are the rows encoded."""
    rng = np.random.default_rng(1)
    cache = trainer.instruction_cache
    cache.clear()
    a = _tokens(rng)
    b = a.copy()
    b[1, 3] = b[1, 3] % 29 + 1  # one lane's new episode
    c = b.copy()
    c[0, 0] = c[0, 0] % 29 + 1
    c[2, 11] = c[2, 11] % 29 + 1  # two lanes' new episodes
    d = np.concatenate([c, c[:1]])  # a fourth lane
    # (tokens, rows encoded) per step
    script = [(a, 3), (a.copy(), 0), (b, 1), (b, 0), (c, 2), (d, 4), (d, 0)]
    acts = [torch.profiler.ProfilerActivity.CPU]
    encodes = rows = 0
    with torch.inference_mode():
        for i, (tokens, encoded) in enumerate(script):
            if i == 2:
                prof = torch.profiler.profile(activities=acts)
                prof.start()
            features, got = cache(tokens, trainer._upload)
            assert features.shape[::2] == (len(tokens), 12), i
            assert got == encoded, i
            encodes, rows = encodes + (got > 0), rows + got
        prof.stop()
    assert (encodes, rows) == (4, 10)
    # under the capture (steps 2 to 6): 1 + 2 + 4 rows changed and encoded,
    # each encode staging its rows' 12 tokens, rows and lengths as int64
    assert profiling.traced()["counts"] == {
        "instruction_rows_encoded": 7, "instruction_rows_changed": 7,
        "upload_bytes_staged": 8 * ((12 + 2) * 1 + (12 + 2) * 2
                                    + (12 + 2) * 4)}
    # the weights changed (an IL update): the next step re-encodes all
    cache.clear()
    assert cache(d, trainer._upload)[1] == 4
