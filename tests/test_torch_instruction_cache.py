"""The eval step's per-episode instruction cache on the CPU
(``models/instruction_encoder.py::InstructionCache`` and ``RowEncoder``,
``models/rnn.py::bi_lstm_rows``): over a sequence of token batches in
which no row, one row, several rows and every row change, a lane pauses,
the lane count changes and the cache is cleared, the cached features
equal a full ``InstructionEncoder.forward`` within 1e-6, only the changed
rows are encoded, and nothing is read back from the device. The plain
``bi_lstm_rows`` equals ``bi_lstm_padded`` on the same rows. Small widths:
E 8, H 16, T 24, B 12. A trainer's IL update clears its cache: the next
step encodes every row (a tiny MapCMA trainer). The kernel against the
plain version on the card is in ``tests/test_torch_kernels.py``."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ivlnce_tpu_torch.config import get_config
from ivlnce_tpu_torch.models.instruction_encoder import (
    InstructionCache,
    InstructionEncoder,
)
from ivlnce_tpu_torch.models.rnn import bi_lstm_padded, bi_lstm_rows
from ivlnce_tpu_torch.run import register_all
from ivlnce_tpu_torch.trainers.base_trainer import BaseVLNCETrainer
from ivlnce_tpu_torch.utils import profiling
from ivlnce_tpu_torch.utils.upload import StagedUpload
from tests.test_torch_train import one_torch_thread  # noqa: F401  (autouse)

E, H, T, B = 8, 16, 24, 12
VOCAB = 30
TOL = 1e-6
SENSORS = ("instruction", "rxr_instruction")


@pytest.fixture(autouse=True)
def record_restarts():
    """A span outside any capture after each test, so the next capture's
    record starts afresh (``profiling`` restarts its tables at the first
    span under a capture after one outside it)."""
    yield
    with profiling.span("between_tests"):
        pass


def _encoder(sensor: str, seed: int = 0) -> InstructionEncoder:
    torch.manual_seed(seed)
    config = SimpleNamespace(
        rnn_type="LSTM", sensor_uuid=sensor, use_pretrained_embeddings=False,
        embedding_file="", vocab_size=VOCAB, embedding_size=E, hidden_size=H,
        bidirectional=True, final_state_only=False)
    return InstructionEncoder(config).eval()


class Cached:
    """An ``InstructionCache`` of ``encoder`` called as a step calls it,
    through a ``StagedUpload``, keeping count of its encodes and rows."""

    def __init__(self, encoder: InstructionEncoder):
        self.cache = InstructionCache(encoder)
        self.upload = StagedUpload("cpu")
        self.encodes = self.rows = 0

    def __call__(self, tokens):
        features, rows = self.cache(tokens, self.upload)
        self.encodes += rows > 0
        self.rows += rows
        return features


def _row(rng, sensor: str, length: int) -> np.ndarray:
    """One row of ``length`` non-zero tokens (or feature rows), then
    zeros."""
    if sensor == "instruction":
        row = np.zeros(T, np.int64)
        row[:length] = rng.integers(1, VOCAB, length)
    else:
        row = np.zeros((T, E), np.float32)
        row[:length] = rng.normal(size=(length, E))
    return row


def _batch(rng, sensor: str, lengths) -> np.ndarray:
    return np.stack([_row(rng, sensor, n) for n in lengths])


def _script(sensor: str):
    """(tokens, rows encoded, whether the cache is cleared first, as an IL
    update clears it) per step."""
    rng = np.random.default_rng(3)
    a = _batch(rng, sensor, rng.integers(1, T + 1, B))
    a[0] = _row(rng, sensor, T)
    one = a.copy()
    one[4] = _row(rng, sensor, 5)
    several = one.copy()
    several[0] = _row(rng, sensor, 2)  # was T long: its tail is cleared
    several[7] = _row(rng, sensor, T)
    several[9] = _row(rng, sensor, 1)
    paused = several.copy()
    paused[3] = 0  # a paused lane: all-zero tokens give zero features
    every = _batch(rng, sensor, rng.integers(1, T + 1, B))
    wider = np.concatenate([every, _batch(rng, sensor, [T, 3])])
    return [(a, B, False), (a.copy(), 0, False), (one, 1, False),
            (several, 3, False), (paused, 1, False), (every, B, False),
            (wider, B + 2, False), (wider, B + 2, True), (wider, 0, False)]


@pytest.mark.parametrize("sensor", SENSORS)
def test_cache_equals_full_encode_over_a_token_sequence(sensor):
    encoder = _encoder(sensor)
    cached = Cached(encoder)
    with torch.inference_mode():
        for i, (tokens, encoded, clear) in enumerate(_script(sensor)):
            if clear:
                cached.cache.clear()
            before = cached.rows
            got = cached(tokens)
            want = encoder({sensor: torch.from_numpy(tokens)})
            assert got.shape == want.shape == (len(tokens), 2 * H, T), i
            assert torch.allclose(got, want, rtol=0, atol=TOL), (
                i, float((got - want).abs().max()))
            assert cached.rows - before == encoded, i
            if i == 4:  # the paused lane
                assert (got[3] == 0).all()
    assert cached.encodes == 7


def _gates(lstm, x):
    w = torch.cat([lstm.weight_ih_l0, lstm.weight_ih_l0_reverse])
    b = torch.cat([lstm.bias_ih_l0 + lstm.bias_hh_l0,
                   lstm.bias_ih_l0_reverse + lstm.bias_hh_l0_reverse])
    return (torch.matmul(x, w.t()) + b).contiguous()


def test_plain_bi_lstm_rows_equals_bi_lstm_padded():
    lstm = _encoder("rxr_instruction").encoder_rnn
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(B, T, E)).astype(np.float32))
    lengths = torch.tensor([0, 1, T, 7, 12, 3, T - 1, 2, 9, 1, 16, 5])
    want, _ = bi_lstm_padded(lstm, x, lengths)
    rows = torch.tensor([3, 0, 11, 6])
    out = torch.full((B, T, 2 * H), 7.0)
    # the rows first encoded at full length, then re-encoded shorter:
    # the longer rows' tails must go
    with torch.no_grad():
        w_hh_t = torch.stack([lstm.weight_hh_l0.t(),
                              lstm.weight_hh_l0_reverse.t()])
        # gates of every (row, step), read through an index in order
        gates = _gates(lstm, x).reshape(B * T, 8 * H)
        index = torch.arange(B * T).reshape(B, T)
        bi_lstm_rows(gates, index[rows].contiguous(), w_hh_t,
                     torch.full((4,), T), rows, out)
        keep = out.clone()
        pick = torch.tensor([0, 1, 2, 4])
        tg = int(lengths[pick].max())
        bi_lstm_rows(gates, index[pick, :tg].contiguous(), w_hh_t,
                     lengths[pick], rows, out)
    assert torch.allclose(out[rows], want[pick], rtol=0, atol=TOL), float(
        (out[rows] - want[pick]).abs().max())
    assert (out[3] == 0).all()  # length 0
    assert (out[6, 12:] == 0).all() and (out[6, :12] != 0).any()
    others = torch.ones(B, dtype=torch.bool)
    others[rows] = False
    assert torch.equal(out[others], keep[others])
    assert (out[others] == 7.0).all()


def test_rows_encoded_counts_only_the_changed_rows():
    """Under a capture the counters read the rows encoded: the changed
    ones, every row after ``clear``."""
    cached = Cached(_encoder("instruction"))
    rng = np.random.default_rng(7)
    a = _batch(rng, "instruction", rng.integers(1, T + 1, B))
    b = a.copy()
    b[[2, 5]] = _batch(rng, "instruction", [4, 9])
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.inference_mode():
        cached(a)
        with torch.profiler.profile(activities=acts):
            cached(b)
            cached(b)
        # rows 2 and 5: their 9 tokens, rows and lengths staged as int64
        assert profiling.traced()["counts"] == {
            "instruction_rows_encoded": 2, "instruction_rows_changed": 2,
            "upload_bytes_staged": 8 * (2 * 9 + 2 + 2)}
        cached.cache.clear()
        cached(b)
    assert (cached.encodes, cached.rows) == (3, B + 2 + B)


def test_no_device_sync_inside_the_instruction_cache():
    """The lengths come from the host tokens: no blocking read."""
    cached = Cached(_encoder("instruction"))
    rng = np.random.default_rng(9)
    a = _batch(rng, "instruction", rng.integers(0, T + 1, B))
    b = a.copy()
    b[1] = _row(rng, "instruction", 6)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.inference_mode(), torch.profiler.profile(activities=acts):
        cached(a)
        cached(b)
    host_us = profiling.traced()["host_us"]
    assert {"instruction_cache", "instruction_encoder",
            "upload"} <= set(host_us)
    assert "device_sync" not in host_us


def test_tokens_outside_the_vocabulary_are_refused():
    """The kernel reads each token's gates by its id: an id outside the
    table is refused on the host, before any upload."""
    cached = Cached(_encoder("instruction"))
    tokens = _batch(np.random.default_rng(11), "instruction", [3] * B)
    tokens[2, 1] = VOCAB
    with torch.inference_mode(), pytest.raises(ValueError, match="vocab"):
        cached(tokens)


def test_an_il_update_makes_the_next_step_encode_every_row(tmp_path):
    """A tiny MapCMA trainer's steps encode every lane once, then none for
    the same tokens; after ``_update_agent`` the next step encodes every
    lane again, with nothing cleared by the caller."""
    from tests.test_torch_spans import _batch
    from tests.test_torch_train import _train_batch

    register_all()
    opts = ["TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.HEIGHT", 64,
            "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.WIDTH", 64,
            "TASK_CONFIG.SIMULATOR.RGB_SENSOR.HEIGHT", 64,
            "TASK_CONFIG.SIMULATOR.RGB_SENSOR.WIDTH", 64,
            "MODEL.STATE_ENCODER.hidden_size", 64,
            "MODEL.SEMANTIC_MAP_ENCODER.channels", 8,
            "TPU.world_grid_cells", 256, "NUM_ENVIRONMENTS", 3,
            "CHECKPOINT_FOLDER", str(tmp_path / "ckpts"),
            "RESULTS_DIR", str(tmp_path / "results")]
    config = get_config("configs/fake/map_cma_eval_iterative.yaml", opts)
    trainer = BaseVLNCETrainer(config, "cpu")
    trainer._setup_obs_transforms(config)
    trainer._initialize_training(config)
    batch = _batch(np.random.default_rng(13))
    lanes = len(batch["depth"])
    ones = np.ones((lanes, 1), np.uint8)
    rnn = trainer.policy.initial_rnn_states(lanes, "cpu")
    prev = np.zeros((lanes, 1), np.int64)

    def rows_encoded():
        before = trainer.instruction_rows_encoded
        with torch.inference_mode():
            trainer._policy_step(batch, ones, rnn, prev, (ones,) * 4)
        return trainer.instruction_rows_encoded - before

    assert [rows_encoded(), rows_encoded()] == [lanes, 0]
    # the step's obs carry the cached features in place of the tokens
    with torch.inference_mode():
        obs = trainer._wire_device_obs(batch, trainer.obs_transforms[0])
    assert "instruction" not in obs
    assert obs["instruction_features"].shape == (
        lanes, 2 * config.MODEL.INSTRUCTION_ENCODER.hidden_size,
        batch["instruction"].shape[1])
    trainer._update_agent(*_train_batch(trainer.policy, (2, 2)))
    assert [rows_encoded(), rows_encoded()] == [lanes, 0]
    assert trainer.instruction_encodes == 2
