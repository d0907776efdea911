"""The eval step's staged upload (``utils/upload.py::StagedUpload``, used
by ``trainers/base_trainer.py::_step_inputs``, ``RowEncoder`` and the
mapper's ``step_inputs``) on the CPU: every array a step stages reaches
the device with the dtype, shape and bytes of
``torch.from_numpy(a).to(device)``, and each step's actions, logits,
recurrent states and maps equal, bit for bit, those of the same step with
every copy blocking, for a MapCMA step with ground-truth and with
predicted semantics, a LatentCMA step, changed instruction rows, an RxR
step, a paused lane, a new lane count and consecutive steps; the two byte
counters under a capture. Tiny sizes: 64² sensors, hidden 64, 3 lanes.

The test marked ``cuda`` traces 20 steps of a small MapCMA eval on the
card: no pageable host-to-device copy and no stream synchronisation
before the actions' readback, and 50 steps equal to the blocking path.
Run it on a machine with an NVIDIA GPU:

    python -m pytest tests/test_torch_staged_upload.py -q --noconftest
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from ivlnce_tpu_torch.config import get_config
from ivlnce_tpu_torch.run import register_all
from ivlnce_tpu_torch.trainers.base_trainer import BaseVLNCETrainer
from ivlnce_tpu_torch.utils import profiling, upload
from ivlnce_tpu_torch.utils.upload import ALIGN, StagedUpload

MAP_CONFIG = "configs/fake/map_cma_eval_iterative.yaml"
RXR_CONFIG = "configs/fake/rxr_eval.yaml"
LANES = 3
HW = 64
SMALL = {"TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.HEIGHT": HW,
         "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.WIDTH": HW,
         "TASK_CONFIG.SIMULATOR.RGB_SENSOR.HEIGHT": HW,
         "TASK_CONFIG.SIMULATOR.RGB_SENSOR.WIDTH": HW,
         "MODEL.STATE_ENCODER.hidden_size": 64,
         "TPU.world_grid_cells": 256}
LATENT = {"MODEL.policy_name": "LatentCMAPolicy",
          "MODEL.tour_memory_variant": True, "MODEL.memory_at_end": True,
          "RL.POLICY.OBS_TRANSFORMS.ENABLED_TRANSFORMS": []}
KINDS = {
    "map": (MAP_CONFIG, {}),
    "predicted": (MAP_CONFIG, {"RL.POLICY.OBS_TRANSFORMS.ENABLED_TRANSFORMS":
                               ["PredictedSemanticsIterativeMapper"]}),
    "latent": (MAP_CONFIG, LATENT),
    "rxr": (RXR_CONFIG, {}),
}
RXR_TOKENS, RXR_FEATURES = 16, 768


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def record_restarts():
    """A span outside any capture after each test, so the next capture's
    record starts afresh."""
    yield
    with profiling.span("between_tests"):
        pass


def _trainer(root, kind: str, device: str = "cpu",
             lanes: int = LANES) -> BaseVLNCETrainer:
    register_all()
    path, extra = KINDS[kind]
    opts = {**SMALL, **extra, "NUM_ENVIRONMENTS": lanes,
            "CHECKPOINT_FOLDER": str(root / "ckpts"),
            "RESULTS_DIR": str(root / "results")}
    flat = [x for kv in opts.items() for x in kv]
    config = get_config(path, flat)
    t = BaseVLNCETrainer(config, device)
    t._setup_obs_transforms(config)
    t._initialize_policy(config, None)
    return t


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    """One trainer per kind, built at first use."""
    made = {}

    def get(kind):
        if kind not in made:
            made[kind] = _trainer(tmp_path_factory.mktemp(kind), kind)
        return made[kind]

    return get


def _tokens(rng, lanes):
    tok = np.zeros((lanes, 20), np.int64)
    for i, n in enumerate(rng.integers(3, 21, lanes)):
        tok[i, :n] = rng.integers(1, 30, n)
    return tok


def _batches(kind: str, steps: int, lanes: int = LANES, seed: int = 0):
    """``steps`` host batches of ``lanes`` lanes; every third step one
    lane's instruction changes."""
    rng = np.random.default_rng(seed)
    tokens = _tokens(rng, lanes)
    rxr = rng.normal(size=(lanes, RXR_TOKENS, RXR_FEATURES)).astype(
        np.float32)
    rxr[:, 12:] = 0
    out = []
    for s in range(steps):
        if s and s % 3 == 0:
            i = s % lanes
            tokens = tokens.copy()
            tokens[i] = _tokens(rng, 1)[0]
            rxr = rxr.copy()
            rxr[i, :5 + s % 7] = rng.normal(size=(5 + s % 7, RXR_FEATURES))
        batch = {"depth": rng.random((lanes, HW, HW, 1), dtype=np.float32)}
        if kind == "map":
            batch["semantic12"] = rng.integers(0, 13, (lanes, HW, HW, 1),
                                               np.uint8)
        else:
            batch["rgb"] = rng.integers(0, 256, (lanes, HW, HW, 3), np.uint8)
        if kind in ("map", "predicted"):
            batch["world_robot_pose"] = np.stack(
                [rng.random(lanes), np.full(lanes, 1.25), rng.random(lanes)],
                1).astype(np.float32)
            batch["world_robot_orientation"] = np.stack(
                [np.zeros(lanes), rng.random(lanes)], 1).astype(np.float32)
        if kind == "rxr":
            batch["rxr_instruction"] = rxr
        else:
            batch["instruction"] = tokens
        out.append(batch)
    return out


def _fresh(trainer) -> None:
    """Forget every lane: no cached instruction, no map, no lane map."""
    trainer.instruction_cache.clear()
    trainer._lane_rows = None
    for t in trainer.obs_transforms:
        t.reset()


def _run(trainer, kind, batches, pause_after=None):
    """The steps of ``batches`` from fresh lanes: each step's actions,
    logits, recurrent states and, with a mapper, maps on the host. Every
    lane starts an episode and a tour at step 0; with ``pause_after``,
    lane 1 pauses after that step."""
    _fresh(trainer)
    iterative = kind != "rxr"
    name = "act_iterative" if iterative else "act"
    act = getattr(trainer.policy, name)
    outs = []

    def kept(*a, **k):
        outs.append(act(*a, **k))
        return outs[-1]

    setattr(trainer.policy, name, kept)
    try:
        lanes = len(batches[0]["depth"])
        rnn = trainer.policy.initial_rnn_states(lanes, trainer.device)
        prev = np.zeros((lanes, 1), np.int64)
        got = []
        for s, batch in enumerate(batches):
            live = trainer._lane_rows if trainer._lane_rows is not None \
                else np.arange(lanes)
            batch = {k: v[live] for k, v in batch.items()}
            start = np.full((len(live), 1), int(s > 0), np.uint8)
            ones = np.ones_like(start)
            masks = (start, start, start, ones) if iterative else (start,)
            with torch.inference_mode():
                actions, rnn = trainer._policy_step(
                    batch, start, rnn, prev[live], masks,
                    iterative=iterative, need_maps=True)
                step = {"actions": actions, "rnn": rnn.cpu().numpy(),
                        "logits": outs[-1].logits.cpu().numpy()}
                if trainer._pending_maps is not None:
                    occ, sem, _ = trainer._pending_maps
                    step["maps"] = (occ.cpu().numpy(), sem.cpu().numpy())
            got.append(step)
            prev[live] = actions
            if s == pause_after:
                trainer._pause_lane(1)
        return got
    finally:
        delattr(trainer.policy, name)


def _recorder(monkeypatch):
    """Every staged call's host arrays (copied at the call) and what it
    handed back (cloned at the call)."""
    calls = []
    staged = StagedUpload.__call__

    def call(self, arrays):
        host = {k: np.array(v) for k, v in arrays.items()}
        out = staged(self, arrays)
        calls.append((host, {k: v.clone() for k, v in out.items()}))
        return out

    monkeypatch.setattr(StagedUpload, "__call__", call)
    return calls


def _every_copy_blocking(monkeypatch):
    monkeypatch.setattr(StagedUpload, "__call__",
                        lambda self, arrays: upload.blocking(arrays,
                                                             self.device))


def _bytes(t: torch.Tensor) -> bytes:
    return t.cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def _check_staged(calls, device="cpu"):
    """Each staged array as the plain copy gives it."""
    assert calls
    for host, got in calls:
        assert set(host) == set(got)
        for k, a in host.items():
            want = torch.from_numpy(np.ascontiguousarray(a)).to(device)
            want = want.reshape(a.shape)  # a 0-d array stays 0-d
            assert got[k].dtype == want.dtype, k
            assert got[k].shape == want.shape, k
            assert _bytes(got[k]) == _bytes(want), k


def _check_equal(staged, blocking):
    assert len(staged) == len(blocking)
    for s, (a, b) in enumerate(zip(staged, blocking)):
        assert set(a) == set(b)
        for k in a:
            for x, y in zip(*((a[k], b[k]) if k == "maps"
                              else ((a[k],), (b[k],)))):
                assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), (
                    s, k)


def _compare(trainer, kind, batches, monkeypatch, **kw):
    """Run ``batches`` staged and recorded, then with every copy
    blocking; returns the staged calls."""
    calls = _recorder(monkeypatch)
    staged = _run(trainer, kind, batches, **kw)
    monkeypatch.undo()
    _every_copy_blocking(monkeypatch)
    blocking = _run(trainer, kind, batches, **kw)
    monkeypatch.undo()
    _check_staged(calls)
    _check_equal(staged, blocking)
    return calls


# -- the helper alone ---------------------------------------------------------

def test_views_have_the_plain_copys_dtype_shape_and_bytes():
    rng = np.random.default_rng(0)
    up = StagedUpload("cpu")
    up.begin_step()
    arrays = {
        "u16": rng.integers(0, 65535, (3, 5, 7, 1), np.uint16),
        "u8": rng.integers(0, 255, (3, 4, 4, 3), np.uint8),
        "f32": rng.random((3, 14), dtype=np.float32),
        "i64": rng.integers(-9, 9, (11,)),
        "i32": rng.integers(-9, 9, (3, 2)).astype(np.int32),
        "bool": rng.random(5) > 0.5,
        "f64": np.float64(2.5),
        "empty": np.zeros((0, 4), np.float32),
        "strided": rng.random((6, 8), dtype=np.float32)[::2, 1::3],
        "reversed": np.arange(9, dtype=np.int16)[::-1],
        "readonly": np.broadcast_to(np.arange(4, dtype=np.float32), (2, 4)),
        # large enough for torch's copy to run on several threads
        "large": rng.integers(0, 65535, (5, 333, 1001), np.uint16),
        "large_strided": rng.random((2, 700, 1000))[:, ::2],
    }
    got = up(arrays)
    _check_staged([(arrays, got)])
    base = got["u16"].untyped_storage().data_ptr()
    for k, t in got.items():
        if t.numel():
            assert (t.data_ptr() - base) % ALIGN == 0, k
        assert t.untyped_storage().data_ptr() == base, k


def test_consecutive_steps_take_the_two_arenas_in_turn():
    """Step 1 and step 3 share an arena, step 2 has the other; a step's
    views hold until the second step after it, with nothing left of the
    frames before."""
    rng = np.random.default_rng(1)
    up = StagedUpload("cpu")
    frames = [rng.integers(0, 65535, (3, 8, 8), np.uint16) for _ in range(3)]
    views = []
    for f in frames:
        up.begin_step()
        views.append(up({"depth": f, "masks": (f[:, 0, :1] % 2).astype(
            np.float32)}))
    storage = [v["depth"].untyped_storage().data_ptr() for v in views]
    assert storage[0] == storage[2] != storage[1]
    assert torch.equal(views[1]["depth"], torch.from_numpy(frames[1]))
    assert torch.equal(views[2]["depth"], torch.from_numpy(frames[2]))
    # step 1's arena now holds step 3's frames
    assert torch.equal(views[0]["depth"], torch.from_numpy(frames[2]))


def test_an_arena_grows_and_keeps_what_it_handed_out():
    """A second call that does not fit moves the arena; the first call's
    views stay valid, and the next use of the arena fits the whole
    step."""
    up = StagedUpload("cpu")
    up.begin_step()
    a = up({"a": np.arange(100, dtype=np.int64)})
    arenas = up._arenas[up._turn]
    first = arenas.capacity
    b = up({"b": np.arange(1000, dtype=np.float32)})
    assert arenas.capacity >= 2 * first
    assert torch.equal(a["a"], torch.arange(100))
    assert torch.equal(b["b"], torch.arange(1000, dtype=torch.float32))
    grown = arenas.capacity
    for _ in range(2):  # both arenas, then the first again
        up.begin_step()
        up({"a": np.arange(100, dtype=np.int64)})
        up({"b": np.arange(1000, dtype=np.float32)})
    assert arenas.capacity == grown


# -- the eval step -----------------------------------------------------------

def test_a_map_cma_step_stages_every_copy(trainers, monkeypatch):
    """Frames, changed rows, masks and previous actions, the cleared
    lanes and the mapper's per-lane inputs, in one copy each."""
    t = trainers("map")
    calls = _compare(t, "map", _batches("map", 4), monkeypatch)
    keys = [sorted(host) for host, _ in calls]
    masks = ["mask0", "mask1", "mask2", "mask3", "prev"]
    mapper = ["lane_acc", "lane_ras", "origin", "start"]
    # step 0: every lane starts (its grid cleared) and every row encodes
    assert keys[:5] == [["depth", "semantic12"], ["ints"], masks,
                        ["lanes"], mapper]
    # step 1: nothing changed but the frames
    assert keys[5:8] == [["depth", "semantic12"], masks, mapper]
    assert calls[0][0]["depth"].dtype == np.uint16


def test_a_predicted_semantics_step(trainers, monkeypatch):
    calls = _compare(trainers("predicted"), "predicted",
                     _batches("predicted", 2), monkeypatch)
    assert sorted(calls[0][0]) == ["depth", "rgb"]


def test_a_latent_cma_step(trainers, monkeypatch):
    calls = _compare(trainers("latent"), "latent", _batches("latent", 4),
                     monkeypatch)
    assert [sorted(h) for h, _ in calls[:3]] == [
        ["depth", "rgb"], ["ints"],
        ["mask0", "mask1", "mask2", "mask3", "prev"]]


def test_changed_instruction_rows(trainers, monkeypatch):
    """Steps 3 and 6 change one lane's tokens: one row encoded each."""
    calls = _compare(trainers("map"), "map", _batches("map", 7),
                     monkeypatch)
    rows = [h["ints"] for h, _ in calls if "ints" in h]
    assert len(rows) == 3
    tokens = _batches("map", 7)
    for ints, s in zip(rows[1:], (3, 6)):
        row = tokens[s]["instruction"][s % LANES]
        n = int((row != 0).sum())
        assert list(ints[n:]) == [s % LANES, n]
        assert list(ints[:n]) == list(row[:n])


def test_an_rxr_step(trainers, monkeypatch):
    """RxR's features and the rows' integers in one copy."""
    calls = _compare(trainers("rxr"), "rxr", _batches("rxr", 4),
                     monkeypatch)
    encodes = [h for h, _ in calls if "ints" in h]
    assert len(encodes) == 2 and all(set(h) == {"ints", "cut"}
                                     for h in encodes)
    assert encodes[0]["cut"].shape == (LANES, 12, RXR_FEATURES)


def test_a_step_after_a_paused_lane(trainers, monkeypatch):
    """Lane 1 pauses after step 1: the staged arrays are full-width, the
    paused row filled."""
    calls = _compare(trainers("map"), "map", _batches("map", 4),
                     monkeypatch, pause_after=1)
    last = [h for h, _ in calls if "prev" in h][-1]
    assert last["mask0"].shape == (LANES, 1) and last["mask0"][1, 0] == 0
    assert [h for h, _ in calls if "depth" in h][-1]["depth"].shape[0] == LANES


def test_a_new_lane_count_grows_the_arenas(trainers, monkeypatch):
    t = trainers("map")
    _run(t, "map", _batches("map", 2))
    before = [a.capacity for a in t._upload._arenas]
    _compare(t, "map", _batches("map", 3, lanes=LANES + 3), monkeypatch)
    after = [a.capacity for a in t._upload._arenas]
    assert all(x > y for x, y in zip(after, before))


def test_consecutive_policy_steps_alternate_arenas(trainers, monkeypatch):
    t = trainers("map")
    calls = _recorder(monkeypatch)
    views = []
    staged = StagedUpload.__call__

    def keep(self, arrays):
        out = staged(self, arrays)
        if "depth" in arrays:
            views.append(out["depth"])
        return out

    monkeypatch.setattr(StagedUpload, "__call__", keep)
    batches = _batches("map", 3, seed=5)
    _run(t, "map", batches)
    storage = [v.untyped_storage().data_ptr() for v in views]
    assert storage[0] == storage[2] != storage[1]
    assert len(calls) > 3
    # step 2's frames, still held, and step 3's: exactly their own
    for s in (1, 2):
        want = (np.clip(batches[s]["depth"], 0, 1) * 65535 + 0.5).astype(
            np.uint16)
        assert torch.equal(views[s], torch.from_numpy(want))


def test_the_byte_counters_under_a_capture(trainers, monkeypatch):
    t = trainers("map")
    batches = _batches("map", 3, seed=2)
    _run(t, "map", batches[:1])  # the pixel rays' one upload
    calls = _recorder(monkeypatch)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts):
        _run(t, "map", batches)
    counts = profiling.traced()["counts"]
    staged = sum(a.nbytes for host, _ in calls for a in host.values())
    assert counts["upload_bytes_staged"] == staged
    assert "upload_bytes_blocking" not in counts
    monkeypatch.undo()
    _every_copy_blocking(monkeypatch)
    with profiling.span("between_captures"):  # the record restarts
        pass
    with torch.profiler.profile(activities=acts):
        _run(t, "map", batches)
    counts = profiling.traced()["counts"]
    assert counts["upload_bytes_blocking"] == staged
    assert "upload_bytes_staged" not in counts


# -- on the card ---------------------------------------------------------------

CARD_LANES = 8


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    if not (shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc")):
        pytest.skip("no nvcc to build the kernels")
    return "cuda"


def _trace_events(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _within(ranges, ts):
    return any(s <= ts <= e for s, e in ranges)


def _where(events, ts):
    """The innermost range open at host time ``ts``."""
    open_ = [e for e in events if e.get("cat") == "user_annotation"
             and e["ts"] <= ts <= e["ts"] + e.get("dur", 0)]
    return min(open_, key=lambda e: e["dur"])["name"] if open_ else None


@pytest.mark.cuda
def test_card_steps_copy_without_a_pageable_copy_or_a_sync(
        card, tmp_path, monkeypatch):
    """20 traced MapCMA steps: each step's host-to-device copies are
    pinned, and the stream is synchronised only inside ``device_sync``;
    50 steps' actions and logits equal the blocking path's bit for bit."""
    t = _trainer(tmp_path, "map", card, CARD_LANES)
    batches = _batches("map", 50, CARD_LANES, seed=11)
    _run(t, "map", batches[:3])  # kernels built, arenas grown
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _run(t, "map", batches[:20])
    events = _trace_events(prof, tmp_path)

    def ranges(name):
        return [(e["ts"], e["ts"] + e["dur"]) for e in events
                if e.get("name") == name and e.get("ph") == "X"
                and e.get("cat") == "user_annotation"]

    steps, syncs = ranges("policy_step"), ranges("device_sync")
    assert len(steps) == 20
    runtime = [e for e in events
               if e.get("cat") in ("cuda_runtime", "cuda_driver")]
    copies = {e["args"]["correlation"]: e["name"] for e in events
              if e.get("cat") == "gpu_memcpy"}
    pageable = [e["ts"] for e in runtime
                if "Pageable" in copies.get(e["args"].get("correlation"), "")
                and "HtoD" in copies[e["args"]["correlation"]]]
    assert not [_where(events, ts) for ts in pageable
                if _within(steps, ts)]
    stream_syncs = [e["ts"] for e in runtime
                    if e["name"] == "cudaStreamSynchronize"
                    and _within(steps, e["ts"])]
    assert stream_syncs
    assert not [_where(events, ts) for ts in stream_syncs
                if not _within(syncs, ts)]
    pinned = [name for name in copies.values()
              if "HtoD" in name and "Pinned" in name]
    assert len(pinned) >= 20 * 3

    staged = _run(t, "map", batches)
    _every_copy_blocking(monkeypatch)
    blocking = _run(t, "map", batches)
    for s, (a, b) in enumerate(zip(staged, blocking)):
        for k in ("actions", "logits"):
            assert a[k].tobytes() == b[k].tobytes(), (s, k)
