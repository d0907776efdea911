"""The traced window's reduction and every per-layer reader on a small
synthetic Chrome trace (``data/synthetic_trace.json``: two steps, eight
ranges, seven launches, seven device events in the window and one after
it), against values worked out by hand; the readers of the program's
spans and counters (``portbench/spans.py``) against a hand-made record,
against a program that keeps none, and on a tiny traced run on the
CPU; ``portbench/split.py``'s split of the fixture by span."""

import json
import pathlib

import pytest

from ivlnce_tpu_torch.utils import profiling
from portbench import harness, run, spans, split, trace

DATA = pathlib.Path(__file__).parent / "data"

# the fixture worked out by hand (µs): device events [16, 20] [20, 50]
# [55, 60] [70, 80] [108, 110] [120, 140] [160, 190] in a [0, 200] window;
# each credited to the ranges open at its launch, each idle gap to the
# innermost range open where it begins
REDUCED = {
    "window_us": 200.0,
    "busy_us": 101.0,
    "steps": 2,
    "by_range_us": {"portbench.step": 101.0, "encoders": 54.0,
                    "mapper": 5.0, "gru_attention": 10.0,
                    "train_encode": 2.0, "backward": 30.0},
    "kernels_us": {"Memcpy HtoD (Pageable -> Device)": 4.0, "conv": 50.0,
                   "accumulate_tile_k1": 5.0, "gru": 10.0,
                   "rasterize_cluster_k2": 2.0, "bwd": 30.0},
    "host_issue_us": [62.0, 55.0],
    "idle_by_range_us": {"portbench.step": 54.0, "mapper": 5.0,
                         "gru_attention": 10.0, "encoders": 30.0},
}
# what a traced run adds besides the trace: the needed FLOPs and bytes and
# the peaks
EXTRA = {"flops": 1e9, "peak_flops": 1e14, "mapper_bytes": 3.5e6,
         "peak_bytes_per_s": 1e12}
READERS = {
    "backward_device_ms.train": 0.015,
    "device_idle_pct.eval": 49.5,
    "device_idle_pct.train": 49.5,
    "encoder_device_ms.eval": 0.027,
    "encoder_device_ms.train": 0.001,
    "gru_attention_device_ms.eval": 0.005,
    "host_issue_ms.eval": 0.0585,
    "host_issue_ms.train": 0.0585,
    "mapper_device_ms.eval": 0.0025,
    "mapper_kernels_roofline": 50.0,  # 3.5 µs of bytes in 7 µs
    "mfu.eval": 5.0,  # 1e9 FLOPs in 200 µs over 1e14 FLOP/s
    "mfu.train": 5.0,
}
# a record of the program's spans and counters, and its readings over
# the fixture's 2 steps
RECORD = {"host_us": {"upload": 3000.0, "instruction_cache": 5000.0,
                      "device_sync": 800.0, "policy_step": 20000.0},
          "counts": {"instruction_rows_encoded": 510,
                     "instruction_rows_changed": 9}}
PROGRAM = {
    "upload_host_ms.eval": 1.5,
    "upload_host_ms.train": 1.5,
    "instruction_host_ms.eval": 2.5,
    "sync_wait_ms.eval": 0.4,
    "instruction_rows_per_step.eval": 255.0,
}


@pytest.fixture(scope="module")
def reduced():
    with open(DATA / "synthetic_trace.json") as f:
        return trace.reduce(json.load(f))


def test_reduce_on_the_fixture(reduced):
    assert set(reduced) == set(REDUCED)
    for key, want in REDUCED.items():
        assert reduced[key] == pytest.approx(want), key


@pytest.mark.parametrize("metric", sorted(READERS))
def test_each_trace_reader_on_the_fixture(reduced, metric):
    got = run.reader(metric).read(dict(reduced, **EXTRA))
    assert got == pytest.approx(READERS[metric])


def test_every_per_layer_metric_has_a_case_here():
    bench = harness.benchmark()
    assert {m["name"] for m in bench["per_layer"]} == (set(READERS)
                                                       | set(PROGRAM))


@pytest.mark.parametrize("metric", sorted(PROGRAM))
def test_each_program_reader_on_a_record(reduced, monkeypatch, capsys,
                                         metric):
    monkeypatch.setattr(profiling, "traced", lambda: RECORD)
    assert run.reader(metric).read(reduced) == pytest.approx(
        PROGRAM[metric])
    assert run.reader(metric).read({}) is None
    if metric == "instruction_rows_per_step.eval":
        assert "instruction_rows_changed per step 4.5" in (
            capsys.readouterr().err)
    # a program that keeps no record (one without traced()), or a record
    # without the span or counter
    monkeypatch.setattr(profiling, "traced",
                        lambda: {"host_us": {}, "counts": {}})
    assert run.reader(metric).read(reduced) is None
    monkeypatch.delattr(profiling, "traced")
    assert run.reader(metric).read(reduced) is None


def test_the_helpers_count_zero_and_nothing_apart(reduced, monkeypatch):
    monkeypatch.setattr(profiling, "traced",
                        lambda: {"host_us": {}, "counts": {"rows": 0}})
    assert spans.per_step(reduced, "rows") == 0.0
    assert spans.per_step(reduced, "other") is None
    assert spans.host_ms(reduced, "upload") is None


@pytest.mark.parametrize("cell", ["map_cma.tour_eval", "map_cma.train_step"])
def test_a_tiny_traced_run_reads_the_programs_spans(tiny, monkeypatch,
                                                    cell):
    """The readers of a cell find the program's spans in a traced run,
    and the split finds them in its trace."""
    kept = {}
    reduce = trace.reduce

    def keep(events):
        kept["events"] = events
        return reduce(events)

    monkeypatch.setattr(trace, "reduce", keep)
    out = tiny(cell, trace=True)
    bench = harness.benchmark()
    for m in run.metrics_of(bench, cell, "per_layer"):
        if m["name"] in PROGRAM:
            got = run.reader(m["name"]).read(out.summary)
            assert got is not None and got > 0, m["name"]
    got = split.analyse(kept["events"])
    top = "policy_step" if "eval" in cell else "train_step"
    assert {top, "upload", "device_sync"} <= set(got["host_ms"])
    assert 0 <= got["unexplained_ms"] < got["host_ms"][top]


def test_the_split_of_the_fixture():
    """Per step of 100 µs: each range's host time, the idle time while
    it was open (gaps [0, 16] [50, 55] [60, 70] [80, 108] [110, 120]
    [140, 160] [190, 200]), the six kernel launches (a copy is no
    launch)."""
    with open(DATA / "synthetic_trace.json") as f:
        got = split.analyse(json.load(f))
    host = {"portbench.step": 0.1, "encoders": 0.035, "backward": 0.02,
            "gru_attention": 0.01, "mapper": 0.005, "train_encode": 0.0025}
    idle = {"portbench.step": 0.0495, "encoders": 0.013, "backward": 0.005,
            "gru_attention": 0.005, "mapper": 0.0025,
            "train_encode": 0.0015}
    assert got["steps"] == 2 and got["step_ms"] == pytest.approx(0.1)
    assert got["host_ms"] == pytest.approx(host)
    assert got["idle_ms"] == pytest.approx(idle)
    assert got["idle_total_ms"] == pytest.approx(0.0495)
    assert got["launches_per_step"] == 3.0
    assert got["htod_device_ms"] == pytest.approx(0.002)
    assert got["unexplained_ms"] is None
    assert got["spans_per_step"]["encoders"] == 1.0
    assert split.analyse({"traceEvents": []}) == {}
