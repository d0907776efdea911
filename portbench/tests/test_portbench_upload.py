"""The reader of ``staged_upload_pct.eval`` against hand-made records of
the program's upload counters (every byte staged, some sent blocking,
none counted, a program that keeps no record), and on a tiny traced
MapCMA and LatentCMA eval on the CPU, where every copy of the step is
staged."""

import pytest

from ivlnce_tpu_torch.utils import profiling
from portbench import run

METRIC = "staged_upload_pct.eval"
SUMMARY = {"steps": 2}


@pytest.mark.parametrize("counts,want,blocking", [
    ({"upload_bytes_staged": 3000}, 100.0, "0.0"),
    ({"upload_bytes_staged": 3000, "upload_bytes_blocking": 0}, 100.0,
     "0.0"),
    ({"upload_bytes_staged": 3000, "upload_bytes_blocking": 1000}, 75.0,
     "500.0"),
    ({"upload_bytes_blocking": 1000}, 0.0, "500.0"),
])
def test_the_share_of_a_record(monkeypatch, capsys, counts, want, blocking):
    monkeypatch.setattr(profiling, "traced",
                        lambda: {"host_us": {}, "counts": counts})
    assert run.reader(METRIC).read(SUMMARY) == pytest.approx(want)
    assert f"upload_bytes_blocking per step {blocking}" in (
        capsys.readouterr().err)
    assert run.reader(METRIC).read({}) is None


def test_nothing_to_read_gives_none(monkeypatch):
    """No counter (the parent's program), both at 0, no record kept."""
    for counts in ({}, {"upload_bytes_staged": 0,
                        "upload_bytes_blocking": 0}):
        monkeypatch.setattr(profiling, "traced",
                            lambda: {"host_us": {}, "counts": counts})
        assert run.reader(METRIC).read(SUMMARY) is None
    monkeypatch.delattr(profiling, "traced")
    assert run.reader(METRIC).read(SUMMARY) is None


@pytest.mark.parametrize("cell", ["map_cma.tour_eval",
                                  "latent_cma.tour_eval"])
def test_a_tiny_traced_eval_stages_every_copy(tiny, cell):
    out = tiny(cell, trace=True)
    assert out.correct
    assert run.reader(METRIC).read(out.summary) == 100.0
