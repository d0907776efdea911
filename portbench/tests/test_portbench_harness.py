"""The harness finds everything by name, prints only the contract's keys,
and refuses JAX and the JAX package by whole top-level name."""

import json
import sys
import types

import pytest

from portbench import harness, run
from portbench.harness import Check, Outcome

CONTRACT_KEYS = {"correct", "attempted", "failed", "metrics", "device",
                 "breakdown", "checks"}


def test_every_entry_of_the_benchmark_has_its_files():
    bench = harness.benchmark()
    configs = {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert (harness.ROOT / c["file"]).exists()
        assert harness.load("configs", c["name"])["name"] == c["name"]
    for w in bench["workloads"]:
        cell = harness.load("workloads", w["name"])
        assert cell["config"] == w["config"] and w["config"] in configs
        assert cell["chips"] == w["chips"] == 1
        assert callable(run.driver(cell["driver"]).run)
    for m in bench["per_layer"]:
        assert callable(run.reader(m["name"]).read)
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
        assert set(m["workloads"]) <= {w["name"] for w in
                                       bench["workloads"]}


def test_each_cell_reports_setup_another_end_to_end_and_a_layer():
    bench = harness.benchmark()
    for w in bench["workloads"]:
        e2e = {m["name"] for m in run.metrics_of(bench, w["name"],
                                                 "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert run.metrics_of(bench, w["name"], "per_layer")


def test_a_reader_that_finds_nothing_returns_nothing():
    bench = harness.benchmark()
    for m in bench["per_layer"]:
        assert run.reader(m["name"]).read({}) is None


def test_the_last_line_has_only_the_contract_keys():
    out = Outcome({"setup_s": 1.0}, [Check("x", 0.5, 1.0)], attempted=3,
                  failed=0, memory_peak_bytes=7,
                  summary={"window_us": 2e6, "busy_us": 1e6,
                           "kernels_us": {"k": 1e6},
                           "idle_by_range_us": {"mapper": 5e5}})
    line = run.result_line(out, {"setup_s": {"value": 1.0, "unit": "s"}},
                           {"platform": "gpu", "kind": "x", "count": 1,
                            "memory_peak_bytes": 7}, traced=True)
    assert set(line) <= CONTRACT_KEYS
    assert list(line)[-1] == "checks"
    assert line["correct"] is True
    assert line["device"]["busy_s"] == 1.0
    assert line["device"]["window_s"] == 2.0
    assert line["breakdown"]["device_ops"] == [["k", 1.0]]
    json.dumps(line)


@pytest.mark.parametrize("name,found", [
    ("jax", True), ("jaxlib.xla_client", True), ("flax", True),
    ("ivlnce_tpu", True), ("ivlnce_tpu.models.cma", True),
    ("ivlnce_tpu_torch", False), ("ivlnce_tpu_torch.models", False),
    ("jaxtyping", False),
])
def test_the_isolation_check_compares_whole_top_level_names(monkeypatch,
                                                            name, found):
    for m in [m for m in sys.modules if m.split(".")[0] in run.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, m)
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert (name in run.foreign_modules()) is found


def test_a_run_without_a_card_prints_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", "map_cma.tour_eval", "--seed", "1",
                   "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("loads_jax", [True, False])
def test_a_reader_that_loads_jax_stops_the_result(monkeypatch, tmp_path,
                                                   capsys, loads_jax):
    """The isolation check comes after every reader has run: a reader that
    imports a module named ``jax`` leaves no result line."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "jax" / "__init__.py").write_text("")
    stub = tmp_path / "stub.py"
    stub.write_text(("import jax\n" if loads_jax else "")
                    + "\n\ndef read(summary):\n    return 1.0\n")
    for m in [m for m in sys.modules if m.split(".")[0] in run.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, m)
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.setattr(run, "reader",
                        lambda name: run._load_file(str(stub), "stub"))
    monkeypatch.setattr(run, "power_limit_w", lambda: None)
    out = Outcome({"setup_s": 1.0}, [Check("x", 0.5, 1.0)], attempted=1,
                  failed=0, memory_peak_bytes=0,
                  summary={"window_us": 2.0, "busy_us": 1.0, "steps": 1})
    cell = harness.load("workloads", "map_cma.tour_eval")
    try:
        rc = run.report(harness.benchmark(), cell["name"], cell, out,
                        traced=True, kind="cpu")
    finally:
        sys.modules.pop("jax", None)
    printed = capsys.readouterr()
    if loads_jax:
        assert rc != 0 and printed.out == ""
        assert "jax" in printed.err.splitlines()[-1]
    else:
        assert rc == 0
        line = json.loads(printed.out.strip().splitlines()[-1])
        assert set(line) <= CONTRACT_KEYS
