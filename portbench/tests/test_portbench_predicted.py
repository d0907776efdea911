"""The predicted-semantics tour eval (``drivers/predicted_eval.py``) and
the 96-trajectory update. On the CPU at the tiny size: the driver's run
agrees with the plain reference, and a RedNet step broken underneath is
not correct. On the card (marked ``cuda``; skipped without one): each
new cell at its own size is correct, and its controls are not.

    python -m pytest portbench/tests/test_portbench_predicted.py -q \
        -p no:cacheprovider
"""

import pytest
import torch

from ivlnce_tpu_torch.utils import profiling
from portbench import run
from portbench.tests.test_portbench_card import SEEDS, _run

EVAL = "map_cma_rednet.tour_eval"
TRAIN = "map_cma.train_step.b96"


# a traced window of 2 steps, by hand: 2 ms of device time in the
# ``semantics`` range, 0.2 ms of it in ``rednet``, and 6.7 GFLOP of
# RedNet at a 67 TFLOP/s peak (0.1 ms at the least)
SUMMARY = {"steps": 2, "window_us": 5000.0, "busy_us": 4000.0,
           "by_range_us": {"semantics": 2000.0, "rednet": 200.0},
           "rednet_flops": 6.7e9, "flops": 1e10, "peak_flops": 67e12}
READINGS = {"semantics_device_ms.eval": 1.0, "rednet_roofline": 50.0,
            "rednet_frames_per_step.eval": 64.0}


@pytest.mark.parametrize("metric", sorted(READINGS))
def test_each_new_reader_by_hand(monkeypatch, metric):
    monkeypatch.setattr(profiling, "traced", lambda: {
        "host_us": {}, "counts": {"rednet_frames": 128}})
    assert run.reader(metric).read(SUMMARY) == pytest.approx(
        READINGS[metric])
    assert run.reader(metric).read({}) is None


@pytest.mark.parametrize("metric", sorted(READINGS))
def test_a_program_without_the_rednet_spans_reads_nothing_new(monkeypatch,
                                                              metric):
    """The parent's program has the ``semantics`` range alone, and no
    ``rednet`` range or ``rednet_frames`` counter."""
    monkeypatch.setattr(profiling, "traced",
                        lambda: {"host_us": {}, "counts": {}})
    older = dict(SUMMARY, by_range_us={"semantics": 2000.0})
    got = run.reader(metric).read(older)
    assert (got is not None) == (metric == "semantics_device_ms.eval")


def test_the_predicted_eval_agrees_with_the_reference(tiny):
    out = tiny(EVAL)
    assert out.correct, out.checks
    assert out.attempted > 0 and out.failed == 0
    assert {c.name for c in out.checks} >= {
        "map_cells_off", "semantics_logit_err", "labels_flipped"}


def test_the_traced_predicted_eval_counts_rednet(tiny):
    out = tiny(EVAL, trace=True)
    assert out.correct, out.checks
    assert out.summary["rednet_flops"] > 0
    assert out.summary["flops"] > out.summary["rednet_flops"]


def _on_rednet(trainer, change):
    """``change(scores)`` applied to RedNet's output, as part of RedNet."""
    trainer.obs_transforms[0].rednet.register_forward_hook(
        lambda module, inputs, out: change(out.clone()))


def _to_class_0(scores, lanes=slice(0, 1)):
    scores[lanes] = 0
    scores[lanes, ..., 0] = 1
    return scores


def _zeroed_rednet_labels(trainer):
    """Lane 0's scores put every pixel in class 0."""
    _on_rednet(trainer, _to_class_0)


def _skipped_rednet(trainer):
    """Lane 0 keeps the scores of its first step: its RedNet is skipped
    from then on."""
    first = []

    def skipped(scores):
        if first:
            scores[0] = first[0]
        else:
            first.append(scores[0].clone())
        return scores

    _on_rednet(trainer, skipped)


class _AfterRedNet(torch.nn.Module):
    """RedNet, then every lane's scores put in class 0 (lane 0's map is
    empty at the tiny size): the labels handed the mapper are not those of
    RedNet's own output."""

    def __init__(self, rednet):
        super().__init__()
        self.rednet = rednet

    def forward(self, *inputs):
        return _to_class_0(self.rednet(*inputs).clone(), slice(None))


def _zeroed_labels(trainer):
    """The labels zeroed on their way from RedNet to the mapper."""
    transform = trainer.obs_transforms[0]
    transform.rednet = _AfterRedNet(transform.rednet)


def _training_norms(trainer):
    """RedNet's BatchNorms run in training mode (the batch's statistics
    in place of the frozen ones)."""
    trainer.obs_transforms[0].rednet.train()


@pytest.mark.parametrize("fault,number", [
    (_zeroed_rednet_labels, "labels_flipped"),
    (_zeroed_labels, "map_cells_off"),
    (_skipped_rednet, "labels_flipped"),
    (_training_norms, "semantics_logit_err"),
])
def test_a_broken_rednet_step_is_not_correct(tiny, fault, number):
    out = tiny(EVAL, fault=fault)
    assert not out.correct
    assert number in {c.name for c in out.checks if not c.ok}


def test_bfloat16_fails_the_rednet_agreement(tiny):
    out = tiny(EVAL, control="bf16")
    failed = {c.name for c in out.checks if not c.ok}
    assert failed & {"semantics_logit_err", "labels_flipped"}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [EVAL, TRAIN])
def test_the_new_cell_is_correct_on_the_card(cell):
    assert _run(cell, SEEDS[1])["correct"]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell,control", [
    (EVAL, "tf32"), (EVAL, "bf16"), (TRAIN, "tf32"),
])
def test_the_new_cell_control_is_not_correct(cell, control, seed):
    line = _run(cell, seed, control)
    assert not line["correct"]
    if cell == EVAL:
        rednet = ("semantics_logit_err", "labels_flipped")
        assert any(line["checks"][n]["value"] > line["checks"][n]["limit"]
                   for n in rednet)
