"""The plain reference against the port, at a tiny size on the CPU: every
driver's run is correct; a run in a lower precision and a run whose
timed path is broken underneath are not."""

import numpy as np
import pytest

CELLS = ["map_cma.tour_eval", "latent_cma.tour_eval", "map_cma.train_step"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_port_agrees_with_the_reference(tiny, cell):
    out = tiny(cell)
    assert out.correct, out.checks
    assert out.attempted > 0 and out.failed == 0
    assert {"setup_s"} < set(out.end_to_end)


@pytest.mark.parametrize("cell", ["map_cma.tour_eval", "latent_cma.tour_eval"])
def test_bfloat16_fails_the_agreement(tiny, cell):
    out = tiny(cell, control="bf16")
    assert not out.correct
    failed = {c.name for c in out.checks if not c.ok}
    assert failed & {"logit_err", "rnn_err"}


def _stale_state(trainer):
    """The step hands back the recurrent state it was given."""
    step = trainer._policy_step

    def stale(batch, reset, rnn, *a, **k):
        actions, _ = step(batch, reset, rnn, *a, **k)
        return actions, rnn

    trainer._policy_step = stale


def _altered_action(trainer):
    """Lane 0's action is changed where the step produces it."""
    step = trainer._policy_step

    def altered(*a, **k):
        actions, rnn = step(*a, **k)
        actions = np.array(actions)
        actions[0] = (actions[0] + 1) % 4
        return actions, rnn

    trainer._policy_step = altered


def _half_batch(trainer):
    """The mapper sees the first half of the lanes' frames; the rest are
    left out (their depth zeroed)."""
    step = trainer._device_step

    def half(state, obs, reset, rednet=None):
        depth = obs["depth"].clone()
        depth[depth.shape[0] // 2:] = 0
        return step(state, dict(obs, depth=depth), reset, rednet)

    trainer._device_step = half


@pytest.mark.parametrize("fault,cell,number", [
    (_stale_state, "map_cma.tour_eval", "rnn_err"),
    (_stale_state, "latent_cma.tour_eval", "rnn_err"),
    (_altered_action, "map_cma.tour_eval", "action_gap"),
    (_altered_action, "latent_cma.tour_eval", "action_gap"),
    (_half_batch, "map_cma.tour_eval", "map_cells_off"),
])
def test_a_broken_eval_step_is_not_correct(tiny, fault, cell, number):
    out = tiny(cell, fault=fault)
    assert not out.correct
    assert number in {c.name for c in out.checks if not c.ok}


def _no_update(trainer):
    """The optimizer step returns the weights unchanged."""
    trainer.optimizer.step = lambda *a, **k: None


def _half_lanes(trainer):
    """The update leaves out the second half of the batch's lanes and
    takes its mean over the rest."""
    update = trainer._update_agent

    def half(obs, prev, masks, corrected, weights, *a, **k):
        t, n = corrected.shape
        keep = n // 2

        def cut(x):
            x = np.asarray(x)
            return x.reshape((t, n) + x.shape[1:])[:, :keep].reshape(
                (t * keep,) + x.shape[1:])

        return update({k2: cut(v) for k2, v in obs.items()}, cut(prev),
                      cut(masks), corrected[:, :keep], weights[:, :keep],
                      *a, **k)

    trainer._update_agent = half


@pytest.mark.parametrize("fault,number", [
    (_no_update, "change_gap_median"),
    (_half_lanes, "loss_rel_err"),
])
def test_a_broken_update_is_not_correct(tiny, fault, number):
    out = tiny("map_cma.train_step", fault=fault)
    assert not out.correct
    assert number in {c.name for c in out.checks if not c.ok}
