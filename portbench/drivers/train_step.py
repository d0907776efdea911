"""The MapCMA IL update, ``BaseVLNCETrainer._update_agent``, as DAgger's
epochs call it once per collated batch: the upload, the BPTT forward, the
inflection-weighted loss with the progress monitor, backward, Adam and
the map encoder's BatchNorm statistics.

Set-up builds the trainer for training (``_initialize_training``: the
policy and its Adam), overwrites its weights with seeded ones on the
device, builds ``batches`` seeded host batches in the collate's form and
runs the first updates, one per batch, through ``_update_agent``: they
warm every shape and are the updates the reference follows. The window
takes the batches in turn; an update ends when its losses reach the host.

Once the window has closed, the plain reference repeats the first updates
from the same weights and batches; compared are each update's loss terms,
each leaf's first gradient (from Adam's first moment after one update),
each leaf's change after them and the map statistics after them."""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch
from torch.profiler import record_function

from portbench import flops, harness, trace
from portbench.harness import Check, Outcome, RunContext
from portbench.inputs.trajectories import make_batch
from portbench.reference import train as reference

FOLLOWED = 3  # updates the reference follows


def _changes(policy, start: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each parameter's distance from its start."""
    return {k: float((p.detach() - start[k]).double().norm())
            for k, p in policy.named_parameters() if k in start}


def _stat_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]):
    """The map BatchNorms' running statistics, channel by channel: each
    variance's gap relative to the reference's, and each mean's gap in
    units of the reference's standard deviation (a mean near nought has
    no relative gap to speak of)."""
    var_rel, mean_gap = [], []
    for k, v in want.items():
        if not k.endswith("running_var"):
            continue
        mean = k[:-len("running_var")] + "running_mean"
        var = v.double()
        var_rel.append(((got[k].double() - var).abs() / var.abs())
                       .reshape(-1))
        mean_gap.append(((got[mean].double() - want[mean].double()).abs()
                         / var.sqrt()).reshape(-1))
    return torch.cat(var_rel), torch.cat(mean_gap)


def compare(got: Dict, ref: Dict):
    """The compared numbers of ``got`` (the program's, or the control's)
    against the reference's ``ref``, both in ``reference.follow``'s form,
    and notes on what lies behind them."""
    loss_gaps = [tuple(abs(g - w) / max(abs(w), 1e-12)
                       for g, w in zip(gl, wl))
                 for gl, wl in zip(got["losses"], ref["losses"])]
    var_rel, mean_gap = _stat_gaps(got["map_stats"], ref["map_stats"])
    left_out = reference.rounding_leaves(ref["first_grad"])
    grad_gaps = reference.leaf_gaps(got["first_grad"], ref["first_grad"],
                                    left_out)
    change_gaps = reference.leaf_gaps(got["change"], ref["change"], left_out)
    worst_grad = max(grad_gaps, key=grad_gaps.get)
    worst_change = max(change_gaps, key=change_gaps.get)
    grad_v = list(grad_gaps.values())
    change_v = list(change_gaps.values())
    numbers = {
        # the first update's loss terms, and those of all three: from the
        # second on, Adam's first steps (about lr times the sign of each
        # gradient component) carry the sign of components that round-off
        # decides into the weights, and the float32 runs part by up to
        # some 1e-4 on a few seeds
        "first_loss_rel_err": max(loss_gaps[0]),
        "loss_rel_err": max(max(g) for g in loss_gaps),
        # the median leaf's: the map encoder's BatchNorm scales and
        # shifts sum millions of terms that cancel, by a share that the
        # seed decides, and the program's reductions round those sums by
        # up to 6e-4 on some seeds (float64 sides with the reference
        # there), so the first gradient's worst and 90th
        # percentile leaves are noise from seed to seed; after three
        # updates Adam's steps no longer scale with that noise, and the
        # change keeps its 90th percentile leaf
        "first_grad_gap_median": float(np.median(grad_v)),
        "change_gap_median": float(np.median(change_v)),
        "change_gap_p90": float(np.percentile(change_v, 90)),
        "map_var_median": float(var_rel.median()),
        "map_mean_gap": float(mean_gap.max()),
    }
    notes = [
        "loss gaps by update (loss, action, progress): " + "; ".join(
            ", ".join(f"{x:.3g}" for x in g) for g in loss_gaps),
        f"worst leaf of first_grad_gap: {worst_grad} "
        f"{grad_gaps[worst_grad]!r}; 90th percentile leaf (not compared): "
        f"{float(np.percentile(grad_v, 90))!r}",
        f"worst leaf of change_gap: {worst_change} "
        f"{change_gaps[worst_change]!r}",
        f"worst channel of map_var_median: {float(var_rel.max())!r}",
        f"median channel of map_mean_gap: {float(mean_gap.median())!r}",
        "leaves whose reference gradient is under 1e-3 of the median "
        f"leaf's, left out: {', '.join(left_out)}"]
    return numbers, notes


def run(ctx: RunContext) -> Outcome:
    from ivlnce_tpu_torch.models import policy as _policies  # noqa: F401
    from ivlnce_tpu_torch.trainers.base_trainer import BaseVLNCETrainer

    ctx.mark("port import")
    t = ctx.traffic
    dev = ctx.device
    config = harness.port_config(ctx, {})
    trainer = BaseVLNCETrainer(config, device=str(dev))
    trainer._initialize_training(config)
    ctx.mark("trainer")
    harness.seed_weights(trainer.policy, ctx.seed)
    ctx.mark("weights")
    if ctx.fault is not None:
        ctx.fault(trainer)
    policy, optimizer = trainer.policy, trainer.optimizer
    weights = {k: v.cpu() for k, v in harness.weights_of(policy).items()}
    start = {k: p.detach().clone() for k, p in policy.named_parameters()}

    widths = ctx.config["widths"]
    d = flops.depth_encoder(widths["depth_side"])
    shapes = {"depth_features": (d["channels"], d["side"], d["side"]),
              "map_side": widths["map_side"]}
    batches = [make_batch(ctx.seed, i, t, shapes, dev)
               for i in range(int(t["batches"]))]
    ctx.mark("batches")

    def update(b):
        with record_function(trace.STEP):
            return trainer._update_agent(b.observations, b.prev_actions,
                                         b.not_done_masks, b.corrected,
                                         b.weights)

    losses: List = []
    first_grad: Dict[str, float] = {}
    for i in range(FOLLOWED):
        loss, action, aux, _ = update(batches[i % len(batches)])
        losses.append((loss, action, aux))
        if i == 0:
            b1 = optimizer.defaults["betas"][0]
            first_grad = {
                k: float((optimizer.state[p]["exp_avg"] / (1 - b1))
                         .double().norm())
                for k, p in policy.named_parameters()
                if p in optimizer.state}
    change = {k: v for k, v in _changes(policy, start).items()
              if k in first_grad or v > 0}
    del start
    stats = {k: v.detach().clone().cpu()
             for k, v in policy.state_dict().items()
             if k.startswith("net.map_encoder.")
             and k.endswith(reference.BUFFERS)}
    harness.synchronize(dev)
    ctx.mark("first updates")
    setup_s = time.perf_counter() - ctx.started
    load = harness.HostLoad()

    rows = 0
    summary: Dict = {}
    n = FOLLOWED

    def one_update():
        nonlocal n, rows
        b = batches[n % len(batches)]
        update(b)
        rows += b.valid_rows
        n += 1

    if ctx.trace:
        window = trace.Window(dev)
        with window:
            t0 = time.perf_counter()
            for _ in range(int(t["trace_steps"])):
                one_update()
            window_s = time.perf_counter() - t0
        summary = trace.reduce(window.events())
        if summary:
            tokens = float(np.mean([(b.observations["instruction"] != 0)
                                    .sum(1).mean() for b in batches]))
            summary["flops"] = rows * flops.train_row_flops(widths, tokens)
            summary["peak_flops"] = flops.PEAK_FP32_FLOPS
    else:
        t0 = time.perf_counter()
        while True:
            one_update()
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        window_s = time.perf_counter() - t0
    updates = n - FOLLOWED
    notes = [load.note("the window")]
    peak = harness.memory_peak(dev)
    del trainer, policy, optimizer
    harness.release(dev)

    batches = [batches[i % len(batches)] for i in range(FOLLOWED)]
    lr = float(ctx.config["opts"]["IL.lr"])
    model = ctx.config["model"]
    ref = reference.follow(weights, batches, lr=lr,
                           alpha=float(model["progress_alpha"]),
                           use_progress=bool(model["progress_monitor"]),
                           device=dev)
    got = {"losses": losses, "first_grad": first_grad, "change": change,
           "map_stats": stats}
    if ctx.control == "tf32":
        # the control: the reference itself in TF32 in the program's place
        got = reference.follow(weights, batches, lr=lr,
                               alpha=float(model["progress_alpha"]),
                               use_progress=bool(model["progress_monitor"]),
                               device=dev, tf32=True)
    numbers, compared = compare(got, ref)
    limits = ctx.cell["limits"]
    checks = [Check(k, v, limits[k]) for k, v in numbers.items()]
    end_to_end = {"train_rows_per_s": rows / window_s, "setup_s": setup_s}
    summary["notes"] = notes + compared
    return Outcome(end_to_end, checks, attempted=updates, failed=0,
                   memory_peak_bytes=peak, summary=summary)
