"""The predicted-semantics tour evaluation's policy step, in a closed loop
of lanes: the window of ``drivers/tour_eval.py`` with
``PredictedSemanticsIterativeMapper``, whose device step labels every
lane's RGB-D frame with RedNet before the mapper reads the labels.

Set-up builds the eval's trainer as ``tour_eval`` does (the mapper obs
transform with its RedNet, the policy through ``_initialize_policy``),
overwrites the policy's weights and RedNet's with seeded ones on the
device (RedNet's from a seed of their own, derived from the run's),
renders each lane's depth and RGB frame pool and runs the warm-up steps.
The window calls ``_policy_step`` once per step, as
``_eval_checkpoint_iterative`` does, with the lanes' depth, RGB, pose and
instruction tokens: RedNet labels every live lane's frame at every step
inside the mapper's device step, and nothing keeps labels between steps.
A step is timed from the batch handed in to the actions on the host.

While the window runs, a forward hook on the program's RedNet keeps,
for a seeded sample of lanes, the labels of its scores at every step
(the argmax that ``predict_semantics`` takes, of one gather on the
device) and the scores themselves at the checked steps; nothing in the
port is replaced. Once the window has closed, the plain RedNet
(``reference/rednet.py``) scores the sample lanes' pool frames, and
``reference/tour.py`` follows the sample lanes through every step with
those labels fed to its mapper, so labels changed between RedNet and the
program's mapper show as map cells off. Compared: every action, the logits, recurrent states and maps of
the checked steps as in ``tour_eval``; RedNet's scores at the checked
steps (``semantics_logit_err``: the largest gap over the reference's
largest |score| over the sample lanes' frames); and, at every step, each
sample-lane pixel whose reference top-2 margin exceeds twice the score
tolerance (that limit times the largest |score|), whose label must be
the reference's (``labels_flipped``)."""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch
from torch.profiler import record_function

from portbench import flops_rednet, harness, trace
from portbench.drivers.tour_eval import (Capture, _build, _chunks,
                                        _trace_numbers)
from portbench.harness import Check, Outcome, RunContext
from portbench.inputs import scenes as SC
from portbench.inputs.tours import StepMasks, TourSchedule, frame_index
from portbench.reference import rednet as ref_rednet
from portbench.reference import tour as reference


class Labels:
    """RedNet's labels of the sample lanes at every step and their scores
    at the checked steps, seen through a forward hook on the program's
    RedNet (a function: a cast copy keeps it): the argmax of the sample
    lanes' scores, one gather on the device per step, and a reference to
    the last scores (no copy), whose sample lanes are copied on the device
    at the checked steps."""

    def __init__(self, rednet: torch.nn.Module, sample: torch.Tensor):
        self.sample = sample
        self.steps: List[torch.Tensor] = []
        self.scores = None
        self.kept: Dict[int, torch.Tensor] = {}

        def scored(module, inputs, out):
            self.scores = out
            self.steps.append(
                torch.argmax(out[sample], dim=-1).to(torch.uint8))

        rednet.register_forward_hook(scored)

    def keep(self, s: int) -> None:
        self.kept[s] = self.scores[self.sample].clone()

    def take(self):
        """(steps, S, H, W) labels of every step and the kept scores by
        step, both on the device; nothing is held here after."""
        out = torch.stack(self.steps), self.kept
        self.steps, self.kept, self.scores = [], {}, None
        return out


class SampleSchedule:
    """``schedule`` seen through the sample lanes alone: lane j of this
    view is lane ``sample[j]`` of the run."""

    def __init__(self, schedule: TourSchedule, sample: np.ndarray):
        self.schedule = schedule
        self.sample = sample
        self.starts = schedule.starts[sample]

    def masks(self, step: int) -> StepMasks:
        return StepMasks(*(a[self.sample]
                           for a in self.schedule.masks(step)))

    def instruction(self, lane: int, episode: int) -> np.ndarray:
        return self.schedule.instruction(int(self.sample[lane]), episode)


def _rednet_seed(seed: int) -> int:
    return int(SC.rng_for(seed, 6).integers(2 ** 62))


def run(ctx: RunContext) -> Outcome:
    t = ctx.traffic
    dev = ctx.device
    lanes = int(t["lanes"])
    config, trainer = _build(ctx)
    rednet = trainer.obs_transforms[0].rednet
    harness.seed_weights(rednet, _rednet_seed(ctx.seed))
    ctx.mark("rednet weights")
    if ctx.fault is not None:
        ctx.fault(trainer)
    weights = {k: v.cpu()
               for k, v in harness.weights_of(trainer.policy).items()}
    rednet_weights = {k: v.cpu()
                      for k, v in harness.weights_of(rednet).items()}

    rng = SC.rng_for(ctx.seed, 5)
    frames = int(t["pool_frames"])
    sim = config.TASK_CONFIG.SIMULATOR
    scn = SC.make_scenes(ctx.seed, lanes)
    walks = SC.make_walks(ctx.seed, scn, frames)
    pool = SC.render_pool(
        walks, scn,
        {"depth": (sim.DEPTH_SENSOR.HEIGHT, sim.DEPTH_SENSOR.WIDTH),
         "rgb": (sim.RGB_SENSOR.HEIGHT, sim.RGB_SENSOR.WIDTH)}, dev)
    ctx.mark("frame pool")
    pose = SC.camera_pose(walks)
    schedule = TourSchedule(ctx.seed, lanes, t)
    sample = np.sort(rng.choice(lanes, int(t["sample_lanes"]), replace=False))
    sample_dev = torch.as_tensor(sample, device=dev)
    capture = Capture(trainer, sample_dev)
    labels = Labels(rednet, sample_dev)
    check_every = int(t["check_every"])

    rnn = trainer.policy.initial_rnn_states(lanes, dev)
    prev = np.zeros((lanes, 1), np.int64)
    ones = np.ones((lanes, 1), np.uint8)
    actions_log: List[np.ndarray] = []
    forced = {"episode": int(t["check_episode_starts"]),
              "tour": int(t["check_tour_starts"])}

    def one_step(s: int) -> float:
        nonlocal rnn, prev
        m = schedule.masks(s)
        f = frame_index(s, frames)
        batch = {"depth": pool["depth"][f], "rgb": pool["rgb"][f],
                 "instruction": schedule.update_tokens(m),
                 "world_robot_pose": pose["world_robot_pose"][f],
                 "world_robot_orientation": pose["world_robot_orientation"][f]}
        agent = (~m.episode_start).astype(np.uint8)[:, None]
        tour = (~m.tour_start).astype(np.uint8)[:, None]
        prev[m.episode_start] = 0
        t0 = time.perf_counter()
        with record_function(trace.STEP):
            actions, rnn = trainer._policy_step(
                batch, tour, rnn, prev, (agent, agent, tour, ones))
            actions = np.array(actions)
        dt = time.perf_counter() - t0
        prev = actions
        actions_log.append(actions[:, 0].astype(np.int8))
        keep = (s % check_every == 0)
        if m.episode_start[sample].any() and forced["episode"] > 0:
            forced["episode"] -= 1
            keep = True
        if m.tour_start[sample].any() and s > 0 and forced["tour"] > 0:
            forced["tour"] -= 1
            keep = True
        if keep:
            capture.keep(s, rnn)
            labels.keep(s)
        return dt

    with torch.inference_mode():
        s = 0
        for _ in range(int(t["warmup_steps"])):
            one_step(s)
            s += 1
        harness.synchronize(dev)
        ctx.mark("warm-up")
        setup_s = time.perf_counter() - ctx.started
        load = harness.HostLoad()
        step_s: List[float] = []
        first = s
        summary: Dict = {}
        if ctx.trace:
            window = trace.Window(dev)
            with window:
                t0 = time.perf_counter()
                for _ in range(int(t["trace_steps"])):
                    step_s.append(one_step(s))
                    s += 1
                window_s = time.perf_counter() - t0
            summary = trace.reduce(window.events())
        else:
            t0 = time.perf_counter()
            while True:
                step_s.append(one_step(s))
                s += 1
                if time.perf_counter() - t0 >= ctx.seconds:
                    break
            window_s = time.perf_counter() - t0
        capture.keep(s - 1, rnn)
        labels.keep(s - 1)
        notes = [load.note("the window"), _chunks(step_s, lanes)]
    steps = s
    if len(labels.steps) != steps:
        raise RuntimeError(
            f"RedNet ran at {len(labels.steps)} of {steps} steps")
    peak = harness.memory_peak(dev)
    kept = capture.host()
    program_labels, program_scores = labels.take()
    del capture, labels, trainer, rednet, rnn
    harness.release(dev)

    actions = np.stack(actions_log)  # (steps, lanes)
    window_steps = steps - first
    widths = ctx.config["widths"]
    end_to_end = {
        "eval_steps_per_s": window_steps * lanes / window_s,
        "eval_step_ms_p95": float(np.percentile(step_s, 95)) * 1e3,
        "setup_s": setup_s,
    }
    if ctx.trace and summary:
        summary.update(_trace_numbers(ctx, "map", widths, schedule, first,
                                      steps, lanes, pool, pose, frames))
        per_frame = flops_rednet.rednet_flops(
            widths["depth_side"], widths["rednet_classes"],
            widths["rednet_layers"], widths["rednet_trans_layers"])
        summary["rednet_flops"] = per_frame * lanes * window_steps
        summary["flops"] += summary["rednet_flops"]

    limits = ctx.cell["limits"]
    semantics, notes_rednet = _compare_rednet(
        widths, rednet_weights, pool, sample, frames, steps, program_labels,
        program_scores, limits["semantics_logit_err"], dev)
    del program_scores

    # the sample lanes as they were at each step, their labels those of
    # the program's RedNet: the reference mapper is fed what the
    # program's should have been
    by_step = np.array([frame_index(i, frames) for i in range(steps)])
    seen = {"depth": pool["depth"][:, sample][by_step],
            "semantic12": program_labels.cpu().numpy()[..., None]}
    seen_pose = {k: v[:, sample][by_step] for k, v in pose.items()}
    del program_labels
    ref = reference.follow(
        kind="map", widths=widths, model=ctx.config["model"],
        weights=weights, sample=np.arange(len(sample)), steps=steps,
        schedule=SampleSchedule(schedule, sample), frames=steps, pool=seen,
        pose=seen_pose, actions=actions[:, sample], kept=kept, device=dev)
    checks = [
        Check("action_gap", ref["action_gap"], limits["action_gap"]),
        Check("logit_err", ref["logit_err"], limits["logit_err"]),
        Check("rnn_err", ref["rnn_err"], limits["rnn_err"]),
        Check("map_cells_off", ref["map_cells_off"], limits["map_cells_off"]),
        Check("semantics_logit_err", semantics["semantics_logit_err"],
              limits["semantics_logit_err"]),
        Check("labels_flipped", semantics["labels_flipped"],
              limits["labels_flipped"]),
    ]
    failed = int((ref["gaps"] > limits["action_gap"]).sum())
    summary["notes"] = notes + notes_rednet
    return Outcome(end_to_end, checks, attempted=window_steps * lanes,
                   failed=failed, memory_peak_bytes=peak, summary=summary)


@torch.no_grad()
def _compare_rednet(widths, weights, pool, sample, frames, steps, labels,
                    scores, rel_limit, device):
    """RedNet's numbers: the plain RedNet's scores of the sample lanes'
    pool frames against the program's scores at the checked steps and its
    labels at every step."""
    w = {k: v.to(device) for k, v in weights.items()}
    used = sorted({frame_index(i, frames) for i in range(steps)})
    row = {f: i for i, f in enumerate(used)}
    n = len(sample)
    rgb = torch.from_numpy(pool["rgb"][:, sample][used]).to(device)
    depth = torch.from_numpy(
        pool["depth"][:, sample][used][..., 0].astype(np.int32)).to(device)
    want = ref_rednet.scores(
        w, rgb.reshape((-1,) + rgb.shape[2:]),
        depth.reshape((-1,) + depth.shape[2:]).float() * (1.0 / 65535.0),
        widths["rednet_layers"], widths["rednet_trans_layers"])
    del rgb, depth, w
    want = want.reshape((len(used), n) + want.shape[1:])  # (U, S, C, H, W)
    scale = float(want.abs().max())
    tol = rel_limit * scale
    top = want.topk(2, dim=2).values
    sure = (top[:, :, 0] - top[:, :, 1]) > 2 * tol  # (U, S, H, W)
    want_labels = want.argmax(2).to(torch.uint8)
    del top

    err = 0.0
    for s, got in scores.items():
        gap = got.permute(0, 3, 1, 2).double() - want[row[frame_index(
            s, frames)]].double()
        err = max(err, float(gap.abs().max()))
    flipped = agree = 0
    for i in range(steps):
        r = row[frame_index(i, frames)]
        same = labels[i] == want_labels[r]
        flipped += int((sure[r] & ~same).sum())
        agree += int(same.sum())
    pixels = steps * labels[0].numel()
    notes = [f"RedNet: largest reference |score| {scale!r} over {len(used)} "
             f"frames x {n} sample lanes; {len(scores)} checked steps; "
             f"labels equal on {agree / pixels:.6f} of {pixels} sample "
             f"pixels, {int(sure.sum())} of {sure.numel()} frame pixels "
             f"decided beyond twice the tolerance {tol!r}"]
    return {"semantics_logit_err": err / scale,
            "labels_flipped": float(flipped)}, notes
