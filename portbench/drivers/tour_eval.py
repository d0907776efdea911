"""The iterative tour evaluation's policy step, in a closed loop of lanes.

Set-up builds a trainer for the eval (``BaseVLNCETrainer``: the mapper
obs transform, the policy through ``_initialize_policy``), overwrites its
weights with seeded ones on the device, renders each lane's frame pool
and runs the first ``warmup_steps`` steps. The window then calls
``_policy_step`` once per step, as ``_eval_checkpoint_iterative`` does:
the batch of the lanes' frames, pose and instruction tokens, the tour
masks as the map's reset masks, and the (agent, sim, tour, action)
masks; every lane is live every step. A step is timed from the batch
handed in to the actions on the host.

Once the window has closed, the plain reference follows a seeded sample
of lanes through every step of the run, from the same frames and
weights, with the program's own actions as the previous actions, and
compares: every action the program took in them (how far its logit lies
below the reference's best), the logits and recurrent states of the
checked steps, and their egocentric maps, cell by cell."""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch
from torch.profiler import record_function

from portbench import flops, harness, trace
from portbench.harness import Check, Outcome, RunContext
from portbench.inputs import scenes as SC
from portbench.inputs.tours import TourSchedule, frame_index
from portbench.reference import tour as reference


def _build(ctx: RunContext):
    from ivlnce_tpu_torch.models import policy as _policies  # noqa: F401
    from ivlnce_tpu_torch.trainers.base_trainer import BaseVLNCETrainer

    ctx.mark("port import")
    t = ctx.traffic
    config = harness.port_config(ctx, {"NUM_ENVIRONMENTS": t["lanes"]})
    trainer = BaseVLNCETrainer(config, device=str(ctx.device))
    trainer._setup_obs_transforms(config)
    trainer._initialize_policy(config, None)
    ctx.mark("trainer")
    harness.seed_weights(trainer.policy, ctx.seed)
    ctx.mark("weights")
    if ctx.control == "tf32":
        harness.allow_tf32(True)
    return config, trainer


def _sensors(config, mapper: bool) -> Dict:
    sim = config.TASK_CONFIG.SIMULATOR
    s = {"depth": (sim.DEPTH_SENSOR.HEIGHT, sim.DEPTH_SENSOR.WIDTH)}
    if mapper:
        s["semantic12"] = True
    else:
        s["rgb"] = (sim.RGB_SENSOR.HEIGHT, sim.RGB_SENSOR.WIDTH)
    return s


class Capture:
    """References to what the timed path produced at the last step (no
    copy, no launch), and device copies of the sample lanes' part at the
    checked steps."""

    def __init__(self, trainer, sample: torch.Tensor):
        self.sample = sample
        self.out = None
        self.maps = None
        self.kept: Dict[int, Dict[str, torch.Tensor]] = {}
        act = trainer.policy.act_iterative
        step = trainer._device_step

        def act_kept(*a, **k):
            self.out = act(*a, **k)
            return self.out

        def step_kept(*a, **k):
            state, occ, sem = step(*a, **k)
            self.maps = (occ, sem)
            return state, occ, sem

        trainer.policy.act_iterative = act_kept
        if step is not None:
            trainer._device_step = step_kept

    def keep(self, s: int, rnn: torch.Tensor) -> None:
        i = self.sample
        got = {"logits": self.out.logits[i].clone(), "rnn": rnn[i].clone()}
        if self.maps is not None:
            got["occupancy"] = self.maps[0][i].clone()
            got["semantic"] = self.maps[1][i].clone()
        self.kept[s] = got

    def host(self) -> Dict[int, Dict[str, torch.Tensor]]:
        return {s: {k: v.cpu() for k, v in d.items()}
                for s, d in self.kept.items()}


def run(ctx: RunContext) -> Outcome:
    t = ctx.traffic
    dev = ctx.device
    lanes = int(t["lanes"])
    config, trainer = _build(ctx)
    mapper = bool(trainer.obs_transforms)
    kind = "map" if mapper else "latent"
    if ctx.fault is not None:
        ctx.fault(trainer)
    weights = {k: v.cpu()
               for k, v in harness.weights_of(trainer.policy).items()}

    rng = SC.rng_for(ctx.seed, 5)
    frames = int(t["pool_frames"])
    scn = SC.make_scenes(ctx.seed, lanes)
    walks = SC.make_walks(ctx.seed, scn, frames)
    pool = SC.render_pool(walks, scn, _sensors(config, mapper), dev)
    ctx.mark("frame pool")
    pose = SC.camera_pose(walks)
    schedule = TourSchedule(ctx.seed, lanes, t)
    sample = np.sort(rng.choice(lanes, int(t["sample_lanes"]), replace=False))
    capture = Capture(trainer, torch.as_tensor(sample, device=dev))
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
        batch = {"depth": pool["depth"][f],
                 "instruction": schedule.update_tokens(m)}
        if mapper:
            batch["semantic12"] = pool["semantic12"][f]
            batch["world_robot_pose"] = pose["world_robot_pose"][f]
            batch["world_robot_orientation"] = pose[
                "world_robot_orientation"][f]
        else:
            batch["rgb"] = pool["rgb"][f]
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
        starts = m.episode_start[sample]
        keep = (s % check_every == 0)
        if starts.any() and forced["episode"] > 0:
            forced["episode"] -= 1
            keep = True
        if m.tour_start[sample].any() and s > 0 and forced["tour"] > 0:
            forced["tour"] -= 1
            keep = True
        if keep:
            capture.keep(s, rnn)
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
        notes = [load.note("the window"), _chunks(step_s, lanes)]
    steps = s
    peak = harness.memory_peak(dev)
    kept = capture.host()
    del capture, trainer, rnn
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
        summary.update(_trace_numbers(ctx, kind, widths, schedule, first,
                                      steps, lanes, pool, pose, frames))

    ref = reference.follow(
        kind=kind, widths=widths, model=ctx.config["model"], weights=weights,
        sample=sample, steps=steps, schedule=schedule,
        frames=frames, pool=pool, pose=pose, actions=actions,
        kept=kept, device=dev)
    limits = ctx.cell["limits"]
    checks = [
        Check("action_gap", ref["action_gap"], limits["action_gap"]),
        Check("logit_err", ref["logit_err"], limits["logit_err"]),
        Check("rnn_err", ref["rnn_err"], limits["rnn_err"]),
    ]
    if mapper:
        checks.append(Check("map_cells_off", ref["map_cells_off"],
                            limits["map_cells_off"]))
    failed = int((ref["gaps"] > limits["action_gap"]).sum())
    summary["notes"] = notes
    return Outcome(end_to_end, checks, attempted=window_steps * lanes,
                   failed=failed, memory_peak_bytes=peak, summary=summary)


def _chunks(step_s: List[float], lanes: int, chunk: float = 5.0) -> str:
    """Lane-steps per second in each ``chunk`` seconds of the window's
    steps, so a run's drift shows beside its rate."""
    rates, n, t = [], 0, 0.0
    for dt in step_s:
        n, t = n + 1, t + dt
        if t >= chunk:
            rates.append(n * lanes / t)
            n, t = 0, 0.0
    return "window lane-steps/s by {:g} s of steps: {}".format(
        chunk, ", ".join(f"{r:.3f}" for r in rates))


def _trace_numbers(ctx, kind, widths, schedule, first, steps, lanes, pool,
                   pose, frames) -> Dict:
    """What the per-layer readers take besides the trace: the needed
    FLOPs of the traced steps and, with a mapper, the least bytes of its
    kernels."""
    lane_step = flops.eval_lane_step_flops(kind, widths)
    encode = 0
    for s in range(first, steps):
        m = schedule.masks(s)
        for i in np.nonzero(m.episode_start)[0]:
            tokens = schedule.instruction(int(i), int(m.episode[i]))
            encode += flops.instruction_flops(int((tokens != 0).sum()), widths)
    out = {"flops": lane_step * lanes * (steps - first) + encode,
           "lane_steps": lanes * (steps - first),
           "peak_flops": flops.PEAK_FP32_FLOPS}
    if kind == "map":
        from portbench.reference.mapper import touched_cells

        k1 = k2 = 0
        for s in range(first, steps):
            f = frame_index(s, frames)
            touched = touched_cells(pool["depth"][f], pose, f, widths,
                                    ctx.device)
            b = flops.mapper_bytes(pool["depth"][f].size, touched, lanes,
                                   widths["window_cells"], widths["map_side"])
            k1 += b["accumulate"]
            k2 += b["rasterize"]
        out["mapper_bytes"] = k1 + k2
        out["peak_bytes_per_s"] = flops.PEAK_HBM_BYTES_PER_S
    return out
