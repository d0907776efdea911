"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure ends the run with a nonzero exit):
1. the card's name and power limit;
2. build the CUDA kernels from ivlnce_tpu_torch/csrc, and show the
   registers and shared memory ``-Xptxas -v`` gives the K1, K2 and K3
   kernels;
3. each kernel against its plain PyTorch version on the card, exactly:
   K1 and K2 on a seeded noise walk and a FakeSim walk at main-path
   shapes (B=16, 256x256 frames, 1024^2 grid, 192^2 window, 64x64 map,
   12 steps) and on tie frames (B=3 at those shapes; B=1 at a 100-cell
   window of a 256^2 grid); K3 on two loads of seeded clouds (B=16, 2^18
   points, 1024^2 grid, the second into some lanes only), on the edge
   cases of its tiled design (``mapping/clouds.py``) and on the fake
   val_seen clouds at L=3 and L=1, each load into rows a load filled;
4. K1 and K2 at B=64 and B=3 on a noise walk and a FakeSim walk: the
   kernels, the plain versions and the bound (CUDA events), and each
   kernel apart (``torch.profiler``); K3's whole load at B=64 (2^18
   points per cloud) and at L=3 and L=1 (the val_seen clouds): the
   kernel and the plain version, each kernel apart, the peak memory,
   and two bounds;
5. full-width steps on the card against the same steps on the CPU (plain
   versions): a mapper + MapCMA step (maps equal, logits and RNN states
   close), a known-map preload and three steps (maps equal), a RedNet
   step at 256^2 (logits close; maps equal with the labels fed equal),
   three LatentCMA steps of each tour-memory variant (224^2 RGB, 256^2
   depth, random BatchNorm statistics, a tour boundary at step 2) and an
   RxR encode of 512 x 768 features (logits, RNN states and features
   close);
6. the port's iterative MapCMA evaluation through its entry point
   (``ivlnce_tpu_torch.run.run_exp``) at full width
   (configs/fake/map_cma_eval_iterative.yaml, seeded random weights),
   with the kernels' launch counters set to 0 before and read after;
7. the same evaluation again, over one tour per lane, with a window of
   policy steps traced by ``torch.profiler``: the device time of each
   named range of the step (mapper, semantics, encoders, GRU +
   attention, instruction encoder) and the card's busy share;
8. the known-map evaluation (configs/fake/map_cma_eval_known.yaml, K3 and
   K2) through ``run_exp`` at full width, one tour per lane;
9. the predicted-semantics evaluation (PredictedSemanticsIterativeMapper:
   RedNet, K1 and K2) through ``run_exp``, one tour per lane, then traced
   as in phase 7;
10. the four LatentCMA tour baselines (plain, tour_memory,
   tour_memory_variant, and with memory_at_end) through ``run_exp`` and
   ``iterative_dagger``, with no mapper: K1, K2 and K3 never launch (one
   tour per lane each, to keep the script near half its time limit);
11. the memory_at_end baseline traced as in phase 7, with the RGB
   encoder's own range, against a float32 bound of its two ResNet-50s;
12. the episodic evaluations through ``run_exp``: MapCMA with the
   GT-semantics mapper (configs/fake/map_cma_eval_episodic.yaml: K1 and
   K2, every lane's grid cleared at every episode start) and LatentCMA on
   RxR's precomputed features (configs/fake/rxr_eval.yaml: the
   instruction encoder runs once per episode change, not per step);
13. the eval surface: (a) phase 6's weights written as the port's own
   checkpoint, a reference-layout ``.pth`` and a JAX-layout pickle, each
   evaluated through ``run_exp`` over one tour per lane (identical
   actions at every step, equal stats, K1 and K2 once per policy step);
   (b) the MapCMA episodic eval (2 lanes, ``EVAL.EPISODE_COUNT`` 3) with
   ``VIDEO_OPTION ['disk']`` and ``TPU.profile_dir`` (one video per
   episode whose frames carry the top-down map and the egocentric map
   panels; a Chrome trace holding 20 ``policy_step`` ranges); (c) every
   ``run_exp`` eval above prints its host-phase split
   (``IVLNCE_PHASE_TIMES``, set before the port is imported);
14. training at full width, the config's 2 lanes, 30-step episodes,
   batches of 5, two epochs: (a) MapCMA teacher forcing
   (configs/fake/map_cma_train_tf.yaml, iterative collection with the
   GT-semantics mapper) through ``run_exp(..., "train")``: K1 and K2 once
   per collection step, finite losses, checkpoints with the optimizer
   state; collection env steps/s, train steps/s and rows/s, the run's
   host-phase split and peak memory; the trained checkpoint evaluated on
   the card over one tour per lane; (b) one train step of a batch of 5
   from that store, card against CPU: loss terms, every gradient, the map
   BatchNorm statistics pass; (c) LatentCMA (latent_cma_train.yaml, the
   ``dagger`` trainer): no mapper kernel, depth and RGB features stored;
   (d) 20 of (a)'s train steps traced, device time by range
   (train_encode, train_rnn, train_loss, backward, optimizer,
   map_bn_stats) and the busy share;
15. tour-BPTT training at full width (configs/fake/tour_cma_train.yaml:
   LatentCMA with its tour memory, the ``iterative_dagger`` trainer, as
   in phase 14 with ``TPU.async_checkpointing True``): (a) through
   ``run_exp(..., "train")``: the tours index at store key 0, one train
   step per ``TourSampler`` batch, no mapper kernel, the asynchronous
   checkpoint on disk bit for bit the trainer's final weights and
   optimizer state; collection env steps/s, train steps/s and rows/s,
   the host-phase split and peak memory; (b) two consecutive sampler
   batches of (a)'s store, a lane continuing its tour from the first
   into the second, on the card and on the CPU with the trained
   weights, each carrying its own RNN state from the first batch into
   the second: loss terms, carried states and every gradient;
16. ``TPU.compute_dtype bfloat16`` (the depth, RGB and map encoders and
   RedNet in bfloat16 on cast copies of their float32 weights): (a) the
   depth encoder (256^2), the map encoder, the RGB ResNet-50 (224^2),
   RedNet (256^2) and a full-width policy step of each family, each in
   float32 and in bfloat16 on the card and on the CPU: the card's
   bfloat16-vs-float32 error 0.1 to 2 times the CPU's, RedNet's labels
   unchanged where the float32 margin is sure; (b) the iterative,
   known-map and episodic evals (MapCMA, RxR) under bfloat16 through
   ``run_exp``, K1-K3 launching as in float32, the iterative one traced;
   (c) the predicted-semantics eval traced, the semantics range against
   RedNet's bfloat16 bound (989 TFLOP/s); (d) ``4_pool_end_cma`` traced,
   the RGB and depth ranges against their bfloat16 bounds; in every
   bfloat16 trace the convolution and matrix kernels of the bfloat16
   ranges compute in bfloat16 and those of gru_attention in float32 (by
   kernel name); device ms per range beside phases 7, 9 and 11's float32
   ones; (e) the three training configs under bfloat16: float32 stored
   features, checkpoints and optimizer state, and a float32 map encoder
   in the train step.

Prints the kernels as one JSON line and, last, the device as JSON.
Imports nothing of JAX.
"""

from __future__ import annotations

import bisect
import ctypes
import glob
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from collections import defaultdict

import numpy as np
import torch

CONFIG = "configs/fake/map_cma_eval_iterative.yaml"
KNOWN_CONFIG = "configs/fake/map_cma_eval_known.yaml"
EPISODIC_CONFIG = "configs/fake/map_cma_eval_episodic.yaml"
RXR_CONFIG = "configs/fake/rxr_eval.yaml"
# the latent baselines' evaluations
# (ivlnce_baselines/config/latent_baselines/*/1_eval.yaml) on the fake
# tour dataset: LatentCMA, no mapper transform, the iterative trainer
LATENT_OPTS = ("MODEL.policy_name", "LatentCMAPolicy",
               "RL.POLICY.OBS_TRANSFORMS.ENABLED_TRANSFORMS", "[]",
               "TRAINER_NAME", "iterative_dagger")
LATENT_VARIANTS = {  # flags, recurrent layers
    "1_cma": ((), 2),
    "2_tour_cma": (("MODEL.tour_memory", "True"), 2),
    "3_pool_cma": (("MODEL.tour_memory_variant", "True"), 3),
    "4_pool_end_cma": (("MODEL.tour_memory_variant", "True",
                        "MODEL.memory_at_end", "True"), 3),
}
KERNELS = ("accumulate", "rasterize", "known_load")
PREDICTED_OPTS = ["RL.POLICY.OBS_TRANSFORMS.ENABLED_TRANSFORMS",
                  "['PredictedSemanticsIterativeMapper']"]
KNOWN_POINTS = 2 ** 18  # TPU.known_map_max_points
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_FLOPS = 67e12  # H100 SXM, outside the tensor cores
# weights seed: seed 3's random policy walks forward from the first
# step, so episodes run and maps grow (seed 0's stops at once)
SEED = 3
# the RxR policy's: its random policy walks each episode's 30 steps
# (seed 3's stops after one or two, too few to tell an instruction
# encode per episode from one per step)
RXR_SEED = 1


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def ptxas_usage(log: str) -> dict:
    """``-Xptxas -v``'s resource lines (registers, shared memory, spills)
    of the current K1, K2 and K3 kernels, by kernel name."""
    wanted = [n for v in KERNEL_NAMES.values() for n in v]
    out, entry = {}, None
    for raw in log.splitlines():
        line = raw.strip()
        if "Compiling entry function" in line:
            entry = next((n for n in wanted if n in line), None)
        elif entry and ("stack frame" in line or "Used" in line):
            text = line.split(":", 1)[-1].strip() if "Used" in line else line
            out[entry] = f"{out[entry]}; {text}" if entry in out else text
    if set(out) != set(wanted):
        raise SystemExit(f"no ptxas resource lines for "
                         f"{sorted(set(wanted) - set(out))}")
    return out


# the card's busy wait before a timed call (ms), and its clock cycles per
# ms, measured once
SPIN_MS = 2.0
_spin_cycles_per_ms = None


def _spin(ms: float) -> None:
    """Keep the card busy for about ``ms`` ms (a kernel that spins for a
    number of clock cycles, calibrated on first use)."""
    global _spin_cycles_per_ms
    if _spin_cycles_per_ms is None:
        n = 1_000_000
        torch.cuda._sleep(n)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        torch.cuda._sleep(n)
        b.record()
        b.synchronize()
        _spin_cycles_per_ms = n / a.elapsed_time(b)
    torch.cuda._sleep(int(_spin_cycles_per_ms * ms))


def cuda_ms(fn, waits_on_card: bool = False) -> float:
    """Device time (ms) of one call of ``fn``, between two CUDA events.

    The card spins for SPIN_MS first, so the host has enqueued the whole
    call before the first event fires: the span holds device time only,
    not the wrappers' host work (a call enqueued on an idle card is timed
    from the moment the host began it). A call whose enqueue outlasts the
    spin fails the run. ``waits_on_card=True`` is for calls that wait on
    the card themselves (the plain versions' boolean indexing, host-to-
    device copies): they are timed without the spin, host work included."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    if not waits_on_card:
        _spin(SPIN_MS)
    a.record()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    b.record()
    b.synchronize()
    if not waits_on_card and host_ms >= SPIN_MS:
        raise SystemExit(f"enqueueing a timed call took {host_ms:.3f} ms, "
                         f"longer than the card's {SPIN_MS} ms spin")
    return a.elapsed_time(b)


# -- the seeded walk ----------------------------------------------------------
def walk(batch: int, hw: int, steps: int, seed: int):
    """Per-step mapper inputs: a walk with turns, a teleport at step 6
    (lane 0 jumps 30 m, so its later frames fall partly outside a 1024^2
    grid and are counted as dropped), a reset of lane 1 at step 8, and
    depths spanning the filters' edges."""
    rng = np.random.default_rng(seed)
    pose = np.zeros((batch, 3), np.float32)
    pose[:, 0] = rng.uniform(-5, 5, batch)
    pose[:, 1] = 1.25
    pose[:, 2] = rng.uniform(-5, 5, batch)
    heading = rng.uniform(0, 2 * np.pi, batch).astype(np.float32)
    for t in range(steps):
        depth = rng.uniform(0.0, 1.0, (batch, hw, hw)).astype(np.float32)
        sem = rng.integers(0, 13, (batch, hw, hw)).astype(np.uint8)
        elev = rng.uniform(-0.1, 0.1, batch).astype(np.float32)
        orient = np.stack([elev, heading], -1).astype(np.float32)
        masks = np.ones(batch, np.float32)
        if t == 8:
            masks[1] = 0.0
        yield depth, sem, pose.copy(), orient, masks
        pose[:, 0] += np.float32(0.2)
        pose[:, 2] -= np.float32(0.15)
        heading = (heading + np.float32(0.13)).astype(np.float32)
        if t == 5:
            pose[0, 0] += np.float32(30.0)


def mapper_params():
    from ivlnce_tpu_torch.mapping.camera import CameraParameters
    from ivlnce_tpu_torch.mapping.mapper import MapperParams

    return MapperParams(
        camera=CameraParameters(math.radians(90.0), (256, 256), 0.1),
        map_height_meters=6.4,
        map_width_meters=6.4,
        resolution_meters=0.1,
        grid_cells=1024,
        window_cells=192,
    )


def _max_abs(pairs) -> float:
    """Largest absolute difference over pairs of equal-shaped tensors;
    integers are compared exactly (an int64 grid word does not fit a
    float64)."""
    worst = 0.0
    for a, b in pairs:
        if a.dtype.is_floating_point:
            worst = max(worst, float((a - b).abs().max()))
            continue
        differ = a != b
        if bool(differ.any()):
            worst = max(worst, float(max(
                abs(x - y) for x, y in zip(a[differ].tolist(),
                                           b[differ].tolist()))))
    return worst


def phase_kernels_vs_plain(label, params, b, frames, need_drops) -> dict:
    """K1 and K2 against their plain versions at every step of a walk:
    the largest absolute difference over every output (0 = equal)."""
    from ivlnce_tpu_torch.mapping import mapper as M
    from ivlnce_tpu_torch.ops import scatter as S

    dev = torch.device("cuda")
    kern = M.init_state(b, params.grid_cells, dev)
    plain = M.init_state(b, params.grid_cells, dev)
    worst = {"accumulate": 0.0, "rasterize": 0.0}
    consts = (M.FRAME_DEPTH_MIN, M.FRAME_DEPTH_MAX, M.DEPTH_SCALE_METERS,
              params.half_res)
    rargs = (params.window_cells, params.map_dims, params.half_res)
    print(f"  {label}:")
    for t, (depth, sem, pose, orient, masks) in enumerate(frames):
        d = torch.from_numpy(depth).to(dev)
        s = torch.from_numpy(sem).to(dev)
        ik = M.step_inputs(params, kern, d, s, pose, orient, None, masks)
        ip = M.step_inputs(params, plain, d, s, pose, orient, None, masks)
        S.accumulate(kern.word, kern.aux, kern.dropped, ik.depth,
                     ik.semantics, ik.lane_acc, ik.origin, ik.rays_x,
                     ik.rays_y, *consts)
        S.accumulate_plain(plain.word, plain.aux, plain.dropped, ip.depth,
                           ip.semantics, ip.lane_acc, ip.origin, ip.rays_x,
                           ip.rays_y, *consts)
        torch.cuda.synchronize()
        k_err = _max_abs([(kern.word, plain.word), (kern.aux, plain.aux),
                          (kern.dropped, plain.dropped)])
        occ_k, sem_k = S.rasterize(kern.word, kern.aux, ik.start, ik.origin,
                                   ik.lane_ras, *rargs)
        occ_p, sem_p = S.rasterize_plain(plain.word, plain.aux, ip.start,
                                         ip.origin, ip.lane_ras, *rargs)
        torch.cuda.synchronize()
        r_err = _max_abs([(occ_k, occ_p), (sem_k, sem_p)])
        worst["accumulate"] = max(worst["accumulate"], k_err)
        worst["rasterize"] = max(worst["rasterize"], r_err)
        print(f"    step {t}: accumulate max abs diff {k_err}, rasterize max "
              f"abs diff {r_err}, occupied map cells {int(occ_k.sum())}, "
              f"dropped so far {int(kern.dropped.sum())}")
        if k_err or r_err:
            raise SystemExit(f"kernel disagrees with its plain version at "
                             f"step {t} of the {label}")
    if need_drops and int(kern.dropped.sum()) == 0:
        raise SystemExit(f"the {label} dropped no points: drop counting "
                         "untested")
    return worst


def phase_kernels_vs_plain_walks() -> dict:
    """Phase 3's K1 and K2 checks: the noise walk and the FakeSim walk at
    B=16 and main-path shapes, then the tie frames at main-path shapes
    (B=3, a lane that sees nothing) and at ragged sizes (B=1, 40^2 frames
    against 32^2 tiles, G=256, a 100-cell window: 100 rows over an 8-block
    cluster)."""
    from ivlnce_tpu_torch.mapping import walks
    from ivlnce_tpu_torch.mapping.camera import CameraParameters
    from ivlnce_tpu_torch.mapping.mapper import MapperParams

    params = mapper_params()
    ragged = MapperParams(
        camera=CameraParameters(math.radians(90.0), (40, 40), 0.1),
        map_height_meters=6.4, map_width_meters=6.4, resolution_meters=0.1,
        grid_cells=256, window_cells=100)
    runs = [
        ("noise walk (B=16)", params, 16, walk(16, 256, 12, seed=0), True),
        ("FakeSim walk (B=16)", params, 16,
         walks.fakesim_walk(16, 256, 12, seed=0), False),
        ("tie frames (B=3, lane 2 empty)", params, 3,
         walks.tie_walk(3, 256, 10, seed=0, edge_step=6.0,
                        empty_lanes=(2,)), True),
        ("tie frames (B=1, 40^2 frames, window 100 of G=256)", ragged, 1,
         walks.tie_walk(1, 40, 10, seed=1, edge_step=2.0), True),
    ]
    worst = {"accumulate": 0.0, "rasterize": 0.0}
    for label, p, b, frames, need_drops in runs:
        got = phase_kernels_vs_plain(label, p, b, frames, need_drops)
        for k in worst:
            worst[k] = max(worst[k], got[k])
    return worst


def _k1_cells(inp, params) -> int:
    """Distinct grid cells the frame's kept points land in (each one's
    word must be read once)."""
    from ivlnce_tpu_torch.mapping import mapper as M
    from ivlnce_tpu_torch.ops import geometry as G
    from ivlnce_tpu_torch.ops import scatter as S

    pts = S.world_points(inp.depth, inp.lane_acc, inp.rays_x, inp.rays_y,
                         M.DEPTH_SCALE_METERS)
    b = pts.shape[0]
    g = params.grid_cells
    d = inp.depth.reshape(b, -1)
    hy = pts[:, :, 1]
    valid = ((d > M.FRAME_DEPTH_MIN) & (d < M.FRAME_DEPTH_MAX)
             & (hy > inp.lane_acc[:, 12:13]) & (hy < inp.lane_acc[:, 13:14]))
    inv = G.f32_reciprocal(params.half_res)
    r = torch.round(pts[:, :, 2] * inv).long() - inp.origin[:, 0:1]
    c = torch.round(pts[:, :, 0] * inv).long() - inp.origin[:, 1:2]
    valid &= (r >= 0) & (r < g) & (c >= 0) & (c < g)
    lane = torch.arange(b, device=pts.device)[:, None]
    return int(torch.unique(((lane * g + r) * g + c)[valid]).numel())


def _k2_in_height(state, inp, params) -> int:
    """Stored points inside the lanes' raster windows whose height lies in
    the map's height window: the only ones whose payload must be read."""
    from ivlnce_tpu_torch.ops import scatter as S

    wc = params.window_cells
    n = 0
    for i in range(state.word.shape[0]):
        r0, c0 = (int(v) for v in inp.start[i])
        key = (state.word[i, r0:r0 + wc, c0:c0 + wc] >> 32).to(torch.int32)
        height = S.float_from_sortable(key)
        lo, hi = inp.lane_ras[i, 5], inp.lane_ras[i, 6]
        n += int(((key != S.EMPTY_KEY) & (height > lo) & (height < hi)).sum())
    return n


# K1 and K2 launchers: the wrappers (kernels on CUDA tensors) and the
# plain versions
def _designs() -> dict:
    from ivlnce_tpu_torch.ops import scatter as S

    return {
        "current": (S.accumulate, S.rasterize),
        "plain": (S.accumulate_plain, S.rasterize_plain),
    }


# the CUDA kernels each op launches
KERNEL_NAMES = {
    "accumulate": ("accumulate_tile_max", "accumulate_tile_commit"),
    "rasterize": ("rasterize_cluster",),
    "known_load": ("known_bin_scatter", "known_tile_load"),
}


def _step_ops(params, states, frame):
    """Per design: the step's inputs (built on that design's state) and
    the K1 and K2 calls on them."""
    from ivlnce_tpu_torch.mapping import mapper as M

    depth, sem, pose, orient, masks = frame
    dev = torch.device("cuda")
    d = torch.from_numpy(depth).to(dev)
    s = torch.from_numpy(sem).to(dev)
    consts = (M.FRAME_DEPTH_MIN, M.FRAME_DEPTH_MAX, M.DEPTH_SCALE_METERS,
              params.half_res)
    rargs = (params.window_cells, params.map_dims, params.half_res)
    ops = {}
    for name, (acc, ras) in _designs().items():
        if name not in states:
            continue
        st = states[name]
        inp = M.step_inputs(params, st, d, s, pose, orient, None, masks)
        ops[name] = (
            inp,
            lambda acc=acc, st=st, inp=inp: acc(
                st.word, st.aux, st.dropped, inp.depth, inp.semantics,
                inp.lane_acc, inp.origin, inp.rays_x, inp.rays_y, *consts),
            lambda ras=ras, st=st, inp=inp: ras(
                st.word, st.aux, inp.start, inp.origin, inp.lane_ras,
                *rargs),
        )
    return ops


def trace_kernels(fn) -> dict:
    """Device ms of each kernel launch of one call of ``fn`` traced by
    ``torch.profiler``, by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    durs = defaultdict(list)
    for ev in events:
        if ev.get("cat") == "kernel":
            durs[ev.get("name", "")].append(ev["dur"] / 1e3)
    return durs


def complete_trace(fn, names, launches: int, attempts: int = 3) -> dict:
    """``trace_kernels(fn)`` holding ``launches`` launches of each kernel
    whose name holds one of ``names``. The tracer has been seen to miss a
    few launches of a call (3 of 12 K1 and 2 of 12 K2 launches of a B=3
    walk, once), so an incomplete trace is taken again with a fresh call,
    up to ``attempts`` times; ``fn`` must give the same launches each
    call."""
    for _ in range(attempts):
        traced = trace_kernels(fn)
        counts = {n: sum(len(v) for name, v in traced.items() if n in name)
                  for n in names}
        print(f"    traced launches {counts}, expected {launches} of each")
        if all(c == launches for c in counts.values()):
            return traced
    raise SystemExit(f"no complete trace in {attempts} attempts")


def traced_kernel_ms(fn, names, launches: int) -> dict:
    """Median device ms per launch of each kernel whose name holds one of
    ``names``, over one call of ``fn`` traced by ``torch.profiler``, which
    must launch each ``launches`` times."""
    durs = defaultdict(list)
    for name, v in complete_trace(fn, names, launches).items():
        for n in names:
            if n in name:
                durs[n] += v
    return {n: float(np.median(durs[n])) for n in names}


def time_walk(card: str, label: str, frames: list, yardstick: bool) -> dict:
    """K1 and K2 over a walk (median of the steps after the first): the
    kernels (K2 twice per step, the mean), the plain versions, the least
    time the card could take for the same work (bytes over 3.35 TB/s or
    float32 operations over 67 TFLOP/s, the larger), for K1 at B=64 a
    partial yardstick (one ``scatter_reduce_`` amax of the frame's packed
    keys, without filters or payload), and each kernel timed apart by
    ``torch.profiler`` over a replay of the walk. The kernels' grids and
    maps must equal the plain versions' at every step."""
    from ivlnce_tpu_torch.mapping import mapper as M

    params = mapper_params()
    dev = torch.device("cuda")
    b = frames[0][0].shape[0]
    n_map = params.map_dims.num_rows * params.map_dims.num_cols
    times = {op: {d: [] for d in ("current", "plain")}
             for op in ("accumulate", "rasterize")}
    work = {op: {"bytes": [], "flops": []} for op in times}
    yard = []
    states = {d: M.init_state(b, params.grid_cells, dev)
              for d in ("current", "plain")}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for t, frame in enumerate(frames):
        ops = _step_ops(params, states, frame)
        inp = ops["current"][0]
        st = states["current"]
        n_pix = inp.depth.numel()
        touched = _k1_cells(inp, params)
        before = st.word.clone()
        if yardstick:
            flat = st.word.clone().view(-1)
            words = torch.randint(0, 2 ** 62, (n_pix,), device=dev,
                                  generator=gen)
            idx = torch.randint(0, flat.numel(), (n_pix,), device=dev,
                                generator=gen)
            yard.append(cuda_ms(
                lambda: flat.scatter_reduce_(0, idx, words, "amax")))
            del flat
        times["accumulate"]["current"].append(cuda_ms(ops["current"][1]))
        times["accumulate"]["plain"].append(
            cuda_ms(ops["plain"][1], waits_on_card=True))
        # each pixel's depth and label read once; the word of each cell a
        # kept point lands in read once; word and payload written once
        # where a new point won the cell; the lane constants, rays and
        # drop counts
        changed = int((st.word != before).sum())
        del before
        work["accumulate"]["bytes"].append(
            n_pix * 5 + touched * 8 + changed * 12
            + (inp.lane_acc.numel() + inp.rays_x.numel()
               + inp.rays_y.numel()) * 4 + b * 4 * 2)
        work["accumulate"]["flops"].append(n_pix * 40)
        times["rasterize"]["current"].append(float(np.mean(
            [cuda_ms(ops["current"][2]) for _ in range(2)])))
        times["rasterize"]["plain"].append(
            cuda_ms(ops["plain"][2], waits_on_card=True))
        # every window cell's word read once, the payload of each stored
        # point in the height window, both maps written once; about 30
        # float32 operations to place each such point
        in_height = _k2_in_height(st, inp, params)
        work["rasterize"]["bytes"].append(
            b * params.window_cells ** 2 * 8 + in_height * 4 + 2 * b * n_map)
        work["rasterize"]["flops"].append(in_height * 30)
        occ_c, sem_c = ops["current"][2]()
        occ_p, sem_p = ops["plain"][2]()
        c, p = states["current"], states["plain"]
        if not (torch.equal(c.word, p.word) and torch.equal(c.aux, p.aux)
                and torch.equal(c.dropped, p.dropped)
                and torch.equal(occ_c, occ_p) and torch.equal(sem_c, sem_p)):
            raise SystemExit(f"the kernels and the plain versions disagree "
                             f"at step {t} of the {label}")
    del states

    # each kernel apart, over a replay of the walk from empty grids
    replay = {}

    def run():
        replay["current"] = M.init_state(b, params.grid_cells, dev)
        for f in frames:
            ops = _step_ops(params, replay, f)
            ops["current"][1]()
            ops["current"][2]()

    names = KERNEL_NAMES["accumulate"] + KERNEL_NAMES["rasterize"]
    passes = traced_kernel_ms(run, names, len(frames))
    del replay

    result = {"walk": label, "lanes": b, "steps": len(frames)}
    for op, by in times.items():
        ms = {d: float(np.median(v[1:])) for d, v in by.items()}
        by_bytes = float(np.median(work[op]["bytes"])) / HBM_BYTES_PER_S * 1e3
        by_ops = float(np.median(work[op]["flops"])) / FP32_FLOPS * 1e3
        bound = max(by_bytes, by_ops)
        result[op] = {
            "ms": ms["current"], "plain_ms": ms["plain"], "bound_ms": bound,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "x_bound": ms["current"] / bound,
            "pass_ms": {n: passes[n] for n in KERNEL_NAMES[op]},
        }
        r = result[op]
        print(f"  {op}, {label} [{card}]: {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {bound:.4f} ms "
              f"({r['bound_by']}; {r['x_bound']:.1f}x); kernels, profiler "
              f"median: {r['pass_ms']}")
    result["accumulate"]["yardstick_ms"] = (
        float(np.median(yard[1:])) if yard else None)
    result["rasterize"]["yardstick_ms"] = None
    if yard:
        print(f"  accumulate yardstick, {label} [{card}]: one "
              f"scatter_reduce_ amax of the frame's packed keys, no filters "
              f"or payload (partial): "
              f"{result['accumulate']['yardstick_ms']:.4f} ms")
    return result


def warm_up() -> None:
    """Launch every timed kernel once at a tiny size. A kernel's first
    launch loads its module (CUDA loads them lazily), milliseconds of host
    time that no timed call may see."""
    from ivlnce_tpu_torch.mapping import clouds
    from ivlnce_tpu_torch.mapping import mapper as M
    from ivlnce_tpu_torch.mapping.camera import CameraParameters
    from ivlnce_tpu_torch.mapping.mapper import MapperParams

    dev = torch.device("cuda")
    params = MapperParams(
        camera=CameraParameters(math.radians(90.0), (32, 32), 0.1),
        map_height_meters=6.4, map_width_meters=6.4, resolution_meters=0.1,
        grid_cells=256, window_cells=192)
    states = {"current": M.init_state(1, 256, dev)}
    ops = _step_ops(params, states, next(walk(1, 32, 1, seed=0)))
    ops["current"][1]()
    ops["current"][2]()
    load = next(clouds.edge_cases()).loads[0]
    args = _known_args(load, known_params(128), dev)
    _known_op(M.init_state(2, 128, dev), *args, 0.05)()
    flat = torch.zeros(16, dtype=torch.int64, device=dev)
    flat.scatter_reduce_(0, torch.zeros(4, dtype=torch.int64, device=dev),
                         torch.ones(4, dtype=torch.int64, device=dev), "amax")
    torch.cuda.synchronize()


def phase_timing(card: str) -> dict:
    """K1 and K2 at B=64 and B=3 on the noise walk (i.i.d. depths: every
    pixel in an unrelated cell) and on the FakeSim walk (the frames the
    evaluations render: smooth, a wall column's pixels in one cell), 12
    steps each, 256^2 frames, G=1024."""
    from ivlnce_tpu_torch.mapping import walks

    warm_up()
    out = {}
    for b in (64, 3):
        t0 = time.perf_counter()
        fake = list(walks.fakesim_walk(b, 256, 12, seed=1))
        print(f"  FakeSim walk at B={b} rendered in "
              f"{time.perf_counter() - t0:.2f} s")
        for kind, frames in (("noise", list(walk(b, 256, 12, seed=1))),
                             ("fakesim", fake)):
            label = f"{kind} walk B={b}"
            out[f"{kind}_b{b}"] = time_walk(card, label, frames,
                                            yardstick=b == 64)
    return out


# -- K3: the known-map load --------------------------------------------------
def known_clouds(batch: int, n: int, seed: int):
    """Seeded clouds shaped like scanned walls: each (x, z) at four
    heights. A quarter of the (x, z) fall in a 4 m square, so cells hold
    runs of equal heights; the rest spread over 54 m, so about a tenth lie
    past a 1024^2 grid centred on the origin and are dropped."""
    rng = np.random.default_rng(seed)
    q = n // 4
    xz = rng.uniform(-27.0, 27.0, (batch, q, 2)).astype(np.float32)
    xz[:, : q // 4] = rng.uniform(-2.0, 2.0, (batch, q // 4, 2))
    xyz = np.empty((batch, n, 3), np.float32)
    for k, y in enumerate((0.2, 0.5, 0.8, 1.1)):
        xyz[:, k * q:(k + 1) * q, 0] = xz[..., 0]
        xyz[:, k * q:(k + 1) * q, 1] = y
        xyz[:, k * q:(k + 1) * q, 2] = xz[..., 1]
    sem = rng.integers(0, 13, (batch, n)).astype(np.uint8)
    return xyz, sem


def known_params(grid: int):
    """``mapper_params()`` with a G x G grid (the window no wider)."""
    return mapper_params()._replace(grid_cells=grid,
                                    window_cells=min(192, grid))


def load_known(params, state, lanes, xyz, sem, counts, centers, plain):
    """``mapping.mapper.load_lanes`` with the kernel, or the same host
    steps with K3's plain version."""
    from ivlnce_tpu_torch.mapping import mapper as M
    from ivlnce_tpu_torch.ops import scatter as S

    if not plain:
        return M.load_lanes(params, state, lanes, xyz, sem, counts, centers)
    rows, origin = M.prepare_load(params, state, lanes, centers)
    S.known_load_plain(state.word, state.aux, state.dropped, rows, origin,
                       xyz, sem, counts, params.half_res)
    return state


def check_known_loads(label, params, batch, loads):
    """Each load through ``load_lanes`` (K3) and through the same host
    steps with K3's plain version on the card, into ``batch``-row states:
    the largest absolute difference over word, aux and dropped after each
    load (it must be 0), and the kernel's state."""
    from ivlnce_tpu_torch.mapping import mapper as M
    from ivlnce_tpu_torch.ops import scatter as S

    dev = torch.device("cuda")
    states = {p: M.init_state(batch, params.grid_cells, dev)
              for p in (False, True)}
    worst = 0.0
    for t, load in enumerate(loads):
        args = (torch.from_numpy(load.xyz).to(dev),
                torch.from_numpy(load.sem).to(dev),
                torch.from_numpy(load.counts).to(dev), load.centers)
        for plain, st in states.items():
            load_known(params, st, load.lanes, *args, plain=plain)
        torch.cuda.synchronize()
        kern, ref = states[False], states[True]
        err = _max_abs([(kern.word, ref.word), (kern.aux, ref.aux),
                        (kern.dropped, ref.dropped)])
        worst = max(worst, err)
        print(f"  {label}, load {t} into rows {load.lanes.tolist()[:8]}"
              f"{'...' if len(load.lanes) > 8 else ''}: known_load max abs "
              f"diff {err}, stored cells "
              f"{int((kern.word != S.EMPTY_WORD).sum())}, dropped so far "
              f"{int(kern.dropped.sum())}")
        if err:
            raise SystemExit(f"known_load disagrees with its plain version "
                             f"at load {t} of {label}")
    return worst, states[False]


def phase_known_vs_plain() -> float:
    """K3 against its plain version: two loads at B=16, 2^18 points per
    cloud, G=1024 (all lanes, then a seeded subset, so stale rows are
    reloaded; counts vary per lane); the edge cases of the tiled design
    (``mapping/clouds.py``); the fake val_seen clouds at L=3 and L=1,
    G=1024, each loaded twice. The largest absolute difference over word,
    aux and dropped."""
    from ivlnce_tpu_torch.mapping import clouds

    params = mapper_params()
    b, n = 16, KNOWN_POINTS
    rng = np.random.default_rng(4)
    loads = []
    for t, mask in enumerate((np.ones(b, bool), rng.random(b) < 0.5)):
        lanes = np.nonzero(mask)[0]
        xyz, sem = known_clouds(len(lanes), n, seed=10 + t)
        counts = rng.integers(n // 2, n + 1, len(lanes)).astype(np.int32)
        centers = rng.uniform(-1.0, 1.0, (len(lanes), 2)).astype(np.float32)
        loads.append(clouds.Load(lanes, xyz, sem, counts, centers))
    worst, kern = check_known_loads("B=16", params, b, loads)
    if int(kern.dropped.sum()) == 0:
        raise SystemExit("the clouds dropped no points: drop counting "
                         "untested")
    del kern
    for case in clouds.edge_cases():
        err, _ = check_known_loads(case.name, known_params(case.grid),
                                   case.batch, case.loads)
        worst = max(worst, err)
    for lanes in (3, 1):
        load = clouds.val_seen_clouds(".", lanes)
        err, _ = check_known_loads(f"val_seen L={lanes}", params, lanes,
                                   (load, load))
        worst = max(worst, err)
    return worst


def _known_words(xyz, counts, origin, g, half):
    """Flat grid cells and packed words of the points K3 may store (on
    the grid, within the counts)."""
    from ivlnce_tpu_torch.ops import geometry as G
    from ivlnce_tpu_torch.ops import scatter as S

    l, n, _ = xyz.shape
    inv = G.f32_reciprocal(half)
    r = torch.round(xyz[:, :, 2] * inv).long() - origin[:, 0:1].long()
    c = torch.round(xyz[:, :, 0] * inv).long() - origin[:, 1:2].long()
    j = torch.arange(n, device=xyz.device)
    keep = ((j[None] < counts[:, None]) & (r >= 0) & (r < g) & (c >= 0)
            & (c < g))
    lane = torch.arange(l, device=xyz.device)[:, None]
    cell = ((lane * g + r) * g + c)[keep]
    word = ((S.sortable_from_float(xyz[:, :, 1]).long() << 32)
            | (0xFFFFFFFE - j)[None])[keep]
    return cell, word


def _known_args(load, params, dev) -> tuple:
    """A load's K3 arguments on the card: rows, origins (grids centred on
    the load's centres), xyz, labels, counts."""
    from ivlnce_tpu_torch.mapping import mapper as M

    origin = M._grid_origins(load.centers[:, 0], load.centers[:, 1], params)
    return (torch.from_numpy(load.lanes.astype(np.int32)).to(dev),
            torch.from_numpy(origin).to(dev),
            torch.from_numpy(load.xyz).to(dev),
            torch.from_numpy(load.sem).to(dev),
            torch.from_numpy(load.counts).to(dev))


def _known_op(state, rows, origin, xyz, sem, counts, half, plain=False):
    """One whole load into ``state``'s rows ``rows``, as a call: K3 (which
    clears the rows itself) or the plain version."""
    from ivlnce_tpu_torch.ops import scatter as S

    args = (state.word, state.aux, state.dropped, rows, origin, xyz, sem,
            counts, half)
    if plain:
        return lambda: S.known_load_plain(*args)
    return lambda: S.known_load(*args)


def _peak_bytes(fn) -> int:
    """Device memory one call of ``fn`` allocates at its peak, beyond what
    was allocated before it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def time_known_load(card: str, label: str, params, load) -> dict:
    """One whole load (an untimed one, then the median of six timed ones
    after the first) of K3 and of the plain version, each on its own
    state; the two states must be equal. Then K3's kernels apart
    (``torch.profiler``) and their sum, the load's device time; the peak
    memory it allocates; a partial yardstick (one ``scatter_reduce_``
    amax of the points' packed words into an empty grid, without payload
    or clear); and two byte bounds over 3.35 TB/s. The bound of the whole
    load charges what the JAX function's result must hold: 12 bytes read
    per point within the counts (its xyz), the winners' label bytes, 12
    bytes written per cell of every loaded row (word and payload), the
    rows, counts and origins read and the drop counts written. The
    touched-cells bound charges 8 bytes read per touched cell and 12
    written per stored cell in place of the rows (a load into rows
    cleared beforehand)."""
    from ivlnce_tpu_torch.mapping import mapper as M
    from ivlnce_tpu_torch.ops import scatter as S

    dev = torch.device("cuda")
    g, half = params.grid_cells, params.half_res
    rows, origin, xyz, sem, counts = _known_args(load, params, dev)
    lanes, n = sem.shape
    states = {d: M.init_state(lanes, g, dev) for d in ("ms", "plain_ms")}
    ops = {d: _known_op(st, rows, origin, xyz, sem, counts, half,
                        plain=d == "plain_ms")
           for d, st in states.items()}
    cell, word = _known_words(xyz, counts, origin, g, half)
    touched = int(torch.unique(cell).numel())
    times = {d: [] for d in ("ms", "plain_ms", "yardstick_ms")}
    # one load of each first, untimed: the first allocation of a size
    # (the scratch, 16 bytes per point) reaches cudaMalloc, which no timed
    # enqueue may wait on
    for op in ops.values():
        op()
    for _ in range(6):
        times["ms"].append(cuda_ms(ops["ms"]))
        times["plain_ms"].append(cuda_ms(ops["plain_ms"], waits_on_card=True))
        flat = torch.full((lanes * g * g,), S.EMPTY_WORD, dtype=torch.int64,
                          device=dev)
        times["yardstick_ms"].append(cuda_ms(
            lambda: flat.scatter_reduce_(0, cell, word, "amax")))
        del flat
    torch.cuda.synchronize()
    new, plain = states["ms"], states["plain_ms"]
    if not (torch.equal(new.word, plain.word)
            and torch.equal(new.aux, plain.aux)
            and torch.equal(new.dropped, plain.dropped)):
        raise SystemExit(f"the known-map loads disagree at {label}")
    stored = int((new.word != S.EMPTY_WORD).sum())
    del states["plain_ms"], plain, ops["plain_ms"]

    reps = 5
    passes = traced_kernel_ms(lambda: [ops["ms"]() for _ in range(reps)],
                              KERNEL_NAMES["known_load"], reps)
    peak = _peak_bytes(ops["ms"])

    valid = int(counts.clamp(0, n).sum())
    small = lanes * 4 * 5
    whole = valid * 12 + stored + lanes * g * g * 12 + small
    touched_bytes = valid * 12 + touched * 8 + stored * 13 + small
    result = {k: float(np.median(v[1:])) for k, v in times.items()}
    result.update({
        "lanes": lanes, "points": valid, "grid": g,
        "bound_ms": whole / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "bytes": whole,
        "touched_bound_ms": touched_bytes / HBM_BYTES_PER_S * 1e3,
        "touched_bytes": touched_bytes, "touched_cells": touched,
        "stored_cells": stored, "pass_ms": passes,
        "device_ms": sum(passes.values()), "peak_bytes": peak,
    })
    result["x_bound"] = result["ms"] / result["bound_ms"]
    r = result
    print(f"  known_load, {label}: {lanes} rows of G={g}, {valid} points "
          f"[{card}]: whole load {r['ms']:.4f} ms (its kernels summed "
          f"{r['device_ms']:.4f}), plain {r['plain_ms']:.4f} ms; bound of "
          f"the whole load {r['bound_ms']:.4f} ms ({whole} bytes, "
          f"{r['x_bound']:.2f}x), touched-cells bound "
          f"{r['touched_bound_ms']:.4f} ms ({touched} touched, {stored} "
          f"stored cells); yardstick scatter_reduce_ amax (partial) "
          f"{r['yardstick_ms']:.4f} ms")
    print(f"    kernels, profiler median of {reps} [{card}]: {passes}; peak "
          f"memory {peak} bytes")
    return result


def phase_known_timing(card: str) -> dict:
    """K3 at B=64, 2^18 points per cloud (seeded clouds, ``known_clouds``)
    and at the known-map evaluation's size (the fake val_seen clouds at
    L=3 and L=1), G=1024: ``time_known_load``."""
    from ivlnce_tpu_torch.mapping import clouds

    params = mapper_params()
    b = 64
    xyz, sem = known_clouds(b, KNOWN_POINTS, seed=20)
    full = clouds.Load(np.arange(b), xyz, sem,
                       np.full(b, KNOWN_POINTS, np.int32),
                       np.zeros((b, 2), np.float32))
    out = {"b64": time_known_load(card, "B=64", params, full)}
    del full, xyz, sem
    for lanes in (3, 1):
        out[f"val_seen_l{lanes}"] = time_known_load(
            card, f"val_seen L={lanes}", params,
            clouds.val_seen_clouds(".", lanes))
    return out


def seeded_policy(config):
    """The MapCMA policy at the config's widths, weights from ``SEED``."""
    from ivlnce_tpu_torch.models.policy import MapCMAPolicy

    mapper = config.RL.POLICY.OBS_TRANSFORMS.EGOCENTRIC_MAPPER
    info = {
        "depth_hw": config.TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.HEIGHT,
        "map_hw": int(math.ceil(mapper.height_meters
                                / mapper.resolution_meters)),
    }
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        return MapCMAPolicy.from_config(config, info)


def phase_reference(card: str) -> dict:
    """Two full-width mapper + policy steps on the card and on the CPU
    from the same inputs. Maps must be equal; logits and RNN states agree
    to 1e-4 (float32 on both sides, TF32 off, sums in other orders)."""
    from ivlnce_tpu_torch.config import get_config
    from ivlnce_tpu_torch.mapping import mapper as M

    config = get_config(CONFIG)
    params = mapper_params()
    cpu_policy = seeded_policy(config).eval()
    gpu_policy = seeded_policy(config).cuda().eval()
    b = 2
    rng = np.random.default_rng(SEED)
    tokens = np.zeros((b, 200), np.int64)
    tokens[:, :24] = rng.integers(1, 32, (b, 24))
    sides = {}
    for dev in ("cpu", "cuda"):
        policy = cpu_policy if dev == "cpu" else gpu_policy
        state = M.init_state(b, params.grid_cells, dev)
        rnn = policy.initial_rnn_states(b, dev)
        prev = torch.zeros(b, 1, dtype=torch.int64, device=dev)
        outs = []
        for t, (depth, sem, pose, orient, masks) in enumerate(
            walk(b, 256, 2, seed=2)
        ):
            d = torch.from_numpy(depth).to(dev)
            _, occ, smap = M.mapper_step(
                params, state, d, torch.from_numpy(sem).to(dev), pose,
                orient, None, masks)
            obs = {"instruction": torch.from_numpy(tokens).to(dev),
                   "depth": d[..., None], "occupancy_map": occ,
                   "semantic_map": smap}
            m = torch.full((b, 1), float(t > 0), device=dev)
            with torch.no_grad():
                out = policy.act_iterative(obs, rnn, prev, m, m, m,
                                           torch.ones_like(m))
            rnn, prev = out.rnn_states, out.actions
            outs.append([x.cpu() for x in (occ, smap, out.logits,
                                           out.rnn_states, out.actions)])
        sides[dev] = outs
    worst = {"maps": 0.0, "logits": 0.0, "rnn": 0.0}
    for c, g in zip(sides["cpu"], sides["cuda"]):
        worst["maps"] = max(worst["maps"], _max_abs(zip(c[:2], g[:2])))
        worst["logits"] = max(worst["logits"], _max_abs([(c[2], g[2])]))
        worst["rnn"] = max(worst["rnn"], _max_abs([(c[3], g[3])]))
    print(f"  card vs CPU [{card}]: {worst}")
    if worst["maps"] != 0 or worst["logits"] > 1e-4 or worst["rnn"] > 1e-4:
        raise SystemExit("the card's step disagrees with the CPU's")
    return worst


def randomize_norm_statistics(policy) -> None:
    """BatchNorm statistics and affines far from a fresh init's (mean 0,
    var 1, scale 1, bias 0), from torch's global generator."""
    with torch.no_grad():
        for mod in policy.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.normal_(0.0, 0.2)
                mod.running_var.uniform_(0.5, 2.0)
                mod.weight.uniform_(0.5, 1.5)
                mod.bias.normal_(0.0, 0.1)


def latent_config(flags=()):
    from ivlnce_tpu_torch.config import get_config

    return get_config(CONFIG, list(LATENT_OPTS) + list(flags))


def seeded_latent_policy(config, seed=SEED):
    """The LatentCMA policy at the config's widths, weights and BatchNorm
    statistics from ``seed``."""
    from ivlnce_tpu_torch.models.policy import LatentCMAPolicy

    info = {"depth_hw": config.TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.HEIGHT,
            "map_hw": 0}
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        policy = LatentCMAPolicy.from_config(config, info)
        randomize_norm_statistics(policy)
    return policy


def phase_latent_reference(card: str) -> dict:
    """Three full-width LatentCMA steps of each tour-memory variant on the
    card and on the CPU from the same inputs (224^2 RGB, 256^2 depth, R2R
    tokens, hidden 512): lane 0 ends its tour after step 1, so step 2
    clears its memory slot. Logits and RNN states agree to 1e-4 (float32
    on both sides, TF32 off)."""
    b = 2
    rng = np.random.default_rng(SEED)
    tokens = np.zeros((b, 200), np.int64)
    tokens[:, :24] = rng.integers(1, 32, (b, 24))
    frames = [(rng.uniform(0, 1, (b, 256, 256, 1)).astype(np.float32),
               rng.integers(0, 256, (b, 224, 224, 3)).astype(np.uint8))
              for _ in range(3)]
    lane0_tour = ([0, 0], [0, 1], [1, 1])  # (lane 0, lane 1) per step
    out = {}
    for variant, (flags, layers) in LATENT_VARIANTS.items():
        config = latent_config(flags)
        cpu_policy = seeded_latent_policy(config).eval()
        gpu_policy = seeded_latent_policy(config).cuda().eval()
        if cpu_policy.num_recurrent_layers != layers:
            raise SystemExit(f"{variant}: {cpu_policy.num_recurrent_layers} "
                             f"recurrent layers, not {layers}")
        sides = {}
        for dev, policy in (("cpu", cpu_policy), ("cuda", gpu_policy)):
            rnn = policy.initial_rnn_states(b, dev)
            prev = torch.zeros(b, 1, dtype=torch.int64, device=dev)
            outs = []
            for (depth, rgb), m in zip(frames, lane0_tour):
                obs = {"instruction": torch.from_numpy(tokens).to(dev),
                       "depth": torch.from_numpy(depth).to(dev),
                       "rgb": torch.from_numpy(rgb).to(dev)}
                mask = torch.tensor(m, dtype=torch.float32,
                                    device=dev).reshape(b, 1)
                with torch.no_grad():
                    step = policy.act_iterative(obs, rnn, prev, mask, mask,
                                                mask, torch.ones_like(mask))
                rnn, prev = step.rnn_states, step.actions
                outs.append([x.cpu() for x in (step.logits, step.rnn_states)])
            sides[dev] = outs
        worst = {
            "logits": _max_abs((c[0], g[0]) for c, g in zip(sides["cpu"],
                                                            sides["cuda"])),
            "rnn": _max_abs((c[1], g[1]) for c, g in zip(sides["cpu"],
                                                         sides["cuda"])),
            "largest_logit": max(float(c[0].abs().max())
                                 for c in sides["cpu"]),
        }
        worst["logits_over_largest"] = worst["logits"] / worst["largest_logit"]
        print(f"  LatentCMA {variant} ({layers} recurrent layers), 3 steps "
              f"card vs CPU [{card}]: {worst}")
        if worst["logits"] > 1e-4 or worst["rnn"] > 1e-4:
            raise SystemExit(f"the card's LatentCMA {variant} steps "
                             "disagree with the CPU's")
        out[variant] = worst
    return out


def phase_rxr_reference(card: str) -> float:
    """The RxR instruction encoder (no embedding, a 768-wide bi-LSTM
    input) on 512 x 768 features of two lanes with ragged lengths, on the
    card and on the CPU: features agree to 1e-4."""
    from ivlnce_tpu_torch.config import get_config
    from ivlnce_tpu_torch.models.instruction_encoder import InstructionEncoder

    # per-token features, as the CMA nets force them
    config = get_config(RXR_CONFIG, [
        "MODEL.INSTRUCTION_ENCODER.final_state_only", "False",
    ]).MODEL.INSTRUCTION_ENCODER
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        cpu_enc = InstructionEncoder(config).eval()
    gpu_enc = InstructionEncoder(config).cuda().eval()
    gpu_enc.load_state_dict(cpu_enc.state_dict())
    rng = np.random.default_rng(SEED)
    feats = rng.normal(0, 1, (2, 512, 768)).astype(np.float32)
    feats[0, 300:] = 0
    feats[1, 97:] = 0
    with torch.no_grad():
        ref = cpu_enc({"rxr_instruction": torch.from_numpy(feats)})
        got = gpu_enc({"rxr_instruction": torch.from_numpy(feats).cuda()})
    err = _max_abs([(ref, got.cpu())])
    print(f"  RxR encode (2, 512, 768) card vs CPU [{card}]: features "
          f"{tuple(got.shape)}, max abs diff {err}")
    if err > 1e-4 or tuple(got.shape) != (2, 2 * config.hidden_size, 512):
        raise SystemExit("the card's RxR encode disagrees with the CPU's")
    return err


def phase_known_reference(card: str) -> int:
    """The fake val_seen scenes' known maps preloaded into three lanes,
    then three mapper steps without accumulation, on the card (K3, K2)
    and on the CPU (plain versions): grids and maps must be equal."""
    from ivlnce_tpu_torch.mapping import mapper as M
    from ivlnce_tpu_torch.mapping.clouds import val_seen_clouds

    params = mapper_params()
    load = val_seen_clouds(".", 3)
    sides = {}
    for dev in ("cpu", "cuda"):
        state = M.init_state(3, params.grid_cells, dev)
        outs = []
        for t, (depth, _, pose, orient, _) in enumerate(walk(3, 256, 3, 5)):
            if t == 0:
                M.load_lanes(params, state, load.lanes,
                             torch.from_numpy(load.xyz).to(dev),
                             torch.from_numpy(load.sem).to(dev),
                             torch.from_numpy(load.counts).to(dev),
                             pose[:, [0, 2]])
            _, occ, smap = M.mapper_step(
                params, state, torch.from_numpy(depth).to(dev), None, pose,
                orient, None, np.ones(3, np.float32), update_world=False)
            outs += [occ.cpu(), smap.cpu()]
        sides[dev] = outs + [state.word.cpu(), state.aux.cpu(),
                             state.dropped.cpu()]
    err = _max_abs(zip(sides["cpu"], sides["cuda"]))
    occupied = int(sides["cuda"][4].sum())  # the last step's occupancy
    print(f"  known-map preload + 3 steps, card vs CPU [{card}]: max abs "
          f"diff {err}, occupied map cells at the last step {occupied}")
    if err or occupied == 0:
        raise SystemExit("the card's known-map steps disagree with the CPU's")
    return occupied


# RedNet logits, card against CPU: largest absolute difference over the
# largest |logit|. Float32 on both sides differs by sums in other orders
# (about 5e-7); TF32 convolutions round every operand to 10 mantissa bits
# and must fail the check, which the phase shows by running them too.
REDNET_RTOL = 2e-5


def rednet_flops(hw: int) -> int:
    """Float32 operations of RedNet's convolutions and transposed
    convolutions on one hw x hw image (two per multiply-add), counted
    from the layers' shapes on the CPU."""
    from ivlnce_tpu_torch.models import rednet as TR

    model = TR.RedNet().eval()
    macs = 0

    def count(mod, inp, out):
        nonlocal macs
        k = mod.kernel_size[0] * mod.kernel_size[1]
        if isinstance(mod, torch.nn.ConvTranspose2d):
            macs += inp[0].numel() * mod.out_channels * k
        else:
            macs += out.numel() * mod.in_channels // mod.groups * k

    for mod in model.modules():
        if isinstance(mod, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            mod.register_forward_hook(count)
    with torch.no_grad():
        model(torch.zeros(1, hw, hw, 3), torch.zeros(1, hw, hw, 1))
    return 2 * macs


def phase_rednet_reference(card: str) -> dict:
    """A RedNet step at 256^2 (B=2, weights from SEED) on the card and on
    the CPU. The card's float32 logits must lie within REDNET_RTOL of the
    largest |logit| of the CPU's, and its labels must equal the CPU's
    wherever the CPU's top-2 margin exceeds twice that tolerance (no
    smaller margin can flip within it); the same step with TF32
    convolutions must fall outside the tolerance. Then one mapper step on
    each side fed the CPU's labels: maps equal."""
    from ivlnce_tpu_torch.mapping import mapper as M
    from ivlnce_tpu_torch.models import rednet as TR

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        cpu_model = TR.RedNet().eval()
    gpu_model = TR.RedNet().cuda().eval()
    gpu_model.load_state_dict(cpu_model.state_dict())
    params = mapper_params()
    depth, _, pose, orient, masks = next(walk(2, 256, 1, 6))
    rng = np.random.default_rng(6)
    rgb = rng.integers(0, 256, (2, 256, 256, 3)).astype(np.uint8)

    def logits(dev, model):
        with torch.no_grad():
            return model(*TR.normalize_inputs(
                torch.from_numpy(rgb).to(dev),
                torch.from_numpy(depth).to(dev))).cpu()

    ref = logits("cpu", cpu_model)
    got = logits("cuda", gpu_model)
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32 = logits("cuda", gpu_model)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    scale = float(ref.abs().max())
    tol = REDNET_RTOL * scale
    err = _max_abs([(ref, got)])
    tf32_err = _max_abs([(ref, tf32)])
    top = ref.topk(2, -1).values
    sure = (top[..., 0] - top[..., 1]) > 2 * tol
    labels = {"cpu": torch.argmax(ref, -1).to(torch.uint8),
              "cuda": torch.argmax(got, -1).to(torch.uint8)}
    flipped = int((sure & (labels["cpu"] != labels["cuda"])).sum())
    agree = float((labels["cpu"] == labels["cuda"]).float().mean())
    maps = {}
    for dev in ("cpu", "cuda"):
        state = M.init_state(2, params.grid_cells, dev)
        _, occ, smap = M.mapper_step(
            params, state, torch.from_numpy(depth).to(dev),
            labels["cpu"].to(dev), pose, orient, None, masks)
        maps[dev] = (occ.cpu(), smap.cpu())
    map_err = _max_abs(zip(maps["cpu"], maps["cuda"]))
    print(f"  RedNet 256^2 card vs CPU [{card}]: largest |logit| {scale}; "
          f"logits max abs diff float32 {err}, TF32 {tf32_err} (tolerance "
          f"{tol}, {REDNET_RTOL} of the largest); labels agree on "
          f"{agree:.6f} of pixels, {flipped} differ of {int(sure.sum())} "
          f"whose margin exceeds twice the tolerance; maps max abs diff "
          f"{map_err} with the labels fed equal")
    if err > tol or flipped or map_err:
        raise SystemExit("the card's RedNet step disagrees with the CPU's")
    if tf32_err <= tol:
        raise SystemExit("TF32 convolutions pass the RedNet tolerance: it "
                         "cannot tell float32 from TF32")
    return {"largest_logit": scale, "tolerance": tol, "logits": err,
            "tf32_logits": tf32_err, "label_agreement": agree,
            "labels_checked": int(sure.sum()), "maps": map_err}


def eval_opts(tmp: str, run: str, ckpt: str, extra=()) -> list:
    """run_exp options: 3 lanes (one per val_seen scene), so each lane
    walks two 4-episode tours with tour-persistent maps, episodes cut to
    30 agent steps; outputs under ``tmp/run``."""
    out = os.path.join(tmp, run)
    os.makedirs(out)
    return [
        "NUM_ENVIRONMENTS", "3",
        "EVAL_CKPT_PATH_DIR", ckpt,
        "CHECKPOINT_FOLDER", os.path.join(out, "ckpts"),
        "TENSORBOARD_DIR", os.path.join(out, "tb"),
        "RESULTS_DIR", os.path.join(out, "results"),
        "LOG_FILE", os.path.join(out, "eval.log"),
        "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", "30",
        *extra,
    ]


# the evaluations chip_smoke drives: config, extra options, and the
# kernels each must launch and must not launch (K1 must not run where no
# frame accumulates; no mapper kernel where no mapper runs)
PATHS = {
    "iterative": (CONFIG, (), ("accumulate", "rasterize"), ("known_load",)),
    "known": (KNOWN_CONFIG, (), ("known_load", "rasterize"), ("accumulate",)),
    "predicted": (CONFIG, tuple(PREDICTED_OPTS), ("accumulate", "rasterize"),
                  ("known_load",)),
    **{f"latent_{v}": (CONFIG, LATENT_OPTS + flags, (), KERNELS)
       for v, (flags, _) in LATENT_VARIANTS.items()},
    "map_episodic": (EPISODIC_CONFIG, (), ("accumulate", "rasterize"),
                     ("known_load",)),
    # both languages of the fake RxR split: two episodes per lane (its two
    # scenes, so two lanes)
    "rxr": (RXR_CONFIG, ("NUM_ENVIRONMENTS", "2", "EVAL.LANGUAGES", "['*']"),
            (), KERNELS),
}
# phase 16: the same evaluations under TPU.compute_dtype bfloat16
BF16_OPTS = ("TPU.compute_dtype", "bfloat16")
BF16_PATHS = ("iterative", "known", "predicted", "latent_4_pool_end_cma",
              "map_episodic", "rxr")
PATHS.update({f"{p}_bf16": (c, tuple(x) + BF16_OPTS, n, a)
              for p, (c, x, n, a) in PATHS.items() if p in BF16_PATHS})
EPISODIC_PATHS = ("map_episodic", "rxr", "map_episodic_bf16", "rxr_bf16")


def _restart_recorder():
    """Wrap the trainer's policy step and the mapper's lane clear so a run
    records, per policy step, which live lanes began an episode (reset
    mask 0) and whether each one's grid rows were cleared. Returns the
    record and a function that undoes the wrapping."""
    from ivlnce_tpu_torch.mapping import mapper as M
    from ivlnce_tpu_torch.trainers.base_trainer import BaseVLNCETrainer

    record = {"starts": 0, "missed": 0, "cleared": set()}
    policy_step, clear_lanes = BaseVLNCETrainer._policy_step, M.clear_lanes

    def clearing(state, keep_mask):
        keep = np.asarray(keep_mask, bool).reshape(-1)
        record["cleared"] |= set(np.flatnonzero(~keep).tolist())
        return clear_lanes(state, keep_mask)

    def stepped(self, batch, reset_masks, *args, **kwargs):
        record["cleared"] = set()
        out = policy_step(self, batch, reset_masks, *args, **kwargs)
        starts = self._lane_rows[np.asarray(reset_masks).reshape(-1) == 0]
        record["starts"] += len(starts)
        record["missed"] += len(set(starts.tolist()) - record["cleared"])
        return out

    BaseVLNCETrainer._policy_step, M.clear_lanes = stepped, clearing

    def undo():
        BaseVLNCETrainer._policy_step, M.clear_lanes = policy_step, clear_lanes
    return record, undo


def _step_stamps():
    """Wrap the trainer's policy step to record the host time at the end
    of each; returns the record and a function that undoes the
    wrapping."""
    from ivlnce_tpu_torch.trainers.base_trainer import BaseVLNCETrainer

    stamps = []
    policy_step = BaseVLNCETrainer._policy_step

    def stamped(self, *args, **kwargs):
        out = policy_step(self, *args, **kwargs)
        stamps.append(time.perf_counter())
        return out

    BaseVLNCETrainer._policy_step = stamped

    def undo():
        BaseVLNCETrainer._policy_step = policy_step
    return stamps, undo


def one_tour_per_lane(tmp: str) -> tuple:
    """Options that cut the val_seen split to the first tour of each scene
    (one per lane), with the tour-nDTW ground truth of those tours under
    their new numbers (a tour's id is its place in the tours file)."""
    from ivlnce_tpu_torch.config import get_config

    config = get_config(CONFIG)
    split = config.EVAL.SPLIT
    with open(config.TASK_CONFIG.DATASET.TOURS_FILE) as f:
        tours = json.load(f)
    with open(config.EVAL.ITERATIVE_GT_PATHS) as f:
        gt = json.load(f)
    kept, kept_gt, first = {}, {}, 0
    for scene, scene_tours in tours[split].items():
        kept[scene] = scene_tours[:1]
        kept_gt[str(len(kept_gt))] = gt[split][str(first)]
        first += len(scene_tours)
    paths = (os.path.join(tmp, "one_tour_per_lane.json"),
             os.path.join(tmp, "one_tour_per_lane_gt.json"))
    for path, data in zip(paths, ({split: kept}, {split: kept_gt})):
        with open(path, "w") as f:
            json.dump(data, f)
    return ("TASK_CONFIG.DATASET.TOURS_FILE", paths[0],
            "EVAL.ITERATIVE_GT_PATHS", paths[1])


def host_phases(trainer, wall=None) -> dict:
    """The run's host-phase split (``utils/profiling.wall_range``, reset
    at each checkpoint's start and at a training run's): seconds, spans and
    share of the loop's wall time (the eval loop's unless ``wall`` is
    given) per phase, the rest as ``other``."""
    from ivlnce_tpu_torch.utils import profiling

    if not profiling._PHASES_ON:
        raise SystemExit("IVLNCE_PHASE_TIMES was not set before the port "
                         "was imported")
    wall = trainer.eval_seconds if wall is None else wall
    out = {k: {"s": v, "spans": profiling._phase_counts[k],
               "share": v / wall}
           for k, v in profiling._phase_times.items()}
    other = wall - sum(v["s"] for v in out.values())
    out["other"] = {"s": other, "spans": 0, "share": other / wall}
    return out


def phase_end_to_end(card: str, tmp: str, ckpt: str, path: str,
                     extra_opts=(), run=None) -> dict:
    """``run_exp`` eval of one path on the card (outputs under
    ``tmp/run``, ``run`` defaulting to the path's name), the launch
    counters set to 0 just before and read just after."""
    from ivlnce_tpu_torch.ops import scatter as S
    from ivlnce_tpu_torch.run import run_exp

    config, extra, needed, absent = PATHS[path]
    episodic = path in EPISODIC_PATHS
    run = run or path
    results = os.path.join(tmp, run, "results")
    opts = eval_opts(tmp, run, ckpt, tuple(extra) + tuple(extra_opts))
    restarts, undo = (_restart_recorder() if episodic else (None, None))
    stamps, unstamp = _step_stamps()
    torch.cuda.reset_peak_memory_stats()
    S.launches.reset()
    t0 = time.perf_counter()
    try:
        trainer = run_exp(config, "eval", opts, device="cuda")
    finally:
        unstamp()
        if undo is not None:
            undo()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: getattr(S.launches, k) for k in KERNELS}

    prefix = "" if episodic else "iterative_"
    with open(os.path.join(results,
                           f"{prefix}stats_ckpt_0_val_seen.json")) as f:
        stats = json.load(f)
    bad = {k: v for k, v in stats.items() if not math.isfinite(v)}
    if bad or not stats:
        raise SystemExit(f"non-finite or no stats: {stats}")
    steps = trainer.policy_steps
    summary = {
        "card": card,
        "path": path,
        "transform": (type(trainer.obs_transforms[0]).__name__
                      if trainer.obs_transforms else None),
        "policy": type(trainer.policy).__name__,
        "recurrent_layers": trainer.policy.num_recurrent_layers,
        "lanes": trainer._num_rows,
        "policy_steps": steps,
        "env_steps": trainer.env_steps,
        "eval_seconds": trainer.eval_seconds,
        "env_steps_per_s": trainer.env_steps / trainer.eval_seconds,
        "run_exp_seconds": wall,
        "wall_ms_per_step": trainer.eval_seconds * 1e3 / max(steps, 1),
        # past the first TRACE_SKIP steps, which pay the process's first
        # use of each convolution shape (cuDNN's plans)
        "warm_wall_ms_per_step": (
            (stamps[-1] - stamps[TRACE_SKIP]) * 1e3
            / (len(stamps) - 1 - TRACE_SKIP)
            if len(stamps) > TRACE_SKIP + 1 else None),
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "launches": launches,
        "instruction_encodes": trainer.instruction_encodes,
        "episodes": trainer.episodes_evaluated,
        "host_phases": host_phases(trainer),
        "stats": stats,
    }
    if not episodic:
        with open(os.path.join(
                results, "iterative_all_stats_ckpt_0_val_seen.json")) as f:
            per_tour = json.load(f)
        if not glob.glob(os.path.join(results, "dtw_data_ckpt_0_*.json")):
            raise SystemExit("no dtw data written")
        if "tndtw" not in stats:
            raise SystemExit("no t-nDTW in the stats")
        tours_crossed = sum(1 for eps in per_tour.values() if len(eps) >= 2)
        if tours_crossed < 3:
            raise SystemExit(f"only {tours_crossed} tours crossed an "
                             "episode boundary")
        summary["tours_crossed"] = tours_crossed
    print(f"  [{card}] {path}: {trainer.env_steps} env steps in "
          f"{trainer.eval_seconds:.2f} s: "
          f"{summary['env_steps_per_s']:.2f} env steps/s, {steps} policy "
          f"steps, wall ms per policy step "
          f"{summary['wall_ms_per_step']:.4f} (past step {TRACE_SKIP}: "
          f"{summary['warm_wall_ms_per_step']}); {summary['policy']} with "
          f"{summary['recurrent_layers']} recurrent layers, instruction "
          f"encodes {trainer.instruction_encodes}")
    print(f"  launches: {launches}; peak memory "
          f"{summary['peak_memory_bytes']} bytes")
    print(f"  host phases [{card}] {run}, of {trainer.eval_seconds:.4f} s: "
          + ", ".join(f"{k} {v['s']:.4f} s ({100 * v['share']:.2f}%, "
                      f"{v['spans']} spans)"
                      for k, v in summary["host_phases"].items()))
    if restarts is not None:
        summary["episode_starts"] = restarts["starts"]
        print(f"  {restarts['starts']} episode starts over the live lanes")
        if restarts["starts"] <= summary["lanes"]:
            raise SystemExit("no lane began a second episode")
        # the cache re-encodes when a lane's episode changes or a lane
        # pauses (its row turns to zeros), never at every step
        if not (0 < trainer.instruction_encodes
                <= restarts["starts"] + summary["lanes"]
                and trainer.instruction_encodes < steps):
            raise SystemExit(f"{trainer.instruction_encodes} instruction "
                             f"encodes for {restarts['starts']} episode "
                             f"starts and {steps} policy steps")
    for k in needed:
        if launches[k] == 0:
            raise SystemExit(f"{k} kernel never launched on the {path} path")
    for k in absent:
        if launches[k] != 0:
            raise SystemExit(f"{k} kernel launched on the {path} path")
    if not trainer.obs_transforms:
        return summary
    mapper = trainer.obs_transforms[0]
    if launches["rasterize"] != steps:
        raise SystemExit(f"{launches['rasterize']} rasterize launches for "
                         f"{steps} policy steps")
    summary.update(
        scene_loads=mapper.known_map_loads,
        occupied_cells=int((mapper.state.word != S.EMPTY_WORD).sum()),
        dropped_points=mapper.dropped_point_count(),
    )
    print(f"  scene loads {summary['scene_loads']}; occupied grid cells "
          f"after the run {summary['occupied_cells']}; dropped points "
          f"{summary['dropped_points']}")
    if summary["occupied_cells"] == 0:
        raise SystemExit(f"the {path} path stored no point")
    if restarts is not None:
        print(f"  episode starts without a grid clear: {restarts['missed']}")
        if restarts["missed"]:
            raise SystemExit("the episodic grid did not restart at every "
                             "episode")
    return summary


RANGES = ("mapper", "semantics", "known_map_load", "encoders",
          "depth_encoder", "map_encoder", "rgb_encoder", "gru_attention",
          "instruction_encoder")
TRACE_SKIP, TRACE_STEPS = 50, 100


def _innermost(ranges, starts, ts):
    """Name of the innermost range holding host time ``ts`` (ranges nest,
    as ``semantics`` inside ``mapper``), or None."""
    i = bisect.bisect_right(starts, ts) - 1
    for j in range(i, max(i - 4, -1), -1):  # nesting is at most 2 deep
        if ts < ranges[j][1]:
            return ranges[j][2]
    return None


def attribute_device_time(trace: dict, names=RANGES) -> dict:
    """Device microseconds of a Chrome trace by the named range its launch
    fell in. A kernel or copy is matched to its launching runtime call by
    the CUPTI correlation id; the call's host time places it in the
    innermost ``record_function`` range of ``names``, or outside them.
    A device event without a launch record whose correlation id precedes
    every recorded launch was launched before the traced window (the
    last warm-up step's tail, which the card's clock, converted to the
    host's, can place a fraction of a millisecond inside the window): it
    is left out and counted in ``before_window``; any other is
    ``unmatched``."""
    launch_ts, ranges, device, steps = {}, [], [], []
    for ev in trace["traceEvents"]:
        cat, name = ev.get("cat"), ev.get("name", "")
        if cat in ("cuda_runtime", "cuda_driver"):
            launch_ts[ev.get("args", {}).get("correlation")] = ev["ts"]
        elif cat == "user_annotation" and name in names:
            ranges.append((ev["ts"], ev["ts"] + ev["dur"], name))
        elif cat == "user_annotation" and name.startswith("ProfilerStep"):
            steps.append((ev["ts"], ev["ts"] + ev["dur"]))
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            device.append(ev)
    ranges.sort()
    starts = [r[0] for r in ranges]
    by_range = defaultdict(float)
    by_kernel = defaultdict(lambda: defaultdict(float))
    unmatched, before, device_us = 0, 0, 0.0
    first = min((c for c in launch_ts if c is not None), default=None)
    for ev in device:
        corr = ev.get("args", {}).get("correlation")
        ts = launch_ts.get(corr)
        if ts is None and first is not None and corr is not None \
                and corr < first:
            before += 1
            continue
        if ts is None:
            unmatched += 1
            where = "no launch record"
        else:
            where = _innermost(ranges, starts, ts) or "outside the ranges"
        by_range[where] += ev["dur"]
        by_kernel[ev["name"]][where] += ev["dur"]
        device_us += ev["dur"]
    return {
        "by_range_us": dict(by_range),
        "by_kernel_us": {k: dict(v) for k, v in by_kernel.items()},
        "device_us": device_us,
        "before_window": before,
        "window_us": (max(e for _, e in steps) - min(b for b, _ in steps)
                      if steps else 0.0),
        "unmatched": unmatched,
    }


def latent_encoder_flops() -> dict:
    """Float32 operations of LatentCMA's two ResNet-50s on one frame (two
    per multiply-add of their convolutions): the depth encoder on a 256^2
    frame (pooled to 128^2 inside) and the RGB encoder on a 224^2 frame,
    counted from the layers' shapes on the CPU."""
    from ivlnce_tpu_torch.models.resnet import (
        TorchVisionResNetSpatial,
        VlnResnetDepthEncoder,
    )

    encoders = {"depth": VlnResnetDepthEncoder(128).eval(),
                "rgb": TorchVisionResNetSpatial("TorchVisionResNet50").eval()}
    flops = {}
    for name, enc in encoders.items():
        macs = 0

        def count(mod, inp, out):
            nonlocal macs
            k = mod.kernel_size[0] * mod.kernel_size[1]
            macs += out.numel() * mod.in_channels // mod.groups * k

        for mod in enc.modules():
            if isinstance(mod, torch.nn.Conv2d):
                mod.register_forward_hook(count)
        with torch.no_grad():
            if name == "depth":
                enc(torch.zeros(1, 256, 256, 1))
            else:
                enc(torch.zeros(1, 224, 224, 3, dtype=torch.uint8))
        flops[name] = 2 * macs
    return flops


def phase_trace(card: str, tmp: str, ckpt: str, wall_ms_per_step: float,
                path: str, extra_opts=()) -> dict:
    """The path's eval again (with ``extra_opts``: one tour per lane, which
    holds enough policy steps for the window), with ``torch.profiler``
    recording policy steps TRACE_SKIP + 5 to TRACE_SKIP + 5 +
    TRACE_STEPS. Device time per
    ``record_function`` range of the trainer and policy, per policy step;
    the busy share sets device time per policy step against the untraced
    run's wall time per policy step (the profiler slows the host, not the
    card), and against the traced window's own wall time."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from ivlnce_tpu_torch.run import run_exp
    from ivlnce_tpu_torch.trainers.base_trainer import BaseVLNCETrainer

    config, extra, needed, _ = PATHS[path]
    trace_path = os.path.join(tmp, f"trace_{path}.json")
    prof = profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
        schedule=schedule(wait=TRACE_SKIP, warmup=5, active=TRACE_STEPS,
                          repeat=1),
        on_trace_ready=lambda p: p.export_chrome_trace(trace_path),
    )
    policy_step = BaseVLNCETrainer._policy_step

    def stepped(self, *args, **kwargs):
        out = policy_step(self, *args, **kwargs)
        prof.step()
        return out

    BaseVLNCETrainer._policy_step = stepped
    try:
        with prof:
            run_exp(config, "eval",
                    eval_opts(tmp, f"{path}_trace", ckpt,
                              tuple(extra) + tuple(extra_opts)),
                    device="cuda")
    finally:
        BaseVLNCETrainer._policy_step = policy_step
    t0 = time.perf_counter()
    with open(trace_path) as f:
        got = attribute_device_time(json.load(f))
    print(f"  trace read in {time.perf_counter() - t0:.2f} s")
    if got["device_us"] == 0.0:
        raise SystemExit("the trace holds no device time")
    if got["unmatched"]:
        raise SystemExit(f"{got['unmatched']} device events without a "
                         "launch record")
    current = KERNEL_NAMES["accumulate"] + KERNEL_NAMES["rasterize"]
    mapper_kernels = {
        short: {where: us / 1e3 / TRACE_STEPS for where, us in v.items()}
        for short in current
        for name, v in got["by_kernel_us"].items() if short in name
    }
    expected = set(current) if needed else set()
    if set(mapper_kernels) != expected:
        raise SystemExit(f"mapper kernels in the trace: "
                         f"{sorted(mapper_kernels)}, expected "
                         f"{sorted(expected)}")
    if any(set(v) != {"mapper"} for v in mapper_kernels.values()):
        raise SystemExit(f"mapper kernels outside the mapper range: "
                         f"{mapper_kernels}")
    bf16_kernels = (check_bf16_kernels(got, path)
                    if path.endswith("_bf16") else None)
    per_step = {k: us / 1e3 / TRACE_STEPS
                for k, us in got["by_range_us"].items()}
    device_ms = got["device_us"] / 1e3 / TRACE_STEPS
    # kernels by the first 60 characters of their names, summed, overall
    # and within each range
    top = defaultdict(float)
    range_top = defaultdict(lambda: defaultdict(float))
    for k, v in got["by_kernel_us"].items():
        for where, us in v.items():
            top[k[:60]] += us / 1e3 / TRACE_STEPS
            range_top[where][k[:60]] += us / 1e3 / TRACE_STEPS

    def largest(d, n):
        return dict(sorted(d.items(), key=lambda kv: -kv[1])[:n])
    summary = {
        "card": card,
        "path": path,
        "policy_steps": TRACE_STEPS,
        "device_ms_per_step": device_ms,
        "range_device_ms_per_step": per_step,
        "busy_share": device_ms / wall_ms_per_step,
        "traced_busy_share": got["device_us"] / got["window_us"],
        "mapper_kernels_ms_per_step": mapper_kernels,
        "events_before_window": got["before_window"],
        "top_device_ms_per_step": largest(top, 10),
        "range_top_device_ms_per_step": {
            where: largest(d, 5) for where, d in range_top.items()},
        "bf16_kernels": bf16_kernels,
    }
    print(f"  [{card}] {path}: {TRACE_STEPS} policy steps traced; device ms "
          f"per policy step {device_ms:.4f}, by range {per_step}")
    print(f"  [{card}] busy share {summary['busy_share']:.4f} of the "
          f"untraced wall ({summary['traced_busy_share']:.4f} of the "
          f"traced window's)")
    print(f"  mapper kernels, ms per policy step: {mapper_kernels}")
    return summary


def _action_recorder():
    """Wrap the trainer's policy step to record each step's actions;
    returns the record and a function that undoes the wrapping."""
    from ivlnce_tpu_torch.trainers.base_trainer import BaseVLNCETrainer

    record = []
    policy_step = BaseVLNCETrainer._policy_step

    def stepped(self, *args, **kwargs):
        actions, rnn_states = policy_step(self, *args, **kwargs)
        record.append(np.asarray(actions).ravel().tolist())
        return actions, rnn_states

    BaseVLNCETrainer._policy_step = stepped

    def undo():
        BaseVLNCETrainer._policy_step = policy_step
    return record, undo


def write_checkpoint_kinds(tmp: str, config) -> dict:
    """Phase 6's seeded MapCMA weights as the three checkpoint kinds the
    eval reads: the port's own file, a reference-layout ``.pth`` (with
    the reference's ``net._scale`` buffer, ``epoch`` and a dict config)
    and a JAX-layout pickle (the JAX package's parameter tree, from the
    port's copies of its converters, with an optimizer state of plain
    arrays)."""
    import pickle

    from ivlnce_tpu_torch.models import checkpoint_io as cio
    from ivlnce_tpu_torch.trainers.base_trainer import save_checkpoint

    policy = seeded_policy(config)
    state = policy.state_dict()
    paths = {kind: os.path.join(tmp, f"ckpt_{kind}.0.{ext}")
             for kind, ext in (("own", "pth"), ("reference", "pth"),
                               ("jax", "pkl"))}
    save_checkpoint(policy, config, paths["own"])
    scale = torch.tensor(1.0 / math.sqrt(policy.hidden_size // 2))
    torch.save({"state_dict": {**state, cio.REFERENCE_SCALE_KEY: scale},
                "epoch": 0, "config": config.to_dict()},
               paths["reference"])
    params = cio.jax_params_from_state_dict(state)

    def zeros(tree):
        return {k: zeros(v) if isinstance(v, dict) else np.zeros_like(v)
                for k, v in tree.items()}

    with open(paths["jax"], "wb") as f:
        pickle.dump({"params": params,
                     "optim_state": (np.zeros((), np.int32), zeros(params),
                                     zeros(params)),
                     "config": config.to_dict(), "dagger_it": 0,
                     "epoch": 0, "step_id": 0}, f,
                    protocol=pickle.HIGHEST_PROTOCOL)
    return paths


def phase_checkpoint_kinds(card: str, tmp: str, one_tour) -> dict:
    """Phase 13a: the iterative eval from each checkpoint kind, one tour
    per lane: identical actions at every step, equal stats, K1 and K2
    once per policy step."""
    from ivlnce_tpu_torch.config import get_config

    paths = write_checkpoint_kinds(tmp, get_config(CONFIG))
    runs, actions = {}, {}
    for kind, path in paths.items():
        record, undo = _action_recorder()
        try:
            runs[kind] = phase_end_to_end(card, tmp, path, "iterative",
                                          one_tour, run=f"ckpt_{kind}")
        finally:
            undo()
        actions[kind] = record
        steps = runs[kind]["policy_steps"]
        launches = runs[kind]["launches"]
        if (launches["accumulate"], launches["rasterize"]) != (steps, steps):
            raise SystemExit(f"{kind}: {launches} launches for {steps} "
                             "policy steps")
    for kind in ("reference", "jax"):
        if actions[kind] != actions["own"]:
            differ = [i for i, (a, b) in enumerate(
                zip(actions[kind], actions["own"])) if a != b]
            raise SystemExit(
                f"the {kind} checkpoint's actions differ from the port's "
                f"own: {len(actions[kind])} vs {len(actions['own'])} steps, "
                f"first difference at step {differ[:1]}")
        if runs[kind]["stats"] != runs["own"]["stats"]:
            raise SystemExit(f"the {kind} checkpoint's stats differ: "
                             f"{runs[kind]['stats']} vs "
                             f"{runs['own']['stats']}")
    print(f"  [{card}] own, reference .pth and JAX pickle: "
          f"{len(actions['own'])} policy steps of identical actions each, "
          f"equal stats {runs['own']['stats']}")
    return runs


def count_policy_step_ranges(profile_dir: str) -> int:
    """``policy_step`` host ranges in the one Chrome trace written to
    ``profile_dir``."""
    traces = glob.glob(os.path.join(profile_dir, "*.json"))
    if len(traces) != 1:
        raise SystemExit(f"expected one trace in {profile_dir}: {traces}")
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    return sum(e.get("name") == "policy_step"
               and e.get("cat") == "user_annotation" for e in events)


def phase_videos_and_trace(card: str, tmp: str, ckpt: str) -> dict:
    """Phase 13b: the MapCMA episodic eval with videos on disk and the
    on-demand trace of policy steps 3 to 22; two lanes, so that lanes
    begin second episodes (``phase_end_to_end`` checks their restarts)
    before ``EVAL.EPISODE_COUNT`` 3 ends the run."""
    from ivlnce_tpu_torch.utils import viz

    run = "map_episodic_videos"
    video_dir = os.path.join(tmp, run + "_videos")
    profile_dir = os.path.join(tmp, run + "_trace")
    seen = {"frames": 0, "top_down": 0, "videos": []}
    observations_to_image, generate_video = (viz.observations_to_image,
                                             viz.generate_video)

    def composing(observation, info):
        seen["frames"] += 1
        seen["top_down"] += "top_down_map_vlnce" in (info or {})
        return observations_to_image(observation, info)

    def writing(*args, **kwargs):
        images = kwargs["images"]
        seen["videos"].append(images[0].shape)
        # the egocentric map panels: two 4x-upscaled 64 x 64 maps below
        # the sensors, drawn in colours (not the padding's white)
        panels = images[0][-4 * 64:, :2 * 4 * 64]
        if images[0].shape[0] <= 4 * 64 or (panels == 255).all():
            raise SystemExit("a video frame without the map panels")
        return generate_video(*args, **kwargs)

    viz.observations_to_image, viz.generate_video = composing, writing
    try:
        summary = phase_end_to_end(
            card, tmp, ckpt, "map_episodic",
            ("NUM_ENVIRONMENTS", "2", "EVAL.EPISODE_COUNT", "3",
             "VIDEO_OPTION", "['disk']",
             "VIDEO_DIR", video_dir, "TPU.profile_dir", profile_dir),
            run=run)
    finally:
        viz.observations_to_image, viz.generate_video = (
            observations_to_image, generate_video)
    files = sorted(os.listdir(video_dir))
    formats = sorted({os.path.splitext(f)[1] for f in files})
    ranges = count_policy_step_ranges(profile_dir)
    summary.update(videos=len(files), video_formats=formats,
                   frames=seen["frames"], top_down_frames=seen["top_down"],
                   frame_shape=list(seen["videos"][0]) if seen["videos"]
                   else None, traced_policy_steps=ranges)
    print(f"  [{card}] {len(files)} videos ({', '.join(formats)}) for "
          f"{summary['episodes']} episodes; {seen['frames']} frames, "
          f"{seen['top_down']} with the top-down map, first frame "
          f"{summary['frame_shape']}; {ranges} policy_step ranges in the "
          "trace")
    if len(files) != summary["episodes"] or len(seen["videos"]) != len(files):
        raise SystemExit(f"{len(files)} videos for {summary['episodes']} "
                         "episodes")
    if seen["top_down"] != seen["frames"] or not seen["frames"]:
        raise SystemExit("TOP_DOWN_MAP_VLNCE was not measured at every "
                         "frame")
    if ranges != 20:
        raise SystemExit(f"{ranges} policy_step ranges traced, not 20")
    return summary


# -- phase 14: training -------------------------------------------------------
TRAIN_CONFIGS = {"train_map_cma": "configs/fake/map_cma_train_tf.yaml",
                 "train_latent": "configs/fake/latent_cma_train.yaml",
                 "train_tour": "configs/fake/tour_cma_train.yaml"}
TRAIN_RANGES = ("train_encode", "train_rnn", "train_loss", "backward",
                "optimizer", "map_bn_stats")
TRAIN_TRACE_WARMUP, TRAIN_TRACE_STEPS = 5, 20
# loss terms, card against CPU (relative); gradients, of each tensor's
# largest |value|; the map BatchNorm statistics (absolute and relative);
# gradients that vanish in exact arithmetic, of the model's largest
# gradient (rounding noise only: 9.0e-5 on an H100 at full width)
TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL, TRAIN_BN_TOL = 1e-5, 1e-4, 1e-5
TRAIN_NOISE_TOL = 1e-3


def train_opts(tmp: str, run: str) -> list:
    """run_exp options of a training run: the config's 2 lanes, episodes
    cut to 30 agent steps, batches of 5, at most 40 episodes (p = 1 stops
    at the fake train split's distinct episodes), two epochs; outputs under
    ``tmp/run``."""
    out = os.path.join(tmp, run)
    os.makedirs(out)
    return [
        "CHECKPOINT_FOLDER", os.path.join(out, "ckpts"),
        "TENSORBOARD_DIR", os.path.join(out, "tb"),
        "RESULTS_DIR", os.path.join(out, "results"),
        "LOG_FILE", os.path.join(out, "train.log"),
        "IL.batch_size", "5",
        "IL.epochs", "2",
        "IL.DAGGER.update_size", "40",
        "IL.DAGGER.lmdb_features_dir", os.path.join(out, "traj.lmdb"),
        "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", "30",
    ]


def phase_train(card: str, tmp: str, path: str, extra=(), run=None) -> dict:
    """Phase 14a / 14c: ``run_exp(config, "train")`` on the card (outputs
    under ``tmp/run``, ``run`` defaulting to the path's name), the launch
    counters set to 0 just before and read just after: the trajectory
    store, the checkpoints with the optimizer state, finite losses, K1
    and K2 once per collection step with a mapper and never without;
    collection env steps/s, train steps/s and rows/s, the host-phase
    split of the run and the peak device memory."""
    from ivlnce_tpu_torch.ops import scatter as S
    from ivlnce_tpu_torch.run import run_exp
    from ivlnce_tpu_torch.trainers.base_trainer import load_checkpoint
    from ivlnce_tpu_torch.trainers.trajectory_store import TrajectoryStore
    from ivlnce_tpu_torch.utils import profiling

    run = run or path
    opts = train_opts(tmp, run) + list(extra)
    torch.cuda.reset_peak_memory_stats()
    S.launches.reset()
    t0 = time.perf_counter()
    trainer = run_exp(TRAIN_CONFIGS[path], "train", opts, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: getattr(S.launches, k) for k in KERNELS}
    mapped = bool(trainer.obs_transforms)
    steps = trainer.collection_steps
    expected = {"accumulate": steps if mapped else 0,
                "rasterize": steps if mapped else 0, "known_load": 0}
    if launches != expected:
        raise SystemExit(f"{run}: launches {launches} for {steps} "
                         f"collection steps, expected {expected}")
    losses = np.asarray(trainer.losses)
    if not len(losses) or not np.isfinite(losses).all():
        raise SystemExit(f"{run}: losses {trainer.losses}")
    ckpt_dir = trainer.config.CHECKPOINT_FOLDER
    ckpts = sorted(glob.glob(os.path.join(ckpt_dir, "ckpt.*.pth")))
    last = load_checkpoint(ckpts[-1])
    if (len(ckpts) != 2 or not last["optim_state"]["state"]
            or (last["epoch"], last["step_id"]) != (
                1, trainer.train_steps)):
        raise SystemExit(f"{run}: checkpoints {ckpts}, epoch "
                         f"{last.get('epoch')}, step {last.get('step_id')}")
    if not glob.glob(os.path.join(trainer.config.TENSORBOARD_DIR,
                                  "events.out.tfevents.*")):
        raise SystemExit(f"{run}: no TensorBoard events")
    store_dir = trainer.lmdb_features_dir
    with TrajectoryStore(store_dir) as store:
        records = store.count()
        # after a tour collection, key 0 holds the tours index
        first = int(isinstance(store.get(0), dict))
        obs = store.get(first)[0]
    want = {"depth_features"} | ({"occupancy_map", "semantic_map"}
                                 if mapped else {"rgb_features"})
    if not want <= set(obs) or {"depth", "rgb"} & set(obs):
        raise SystemExit(f"{run}: a record holds {sorted(obs)}")
    train_s = profiling._phase_times["train_step"]
    summary = {
        "card": card,
        "path": run,
        "policy": type(trainer.policy).__name__,
        "lanes": trainer.config.NUM_ENVIRONMENTS,
        "records": records,
        "record_keys": sorted(obs),
        "collection_steps": steps,
        "collection_env_steps": trainer.collection_env_steps,
        "collection_seconds": trainer.collection_seconds,
        "collection_env_steps_per_s": (trainer.collection_env_steps
                                       / trainer.collection_seconds),
        "train_steps": trainer.train_steps,
        "train_rows": trainer.train_rows,
        "train_seconds": train_s,
        "train_steps_per_s": trainer.train_steps / train_s,
        "train_rows_per_s": trainer.train_rows / train_s,
        "wall_ms_per_train_step": train_s * 1e3 / trainer.train_steps,
        "run_seconds": trainer.run_seconds,
        "run_exp_seconds": wall,
        "losses": trainer.losses,
        "checkpoint": ckpts[-1],
        "store": store_dir,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "launches": launches,
        "host_phases": host_phases(trainer, trainer.run_seconds),
    }
    print(f"  [{card}] {run}: {records} episodes stored, "
          f"{trainer.collection_env_steps} collection env steps in "
          f"{trainer.collection_seconds:.2f} s: "
          f"{summary['collection_env_steps_per_s']:.2f} env steps/s; "
          f"{trainer.train_steps} train steps of {trainer.train_rows} rows "
          f"in {train_s:.4f} s: {summary['train_steps_per_s']:.4f} train "
          f"steps/s, {summary['train_rows_per_s']:.2f} rows/s; losses "
          f"first {trainer.losses[0]}, last {trainer.losses[-1]}")
    print(f"  launches: {launches} for {steps} collection steps; peak "
          f"memory {summary['peak_memory_bytes']} bytes; records hold "
          f"{summary['record_keys']}")
    print(f"  host phases [{card}] {run}, of {trainer.run_seconds:.4f} s: "
          + ", ".join(f"{k} {v['s']:.4f} s ({100 * v['share']:.2f}%, "
                      f"{v['spans']} spans)"
                      for k, v in summary["host_phases"].items()))
    return summary, trainer


def _training_policy(config, dtype, device):
    """The MapCMA policy at the config's widths, weights from ``SEED``,
    modules as the trainer sets them (recurrent ones in train mode)."""
    from ivlnce_tpu_torch.models.policy import MapCMAPolicy

    mapper = config.RL.POLICY.OBS_TRANSFORMS.EGOCENTRIC_MAPPER
    info = {"depth_hw": config.TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.HEIGHT,
            "map_hw": int(math.ceil(mapper.height_meters
                                    / mapper.resolution_meters))}
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        policy = MapCMAPolicy.from_config(config, info)
    policy = policy.to(device=device, dtype=dtype).eval()
    for module in policy.modules():
        if isinstance(module, torch.nn.RNNBase):
            module.train()
    return policy


def _train_grads(policy, batch, dtype, device):
    """The loss terms and every parameter's gradient (zeros where none)
    of one training forward and backward of ``batch``."""
    from ivlnce_tpu_torch.trainers.base_trainer import train_loss

    obs, prev, masks, corrected, weights = batch
    t, n = corrected.shape

    def dev(a, dt=None):
        x = torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return x.to(dt) if dt is not None else x

    tobs = {k: dev(v, dtype if v.dtype.kind == "f" else None)
            for k, v in obs.items()}
    m = dev(masks.reshape(t, n), dtype)
    cfg = policy.model_config.PROGRESS_MONITOR
    policy.zero_grad(set_to_none=True)
    terms = train_loss(policy, tobs, dev(prev), m, m, dev(corrected),
                       dev(weights, dtype),
                       policy.initial_rnn_states(n, device).to(dtype),
                       cfg.use, cfg.alpha)
    terms[0].backward()
    grads = {k: (torch.zeros_like(p) if p.grad is None else p.grad)
             .detach().double().cpu()
             for k, p in policy.named_parameters()}
    return [float(x.detach()) for x in terms[:3]], grads


def phase_train_reference(card: str, store_dir: str) -> dict:
    """Phase 14b: one full-width MapCMA train step from phase 14a's store
    (its first collated batch of 5) and the same initial weights, on the
    card and on the CPU: the loss terms within TRAIN_LOSS_RTOL; every
    gradient within TRAIN_GRAD_TOL of the CPU tensor's largest |value|.
    Behind training-mode BatchNorm the map encoder's gradients are small
    differences of large sums that float32 resolves only to about 1e-3 of
    their largest |value|; a map-encoder tensor that misses the tolerance
    passes when the card's float32 gradient is within TRAIN_GRAD_TOL of
    the card's float64 one plus twice the CPU's float32 distance from it
    (as close to the exact gradient as float32 allows). The conv biases
    ahead of BatchNorm and the text keys' bias have no gradient in exact
    arithmetic, only rounding noise: on each side they are held to
    TRAIN_NOISE_TOL of the model's largest gradient. Then the map
    BatchNorm statistics pass, on the same updated weights on both
    sides, within TRAIN_BN_TOL."""
    import random

    from ivlnce_tpu_torch.config import get_config
    from ivlnce_tpu_torch.trainers.base_trainer import make_optimizer
    from ivlnce_tpu_torch.trainers.dagger_trainer import IWTrajectoryDataset

    config = get_config(TRAIN_CONFIGS["train_map_cma"])
    random.seed(SEED)
    dataset = IWTrajectoryDataset(store_dir, config.IL.use_iw,
                                  config.IL.inflection_weight_coef, 5)
    batch = next(dataset.batches())
    obs = {k: v.astype(np.float32) if v.dtype == np.float16 else v
           for k, v in batch[0].items()}
    batch = (obs,) + batch[1:]
    t, n = batch[3].shape
    sides = {}
    for label, dtype, device in (("cpu", torch.float32, "cpu"),
                                 ("card", torch.float32, "cuda"),
                                 ("card64", torch.float64, "cuda")):
        policy = _training_policy(config, dtype, device)
        t0 = time.perf_counter()
        sides[label] = _train_grads(policy, batch, dtype, device)
        print(f"  {label}: forward and backward in "
              f"{time.perf_counter() - t0:.2f} s")
        if label == "cpu":
            cpu_policy = policy
    cpu_terms, cpu = sides["cpu"]
    card_terms, on_card = sides["card"]
    exact = sides["card64"][1]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(card_terms, cpu_terms)
                   if b)
    worst = {"direct": (0.0, None), "map_encoder_f64": (0.0, None),
             "vanishing": (0.0, None)}
    vanishing = ("net.text_k.bias",) + tuple(
        f"net.map_encoder.cnn.{i}.conv.0.bias" for i in range(4))
    failed = []
    largest = max(float(g.abs().max()) for g in cpu.values())
    for name, g in cpu.items():
        diff = float((on_card[name] - g).abs().max())
        if name in vanishing:
            key = "vanishing"
            ratio = max(float(on_card[name].abs().max()),
                        float(g.abs().max())) / largest
            ok = ratio <= TRAIN_NOISE_TOL
        else:
            scale = float(g.abs().max())
            ratio = diff / scale if scale else (0.0 if diff == 0 else math.inf)
            key, ok = "direct", ratio <= TRAIN_GRAD_TOL
            if not ok and name.startswith("net.map_encoder."):
                card_err = float((on_card[name] - exact[name]).abs().max())
                cpu_err = float((g - exact[name]).abs().max())
                bound = (TRAIN_GRAD_TOL * float(exact[name].abs().max())
                         + 2 * cpu_err)
                key, ratio, ok = "map_encoder_f64", card_err / bound, (
                    card_err <= bound)
        if ratio > worst[key][0]:
            worst[key] = (ratio, name)
        if not ok:
            failed.append((name, ratio))

    # the statistics pass on the same updated weights
    optimizer = make_optimizer(cpu_policy, config)
    optimizer.step()
    card_policy = _training_policy(config, torch.float32, "cuda")
    card_policy.load_state_dict(cpu_policy.state_dict())
    stats = {}
    for label, policy in (("cpu", cpu_policy), ("card", card_policy)):
        device = next(policy.parameters()).device
        policy.net.map_encoder.update_running_stats(
            torch.from_numpy(obs["occupancy_map"]).to(device),
            torch.from_numpy(obs["semantic_map"]).to(device))
        stats[label] = {k: v.detach().double().cpu()
                        for k, v in policy.state_dict().items()
                        if k.startswith("net.map_encoder.")
                        and k.endswith(("running_mean", "running_var"))}
    bn_err = max(float(((stats["card"][k] - v).abs()
                        / (1 + v.abs())).max())
                 for k, v in stats["cpu"].items())
    summary = {"card": card, "rows": t * n, "T": t, "N": n,
               "largest_gradient": largest,
               "loss_terms_cpu": cpu_terms, "loss_terms_card": card_terms,
               "loss_rel_err": loss_err,
               "grad_worst": {k: {"ratio": r, "tensor": nm}
                              for k, (r, nm) in worst.items()},
               "map_bn_err": bn_err}
    print(f"  train step card vs CPU [{card}], T={t} N={n}: loss terms "
          f"{card_terms} vs {cpu_terms} (worst relative {loss_err:.3e}); "
          f"worst gradient ratios {summary['grad_worst']} (the vanishing "
          f"ones of the largest gradient, {largest:.4e}); map BatchNorm "
          f"statistics worst {bn_err:.3e}")
    if loss_err > TRAIN_LOSS_RTOL or failed or bn_err > TRAIN_BN_TOL:
        raise SystemExit(f"the card's train step disagrees with the CPU's: "
                         f"loss {loss_err:.3e}, tensors {failed[:8]}, "
                         f"map BatchNorm {bn_err:.3e}")
    return summary


def gru_step_flops(policy) -> int:
    """Float32 operations of the two GRU cells for one row (two per
    multiply-add): 3 gates over input and hidden."""
    total = 0
    for enc in (policy.net.state_encoder, policy.net.second_state_encoder):
        rnn = enc.rnn
        total += 2 * 3 * rnn.hidden_size * (rnn.input_size + rnn.hidden_size)
    return total


def phase_train_trace(card: str, trainer_summary: dict, trainer) -> dict:
    """Phase 14d: TRAIN_TRACE_STEPS MapCMA train steps (after
    TRAIN_TRACE_WARMUP) of phase 14a's trainer over its store's batches,
    traced by ``torch.profiler``: device ms per train step by range, the
    busy share against 14a's untraced wall ms per train step, and the GRU
    cells' float32 bound at the batches' T*N against the ``train_rnn``
    range."""
    import random

    from torch.profiler import ProfilerActivity, profile, schedule

    from ivlnce_tpu_torch.trainers.dagger_trainer import IWTrajectoryDataset

    config = trainer.config
    random.seed(SEED)
    dataset = IWTrajectoryDataset(trainer.lmdb_features_dir,
                                  config.IL.use_iw,
                                  config.IL.inflection_weight_coef,
                                  config.IL.batch_size)
    batches = []
    while len(batches) < TRAIN_TRACE_WARMUP + TRAIN_TRACE_STEPS:
        batches += list(dataset.batches())
    batches = batches[:TRAIN_TRACE_WARMUP + TRAIN_TRACE_STEPS]
    trace_path = os.path.join(os.path.dirname(trainer.lmdb_features_dir),
                              "train_trace.json")

    def traced() -> dict:
        prof = profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            schedule=schedule(wait=0, warmup=TRAIN_TRACE_WARMUP,
                              active=TRAIN_TRACE_STEPS, repeat=1),
            on_trace_ready=lambda p: p.export_chrome_trace(trace_path),
        )
        with prof:
            for obs, prev, masks, corrected, weights in batches:
                obs = {k: v.astype(np.float32) if v.dtype == np.float16
                       else v for k, v in obs.items()}
                trainer._update_agent(obs, prev, masks, corrected, weights)
                prof.step()
        with open(trace_path) as f:
            return attribute_device_time(json.load(f), TRAIN_RANGES)

    # a trace whose device events lack their launch records (the profiler
    # loses a few now and then) is taken again, as phase 7's are
    for attempt in range(1, 4):
        got = traced()
        if got["device_us"] and not got["unmatched"]:
            break
        print(f"  train trace {attempt}: {got['device_us']} device us, "
              f"{got['unmatched']} device events without a launch record")
    else:
        raise SystemExit("no complete train trace in 3 attempts")
    rows = [b[3].size for b in batches]
    per_step = {k: us / 1e3 / TRAIN_TRACE_STEPS
                for k, us in got["by_range_us"].items()}
    missing = [r for r in TRAIN_RANGES if not per_step.get(r)]
    if missing:
        raise SystemExit(f"no device time in the ranges {missing}")
    device_ms = got["device_us"] / 1e3 / TRAIN_TRACE_STEPS
    traced_rows = rows[TRAIN_TRACE_WARMUP:]
    mean_rows = sum(traced_rows) / len(traced_rows)
    flops = gru_step_flops(trainer.policy)
    rnn_bound_ms = mean_rows * flops / FP32_FLOPS * 1e3
    top = defaultdict(float)
    for k, v in got["by_kernel_us"].items():
        top[k[:60]] += sum(v.values()) / 1e3 / TRAIN_TRACE_STEPS
    summary = {
        "card": card,
        "train_steps": TRAIN_TRACE_STEPS,
        "trace_attempts": attempt,
        "events_before_window": got["before_window"],
        "mean_rows": mean_rows,
        "device_ms_per_train_step": device_ms,
        "range_device_ms_per_train_step": per_step,
        "busy_share": device_ms / trainer_summary["wall_ms_per_train_step"],
        "traced_busy_share": got["device_us"] / got["window_us"],
        "gru_flops_per_row": flops,
        "gru_bound_ms": rnn_bound_ms,
        "top_device_ms_per_train_step": dict(
            sorted(top.items(), key=lambda kv: -kv[1])[:10]),
    }
    print(f"  [{card}] {TRAIN_TRACE_STEPS} train steps traced (mean T*N "
          f"{mean_rows:.1f}); device ms per train step {device_ms:.4f}, by "
          f"range {per_step}")
    print(f"  [{card}] busy share {summary['busy_share']:.4f} of 14a's "
          f"untraced train step ({summary['traced_busy_share']:.4f} of the "
          f"traced window's); GRU cells {flops} float32 operations per row: "
          f"bound {rnn_bound_ms:.4f} ms at 67 TFLOP/s against "
          f"{per_step['train_rnn']:.4f} ms in train_rnn (forward, with the "
          f"attention)")
    return summary


# -- phase 15: tour-BPTT training ----------------------------------------------
def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)


def bit_mismatches(got, want, where: str = "") -> list:
    """The paths at which ``got`` differs from ``want`` (nested dicts,
    lists and tuples of tensors and plain values): tensors by dtype, shape
    and every byte."""
    if isinstance(want, torch.Tensor):
        if (not isinstance(got, torch.Tensor) or got.dtype != want.dtype
                or got.shape != want.shape
                or not torch.equal(_bits(got), _bits(want))):
            return [where]
        return []
    if isinstance(want, dict):
        if not isinstance(got, dict) or got.keys() != want.keys():
            return [where]
        return [m for k in want
                for m in bit_mismatches(got[k], want[k], f"{where}.{k}")]
    if isinstance(want, (list, tuple)):
        if not isinstance(got, (list, tuple)) or len(got) != len(want):
            return [where]
        return [m for i, (g, w) in enumerate(zip(got, want))
                for m in bit_mismatches(g, w, f"{where}[{i}]")]
    return [] if got == want else [where]


def phase_tour_train(card: str, tmp: str) -> tuple:
    """Phase 15a: ``run_exp(tour_cma_train.yaml, "train")`` on the card
    through ``phase_train`` (no mapper launch) with asynchronous
    checkpoints: the tours index, one train step per TourSampler batch,
    and the last checkpoint on disk equal bit for bit to the trainer's
    final ``state_dict`` and optimizer state."""
    from ivlnce_tpu_torch.trainers.tour_dataset import TourSampler
    from ivlnce_tpu_torch.trainers.trajectory_store import TrajectoryStore

    summary, trainer = phase_train(card, tmp, "train_tour",
                                   ("TPU.async_checkpointing", "True"))
    config = trainer.config
    if not config.TPU.async_checkpointing:
        raise SystemExit("train_tour: the checkpoints were not asynchronous")
    with TrajectoryStore(trainer.lmdb_features_dir) as store:
        tours = store.get(0)["tours_to_idxs"]
    episodes = sorted(i for v in tours.values() for i in v)
    if episodes != list(range(1, summary["records"])):
        raise SystemExit(f"train_tour: the tours index {tours} does not "
                         f"cover the {summary['records'] - 1} episodes")
    per_epoch = TourSampler(tours, config.IL.batch_size,
                            shuffle=False).get_num_batches()
    want_steps = per_epoch * config.IL.epochs * config.IL.DAGGER.iterations
    if trainer.train_steps != want_steps:
        raise SystemExit(f"train_tour: {trainer.train_steps} train steps, "
                         f"TourSampler gives {want_steps}")
    ckpt_dir = config.CHECKPOINT_FOLDER
    left = [f for f in os.listdir(ckpt_dir) if f.endswith(".tmp")]
    on_disk = torch.load(summary["checkpoint"], map_location="cpu",
                         weights_only=True)
    mismatches = (
        bit_mismatches(on_disk["state_dict"], trainer.policy.state_dict(),
                       "state_dict")
        + bit_mismatches(on_disk["optim_state"],
                         trainer.optimizer.state_dict(), "optim_state"))
    if mismatches or left:
        raise SystemExit(f"train_tour: the asynchronous checkpoint differs "
                         f"at {mismatches[:8]}; temporary files {left}")
    summary.update(tours=tours, tours_count=len(tours),
                   sampler_batches_per_epoch=per_epoch,
                   async_checkpoint_tensors=len(on_disk["state_dict"]))
    print(f"  [{card}] tours index: {len(tours)} tours of "
          f"{sorted(len(v) for v in tours.values())} episodes "
          f"({summary['records']} records with the index): {tours}")
    print(f"  {trainer.train_steps} train steps = {per_epoch} TourSampler "
          f"batches x {config.IL.epochs} epochs; wall ms per train step "
          f"{summary['wall_ms_per_train_step']:.4f}; the asynchronous "
          f"checkpoint {os.path.basename(summary['checkpoint'])} equals the "
          f"final weights and optimizer state bit for bit")
    return summary, trainer


def _tour_grads(policy, batch, rnn_states, device):
    """The loss terms, every parameter's gradient (zeros where none) and
    the final RNN state of one training forward and backward of a tour
    batch from ``rnn_states``."""
    from ivlnce_tpu_torch.trainers.base_trainer import train_loss

    obs, prev, ep_masks, tour_masks, corrected, weights = batch
    t, n = corrected.shape

    def dev(a, dt=None):
        x = torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return x.to(dt) if dt is not None else x

    cfg = policy.model_config.PROGRESS_MONITOR
    policy.zero_grad(set_to_none=True)
    terms = train_loss(
        policy, {k: dev(v) for k, v in obs.items()}, dev(prev),
        dev(ep_masks.reshape(t, n), torch.float32),
        dev(tour_masks.reshape(t, n), torch.float32), dev(corrected),
        dev(weights, torch.float32), rnn_states, cfg.use, cfg.alpha)
    terms[0].backward()
    grads = {k: (torch.zeros_like(p) if p.grad is None else p.grad)
             .detach().double().cpu()
             for k, p in policy.named_parameters()}
    return [float(x.detach()) for x in terms[:3]], grads, terms[3].detach()


def phase_tour_reference(card: str, trainer) -> dict:
    """Phase 15b: two consecutive TourSampler batches of 15a's store in
    which a lane continues its tour, with 15a's trained weights, on the
    card and on the CPU; each side starts the first batch from a fresh
    state and carries its own final state into the second
    (``carry_in``). Loss terms within TRAIN_LOSS_RTOL; the carried states
    and every gradient within TRAIN_GRAD_TOL of the CPU tensor's largest
    |value|, but for the text keys' bias, whose gradient vanishes in exact
    arithmetic (TRAIN_NOISE_TOL of the largest gradient, as in 14b)."""
    import copy

    from ivlnce_tpu_torch.trainers.iterative_dagger_trainer import carry_in
    from ivlnce_tpu_torch.trainers.tour_dataset import (
        TourSampler,
        TourTrajectoryDataset,
    )
    from ivlnce_tpu_torch.trainers.trajectory_store import TrajectoryStore

    config = trainer.config
    with TrajectoryStore(trainer.lmdb_features_dir) as store:
        tours = store.get(0)["tours_to_idxs"]
    sampler = TourSampler(tours, config.IL.batch_size,
                          rng=np.random.RandomState(SEED))
    dataset = TourTrajectoryDataset(trainer.lmdb_features_dir,
                                    config.IL.use_iw,
                                    config.IL.inflection_weight_coef)
    dataset.set_tour_done_idxs(sampler.get_tour_done_idxs())
    batches = list(dataset.batches(sampler))
    dataset.close()
    n = config.IL.batch_size
    k = next((k for k in range(len(batches) - 1)
              if (batches[k + 1][3].reshape(-1, n)[0] == 1).any()), None)
    if k is None:
        raise SystemExit("no two consecutive tour batches in which a lane "
                         "continues its tour")
    pair = [({key: v.astype(np.float32) if v.dtype == np.float16 else v
              for key, v in b[0].items()},) + b[1:]
            for b in batches[k:k + 2]]
    continuing = int((pair[1][3].reshape(-1, n)[0] == 1).sum())
    sides = {}
    for label, device in (("cpu", "cpu"), ("card", "cuda")):
        policy = copy.deepcopy(trainer.policy).to(device)
        carry, runs = None, []
        t0 = time.perf_counter()
        for batch in pair:
            rnn_in = carry_in(policy, config.MODEL, carry, n, device)
            terms, grads, carry = _tour_grads(policy, batch, rnn_in, device)
            runs.append((terms, grads, carry.double().cpu()))
        print(f"  {label}: two batches forward and backward in "
              f"{time.perf_counter() - t0:.2f} s")
        sides[label] = runs
    loss_err, carry_err, worst, noise, failed = 0.0, 0.0, (0.0, None), 0.0, []
    for b, ((cpu_terms, cpu, cpu_rnn), (card_terms, on_card, card_rnn)) in \
            enumerate(zip(sides["cpu"], sides["card"])):
        loss_err = max([loss_err] + [abs(a - c) / abs(c) for a, c in
                                     zip(card_terms, cpu_terms) if c])
        carry_err = max(carry_err, float((card_rnn - cpu_rnn).abs().max())
                        / float(cpu_rnn.abs().max()))
        largest = max(float(g.abs().max()) for g in cpu.values())
        for name, g in cpu.items():
            if name == "net.text_k.bias":
                ratio = max(float(on_card[name].abs().max()),
                            float(g.abs().max())) / largest
                noise = max(noise, ratio)
                ok = ratio <= TRAIN_NOISE_TOL
            else:
                diff = float((on_card[name] - g).abs().max())
                scale = float(g.abs().max())
                ratio = diff / scale if scale else (
                    0.0 if diff == 0 else math.inf)
                if ratio > worst[0]:
                    worst = (ratio, f"batch {b}: {name}")
                ok = ratio <= TRAIN_GRAD_TOL
            if not ok:
                failed.append((b, name, ratio))
    summary = {"card": card, "batches": [k, k + 1], "T": [b[4].shape[0]
                                                          for b in pair],
               "N": n, "continuing_lanes": continuing,
               "loss_terms_cpu": [r[0] for r in sides["cpu"]],
               "loss_terms_card": [r[0] for r in sides["card"]],
               "loss_rel_err": loss_err, "carry_err": carry_err,
               "grad_worst": {"ratio": worst[0], "tensor": worst[1]},
               "vanishing_noise": noise}
    print(f"  tour batches {k} and {k + 1} card vs CPU [{card}], T "
          f"{summary['T']}, N={n}, {continuing} lanes continuing a tour: "
          f"loss terms worst relative {loss_err:.3e}; carried states "
          f"{carry_err:.3e} of their largest |value|; worst gradient "
          f"{worst[0]:.3e} ({worst[1]}); text_k.bias noise {noise:.3e} of "
          f"the largest gradient")
    if (loss_err > TRAIN_LOSS_RTOL or carry_err > TRAIN_GRAD_TOL
            or failed):
        raise SystemExit(f"the card's tour batches disagree with the CPU's: "
                         f"loss {loss_err:.3e}, carry {carry_err:.3e}, "
                         f"tensors {failed[:8]}")
    return summary


def phase_tour_training(card: str, tmp: str) -> dict:
    """Phase 15: tour-BPTT training through run_exp (15a) and two carried
    tour batches card vs CPU (15b)."""
    t0 = time.perf_counter()
    print("  15a: tour-BPTT training through run_exp")
    train, trainer = phase_tour_train(card, tmp)
    print("  15b: two carried tour batches, card vs CPU")
    reference = phase_tour_reference(card, trainer)
    print(f"  phase 15 took {time.perf_counter() - t0:.2f} s")
    return {"train_tour": train, "tour_reference": reference}


def phase_training(card: str, tmp: str, one_tour) -> dict:
    """Phase 14: MapCMA teacher forcing (14a) and its trained checkpoint
    evaluated on the card, one full-width train step card vs CPU (14b),
    LatentCMA (14c) and the trace (14d)."""
    import shutil

    out = {}
    print("  14a: MapCMA teacher forcing through run_exp")
    t0 = time.perf_counter()
    train, trainer = phase_train(card, tmp, "train_map_cma")
    out["train_map_cma"] = train
    trained = os.path.join(tmp, "trained_map_cma.0.pth")
    shutil.copy(train["checkpoint"], trained)
    out["train_map_cma_eval"] = phase_end_to_end(
        card, tmp, trained, "iterative", one_tour, run="train_map_cma_eval")
    print("  14b: one full-width train step, card vs CPU")
    out["train_reference"] = phase_train_reference(card, train["store"])
    print("  14c: LatentCMA through run_exp")
    out["train_latent"] = phase_train(card, tmp, "train_latent")[0]
    print("  14d: traced train steps")
    out["train_trace"] = phase_train_trace(card, train, trainer)
    print(f"  phase 14 took {time.perf_counter() - t0:.2f} s")
    return out


# -- phase 16: bfloat16 ---------------------------------------------------------
# H100 SXM dense bfloat16 tensor-core peak, operations per second
BF16_FLOPS = 989e12
# the ranges TPU.compute_dtype bfloat16 runs in bfloat16
BF16_RANGES = ("depth_encoder", "map_encoder", "rgb_encoder", "semantics")
# convolution and matrix kernels, by name; those that compute in bfloat16
# (cuDNN's and CUTLASS's carry the dtype in the name, cuBLAS's nvjet_tst
# reads and writes bfloat16); those in a lower precision than float32
CONV_KERNEL = re.compile(r"fprop|dgrad|wgrad|convolve|conv2d|implicit_gemm|"
                         r"winograd|fft|gemm|gemv|nvjet|xmma|cutlass")
BF16_KERNEL = re.compile(r"bf16|bfloat16|BFloat16|nvjet_tst")
LOW_KERNEL = re.compile(r"bf16|bfloat16|BFloat16|half|f16|tf32|nvjet_[th]")


def check_bf16_kernels(got: dict, path: str) -> dict:
    """The convolution and matrix kernels of a bfloat16 run's trace, by
    range: each one inside the bfloat16 ranges must compute in bfloat16
    and none inside ``gru_attention`` below float32 (by kernel name).
    Returns how many distinct kernels were checked in each range."""
    by_range = defaultdict(set)
    for name, where in got["by_kernel_us"].items():
        if CONV_KERNEL.search(name):
            for r in where:
                by_range[r].add(name)
    checked = {r: len(by_range[r]) for r in BF16_RANGES + ("gru_attention",)
               if by_range[r]}
    wrong = [(r, n[:120]) for r in BF16_RANGES for n in by_range[r]
             if not BF16_KERNEL.search(n)]
    wrong += [("gru_attention", n[:120]) for n in by_range["gru_attention"]
              if LOW_KERNEL.search(n)]
    print(f"  {path}: convolution and matrix kernels checked by range "
          f"{checked}")
    if wrong or not by_range["gru_attention"] or not any(
            by_range[r] for r in BF16_RANGES):
        raise SystemExit(f"{path}: kernels of the wrong precision: "
                         f"{wrong[:6]}")
    return checked


def _bf16_vs_f32(fn) -> dict:
    """For ``fn(side, dtype)`` -> a tensor, on each side ("cpu", "card"):
    the largest |bfloat16 - float32| over the largest |float32|, both
    runs on that side. The card's error must lie within [0.1, 2] times
    the CPU's: bfloat16 rounding as on the CPU, not float32 or TF32."""
    out = {}
    for side in ("cpu", "card"):
        with torch.no_grad():
            want = fn(side, None).float().cpu()
            got = fn(side, torch.bfloat16).float().cpu()
        out[side] = float((got - want).abs().max() / want.abs().max())
    out["ratio"] = out["card"] / out["cpu"]
    return out


def _enqueue_and_device_ms(fns: dict, reps: int = 10) -> dict:
    """For each of ``fns`` (the same work in two dtypes), the median host
    time to enqueue one call on an idle card and the median device time
    of a call (the card spinning first, long enough to hide the enqueue,
    as ``cuda_ms`` does; a span the host outlasted is taken again), the
    dtypes' calls alternating."""
    enqueue = {k: [] for k in fns}
    device = {k: [] for k in fns}
    order = list(fns)
    for r in range(2 * reps):
        for k in (order if r % 2 == 0 else order[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fns[k]()
            enqueue[k].append((time.perf_counter() - t0) * 1e3)
    retakes = 0
    for r in range(reps):
        for k in (order if r % 2 == 0 else order[::-1]):
            spin = SPIN_MS + 3 * float(np.median(enqueue[k]))
            while True:
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                _spin(spin)
                a.record()
                t0 = time.perf_counter()
                fns[k]()
                host = (time.perf_counter() - t0) * 1e3
                b.record()
                b.synchronize()
                if host < spin:
                    break
                # the host stalled past the spin (its clock varies more
                # than the card's): this span held host time, take it
                # again
                retakes += 1
                if retakes > reps:
                    raise SystemExit(f"enqueueing outlasted the card's "
                                     f"{spin:.3f} ms spin {retakes} times")
            device[k].append(a.elapsed_time(b))
    return {k: {"enqueue_ms": float(np.median(enqueue[k][reps:])),
                "device_ms": float(np.median(device[k]))} for k in fns}


def phase_bf16_reference(card: str, device: str = "cuda") -> dict:
    """Phase 16a: seeded full-width weights with random BatchNorm
    statistics, the same inputs on the card and on the CPU, each part in
    float32 and in bfloat16 on each side: the depth encoder (256^2), the
    map encoder (64^2 maps of 13 classes), the RGB ResNet-50 (224^2),
    RedNet (256^2) and one policy step of each family (hidden 512;
    logits and RNN states). The card's bfloat16-vs-float32 error must be
    0.1 to 2 times the CPU's; RedNet's card labels must equal its card
    float32 labels wherever the float32 top-2 margin exceeds 4 times the
    largest |bfloat16 - float32| score. Then, on the card, each encoder's
    host enqueue time and device time in float32 and in bfloat16,
    interleaved (``_enqueue_and_device_ms``). (``device`` "cpu" rehearses
    the first part of the phase without a card.)"""
    import copy

    from ivlnce_tpu_torch.config import get_config
    from ivlnce_tpu_torch.models import rednet as TR
    from ivlnce_tpu_torch.models.nn import apply_cast

    b = 2
    rng = np.random.default_rng(SEED)
    tokens = np.zeros((b, 200), np.int64)
    tokens[:, :24] = rng.integers(1, 32, (b, 24))
    inputs = {
        "instruction": tokens,
        "depth": rng.uniform(0, 1, (b, 256, 256, 1)).astype(np.float32),
        "occupancy_map": rng.integers(0, 2, (b, 64, 64)).astype(np.uint8),
        "semantic_map": rng.integers(0, 13, (b, 64, 64)).astype(np.uint8),
        "rgb": rng.integers(0, 256, (b, 224, 224, 3)).astype(np.uint8),
        "rgb256": rng.integers(0, 256, (b, 256, 256, 3)).astype(np.uint8),
    }
    rnn = rng.normal(0, 0.5, (b, 3, 512)).astype(np.float32)
    devices = {"cpu": "cpu", "card": device}
    on = {side: {k: torch.from_numpy(v).to(dev) for k, v in inputs.items()}
          for side, dev in devices.items()}
    map_policy = seeded_policy(get_config(CONFIG, list(BF16_OPTS)))
    latent_policy = seeded_latent_policy(latent_config(
        LATENT_VARIANTS["4_pool_end_cma"][0] + BF16_OPTS))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        rednet = TR.RedNet()
        randomize_norm_statistics(rednet)
        randomize_norm_statistics(map_policy)
    models = {side: {n: copy.deepcopy(m).to(dev).eval() for n, m in (
        ("map", map_policy), ("latent", latent_policy), ("rednet", rednet))}
        for side, dev in devices.items()}

    def step(family):
        keys = (("instruction", "depth", "occupancy_map", "semantic_map")
                if family == "map" else ("instruction", "depth", "rgb"))

        def run(side, dtype):
            # the same policy as float32 (None) or bfloat16
            policy = models[side][family]
            policy.net.compute_dtype = dtype
            dev = devices[side]
            layers = policy.num_recurrent_layers
            m = torch.ones(b, 1, device=dev)
            out = policy.act_iterative(
                {k: on[side][k] for k in keys},
                torch.from_numpy(rnn[:, :layers]).to(dev),
                torch.zeros(b, 1, dtype=torch.int64, device=dev),
                m, m, m, m)
            return torch.cat([out.logits, out.rnn_states.flatten(1)], 1)
        return run

    def scores(side, dtype):
        x = on[side]
        return _scores(models[side]["rednet"], x["rgb256"],
                       x["depth"][..., 0], dtype)

    parts = {
        "depth_encoder": lambda side, d: models[side]["map"].net
        .depth_encoder(on[side]["depth"], d),
        "map_encoder": lambda side, d: models[side]["map"].net.map_encoder(
            on[side]["occupancy_map"], on[side]["semantic_map"], dtype=d),
        "rgb_encoder": lambda side, d: models[side]["latent"].net
        .rgb_encoder(on[side]["rgb"], d),
        "rednet": scores,
        "map_cma_step": step("map"),
        "latent_cma_step": step("latent"),
    }
    out = {}
    for name, fn in parts.items():
        t0 = time.perf_counter()
        out[name] = err = _bf16_vs_f32(fn)
        print(f"  {name}: bfloat16 vs float32, largest |difference| over "
              f"the largest |float32 value| [{card}]: CPU {err['cpu']:.4e}, "
              f"card {err['card']:.4e} ({err['ratio']:.3f}x the CPU's; "
              f"{time.perf_counter() - t0:.2f} s)")
    with torch.no_grad():
        f32 = scores("card", None).float()
        bf16 = scores("card", torch.bfloat16).float()
    tol = float((bf16 - f32).abs().max())
    top = f32.topk(2, -1).values
    sure = (top[..., 0] - top[..., 1]) > 4 * tol
    flipped = int((sure & (f32.argmax(-1) != bf16.argmax(-1))).sum())
    out["rednet_labels"] = {"sure_share": float(sure.float().mean()),
                            "flipped": flipped,
                            "largest_score_error": tol}
    print(f"  RedNet labels, card bfloat16 vs card float32: "
          f"{float(sure.float().mean()):.4f} of the pixels have a float32 "
          f"top-2 margin over 4 x {tol:.4e}; {flipped} of them differ")
    bad = {k: v["ratio"] for k, v in out.items()
           if "ratio" in v and not 0.1 <= v["ratio"] <= 2.0}
    if bad or flipped or not sure.any():
        raise SystemExit(f"the card's bfloat16 disagrees with the CPU's: "
                         f"{bad}, {flipped} sure labels flipped")
    if device != "cuda":
        return out
    # the encoders alone: RedNet from inputs normalized beforehand (the
    # resize's weights reach the card by a copy that waits on it), no
    # policy step (its instruction encoder reads the lengths back)
    card_rednet = models["card"]["rednet"]
    normalized = {d: TR.normalize_inputs(on["card"]["rgb256"],
                                         on["card"]["depth"][..., 0], d)
                  for d in (None, torch.bfloat16)}
    timed = {k: parts[k] for k in ("depth_encoder", "map_encoder",
                                   "rgb_encoder")}
    timed["rednet"] = lambda side, d: (
        card_rednet(*normalized[d]) if d is None
        else apply_cast(card_rednet, d, *normalized[d]))
    out["host_and_device_ms"] = {}
    with torch.inference_mode():
        for name, fn in timed.items():
            got = _enqueue_and_device_ms({
                "f32": lambda fn=fn: fn("card", None),
                "bf16": lambda fn=fn: fn("card", torch.bfloat16)})
            out["host_and_device_ms"][name] = got
            print(f"  {name}, B={b} [{card}]: enqueue float32 "
                  f"{got['f32']['enqueue_ms']:.4f} ms, bfloat16 "
                  f"{got['bf16']['enqueue_ms']:.4f} ms; device float32 "
                  f"{got['f32']['device_ms']:.4f} ms, bfloat16 "
                  f"{got['bf16']['device_ms']:.4f} ms")
    return out


def _scores(model, rgb, depth, dtype):
    """RedNet's scores of ``predict_semantics``' inputs, in ``dtype``."""
    from ivlnce_tpu_torch.models import rednet as TR
    from ivlnce_tpu_torch.models.nn import apply_cast

    inputs = TR.normalize_inputs(rgb, depth, dtype)
    return model(*inputs) if dtype is None else apply_cast(model, dtype,
                                                           *inputs)


def phase_bf16_training(card: str, tmp: str) -> dict:
    """Phase 16e: ``map_cma_train_tf.yaml`` under bfloat16 with phase
    14a's cuts through ``phase_train`` (K1 and K2 once per collection
    step): the stored depth features are float32 (collection encodes the
    frozen encoders in float32, as the JAX package's ``encode_feats``
    does), so is every tensor of the checkpoint and the optimizer state,
    and a train step's map encoder runs and differentiates in float32.
    Then the LatentCMA and tour-BPTT trainers under bfloat16, cut to 6
    and 20 collected episodes."""
    import random

    from ivlnce_tpu_torch.trainers.base_trainer import load_checkpoint
    from ivlnce_tpu_torch.trainers.dagger_trainer import IWTrajectoryDataset
    from ivlnce_tpu_torch.trainers.trajectory_store import TrajectoryStore

    out = {}
    summary, trainer = phase_train(card, tmp, "train_map_cma", BF16_OPTS,
                                   run="train_map_cma_bf16")
    net = trainer.policy.net
    if net.compute_dtype != torch.bfloat16:
        raise SystemExit("train_map_cma_bf16: the policy is not bfloat16")
    with TrajectoryStore(trainer.lmdb_features_dir) as store:
        first = int(isinstance(store.get(0), dict))  # a tours index
        stored = store.get(first)[0]["depth_features"].dtype
    ckpt = load_checkpoint(summary["checkpoint"])
    tensors = [v for v in ckpt["state_dict"].values()] + [
        v for st in ckpt["optim_state"]["state"].values()
        for v in st.values() if v.dim()]
    ckpt_dtypes = {str(v.dtype) for v in tensors if v.is_floating_point()}
    seen = {"map_encoder": set(), "collection_depth_encoder": set()}
    hooks = [m.register_forward_pre_hook(
        lambda m, inp, k=k: seen[k].add((inp[0].dtype, m.weight.dtype)))
        for k, enc in (("map_encoder", net.map_encoder),
                       ("collection_depth_encoder", net.depth_encoder))
        for m in enc.modules() if isinstance(m, torch.nn.Conv2d)]
    try:
        random.seed(SEED)
        obs, prev, masks, corrected, weights = next(IWTrajectoryDataset(
            trainer.lmdb_features_dir, trainer.config.IL.use_iw,
            trainer.config.IL.inflection_weight_coef, 5).batches())
        trainer._update_agent(obs, prev, masks, corrected, weights)
        with torch.no_grad():
            trainer._encode_feats({"depth": torch.rand(2, 256, 256, 1,
                                                        device="cuda")})
    finally:
        for hook in hooks:
            hook.remove()
    grads = {str(p.grad.dtype) for p in net.map_encoder.parameters()
             if p.grad is not None}
    f32 = {(torch.float32, torch.float32)}
    summary.update(stored_depth_features=str(stored),
                   checkpoint_dtypes=sorted(ckpt_dtypes),
                   map_encoder_train_dtypes=sorted(map(str, seen[
                       "map_encoder"])), map_encoder_grad_dtypes=sorted(grads))
    print(f"  stored depth features {stored}; checkpoint tensors "
          f"{sorted(ckpt_dtypes)}; a train step's map encoder convolutions "
          f"saw {seen['map_encoder']}, its gradients {sorted(grads)}; "
          f"collection's depth encoder {seen['collection_depth_encoder']}")
    if (stored != np.float32 or ckpt_dtypes != {"torch.float32"}
            or seen["map_encoder"] != f32 or grads != {"torch.float32"}
            or seen["collection_depth_encoder"] != f32):
        raise SystemExit("train_map_cma_bf16: float32 parts of the "
                         "training ran or were stored in another dtype")
    out["train_map_cma_bf16"] = summary
    # the tour sampler needs at least as many tours (6 of 4 episodes in
    # the fake train split) as lanes per batch (5)
    for path, episodes in (("train_latent", "6"), ("train_tour", "20")):
        out[f"{path}_bf16"] = phase_train(
            card, tmp, path, BF16_OPTS + ("IL.DAGGER.update_size", episodes),
            run=f"{path}_bf16")[0]
    return out


def phase_bf16(card: str, tmp: str, ckpts: dict, one_tour, e2e: dict,
               traces: dict) -> dict:
    """Phase 16: TPU.compute_dtype bfloat16. (a) the parts card vs CPU;
    (b) the iterative eval (one tour per lane) and its trace, and the
    known-map eval; (c) the predicted-semantics eval and its trace against
    RedNet's bfloat16 bound; (d) ``4_pool_end_cma`` and its trace against
    the RGB and depth ResNet-50s' bfloat16 bounds; the episodic evals
    (MapCMA, RxR) cut to a few episodes; (e) training. The bfloat16 runs'
    results go into ``e2e`` and ``traces`` beside the float32 ones."""
    t0 = time.perf_counter()
    out = {}
    print("  16a: full-width parts, card vs CPU, bfloat16 vs float32")
    out["reference"] = phase_bf16_reference(card)
    print("  16b-d: evals through run_exp, one tour per lane; traced")
    for path, ckpt, traced in (
            ("iterative", "map", True), ("known", "map", False),
            ("predicted", "map", True),
            ("latent_4_pool_end_cma", "latent", True)):
        name = f"{path}_bf16"
        e2e[name] = phase_end_to_end(card, tmp, ckpts[ckpt], name, one_tour)
        if traced:
            traces[name] = phase_trace(
                card, tmp, ckpts[ckpt], e2e[name]["wall_ms_per_step"], name,
                one_tour)
    lanes = e2e["predicted_bf16"]["lanes"]
    rednet = rednet_flops(256)
    resnets = latent_encoder_flops()
    bounds = {
        "predicted_bf16": {"semantics": lanes * rednet},
        "latent_4_pool_end_cma_bf16": {
            "rgb_encoder": lanes * resnets["rgb"],
            "depth_encoder": lanes * resnets["depth"]},
    }
    out["bounds_ms"] = {}
    for name, by_range in bounds.items():
        got = traces[name]["range_device_ms_per_step"]
        for r, flops in by_range.items():
            bound = {"bf16": flops / BF16_FLOPS * 1e3,
                     "f32": flops / FP32_FLOPS * 1e3}
            out["bounds_ms"][f"{name}.{r}"] = {**bound, "ms": got.get(r)}
            if not got.get(r):
                raise SystemExit(f"{name}: no device time in {r}")
            print(f"  {name} {r}: {got[r]:.4f} ms per policy step [{card}] "
                  f"against its bound {bound['bf16']:.4f} ms at 989 TFLOP/s "
                  f"bfloat16 ({bound['f32']:.4f} ms at 67 TFLOP/s float32; "
                  f"{flops} operations per policy step)")
    out["ranges_f32_bf16"] = {}
    for f32, bf16 in (("iterative", "iterative_bf16"),
                      ("predicted", "predicted_bf16"),
                      ("latent", "latent_4_pool_end_cma_bf16")):
        a = traces[f32]["range_device_ms_per_step"]
        b = traces[bf16]["range_device_ms_per_step"]
        both = {r: (a.get(r, 0.0), b.get(r, 0.0)) for r in sorted(set(a) | set(b))}
        out["ranges_f32_bf16"][bf16] = both
        print(f"  device ms per policy step by range, float32 / bfloat16 "
              f"[{card}] {bf16}: " + ", ".join(
                  f"{r} {x:.4f} / {y:.4f}" for r, (x, y) in both.items())
              + f"; all {traces[f32]['device_ms_per_step']:.4f} / "
              f"{traces[bf16]['device_ms_per_step']:.4f}")
    print("  16b: the episodic evals in bfloat16, 6 (MapCMA) and 4 (RxR) "
          "episodes")
    e2e["map_episodic_bf16"] = phase_end_to_end(
        card, tmp, ckpts["map"], "map_episodic_bf16",
        ("EVAL.EPISODE_COUNT", "6"))
    e2e["rxr_bf16"] = phase_end_to_end(card, tmp, ckpts["rxr"], "rxr_bf16",
                                       ("EVAL.EPISODE_COUNT", "4"))
    print("  16e: training in bfloat16")
    out["training"] = phase_bf16_training(card, tmp)
    print(f"  phase 16 took {time.perf_counter() - t0:.2f} s")
    return out

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # the port reads the host-phase switch at import (phase 13c)
    os.environ["IVLNCE_PHASE_TIMES"] = "1"
    from ivlnce_tpu_torch.ops import kernels
    from ivlnce_tpu_torch.utils.device import resolve_device

    t_start = time.perf_counter()
    resolve_device("cuda")  # TF32 off
    card = card_line()
    print(card)
    name = torch.cuda.get_device_name(0)

    print("phase 2: build")
    t0 = time.perf_counter()
    kernels.library()
    print(f"  built in {time.perf_counter() - t0:.2f} s")
    print("  " + kernels.build_log.strip().replace("\n", "\n  "))
    print("  registers and shared memory of the K1, K2 and K3 kernels:")
    for kernel, usage in ptxas_usage(kernels.build_log).items():
        print(f"    {kernel}: {usage}")
    clusters = ctypes.c_int(0)
    err = kernels.library().mapper_rasterize_resident_clusters(
        64, 64, ctypes.byref(clusters))
    kernels.check(err, "mapper_rasterize_resident_clusters")
    print(f"  rasterize_cluster: {clusters.value} clusters of 8 blocks "
          f"resident at once (64 x 64 map), {8 * clusters.value} blocks")

    print("phase 3: kernels vs plain versions (256^2, G=1024; K3 2^18 "
          "points per cloud, edge cases, val_seen clouds)")
    worst = phase_kernels_vs_plain_walks()
    worst["known_load"] = phase_known_vs_plain()

    print("phase 4: timing (B=64 and B=3, noise and FakeSim walks; K3 "
          "at B=64, L=3 and L=1)")
    walks_timed = phase_timing(card)
    timing = {k: walks_timed["fakesim_b64"][k]
              for k in ("accumulate", "rasterize")}
    known_timed = phase_known_timing(card)
    timing["known_load"] = known_timed["b64"]

    print("phase 5: full-width steps, card vs CPU")
    reference = {"policy": phase_reference(card),
                 "known_occupied": phase_known_reference(card),
                 "rednet": phase_rednet_reference(card),
                 "latent": phase_latent_reference(card),
                 "rxr_encode": phase_rxr_reference(card)}

    from ivlnce_tpu_torch.config import get_config
    from ivlnce_tpu_torch.trainers.base_trainer import save_checkpoint

    e2e, traces = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "ckpt.0.pth")
        save_checkpoint(seeded_policy(get_config(CONFIG)),
                        get_config(CONFIG), ckpt)
        one_tour = one_tour_per_lane(tmp)
        print("phase 6: end-to-end iterative eval through run_exp")
        e2e["iterative"] = phase_end_to_end(card, tmp, ckpt, "iterative")
        print("phase 7: traced eval, device time by range")
        traces["iterative"] = phase_trace(
            card, tmp, ckpt, e2e["iterative"]["wall_ms_per_step"],
            "iterative", one_tour)
        print("phase 8: known-map eval through run_exp, one tour per lane")
        e2e["known"] = phase_end_to_end(card, tmp, ckpt, "known", one_tour)
        print("phase 9: predicted-semantics eval through run_exp, one tour "
              "per lane, then traced")
        e2e["predicted"] = phase_end_to_end(card, tmp, ckpt, "predicted",
                                            one_tour)
        traces["predicted"] = phase_trace(
            card, tmp, ckpt, e2e["predicted"]["wall_ms_per_step"],
            "predicted", one_tour)
        semantics_ms = traces["predicted"]["range_device_ms_per_step"].get(
            "semantics")
        if not semantics_ms:
            raise SystemExit("no device time in the semantics range")
        flops = rednet_flops(256)
        traces["predicted"]["rednet_flops_per_image"] = flops
        traces["predicted"]["semantics_bound_ms"] = (
            3 * flops / FP32_FLOPS * 1e3)
        print(f"  RedNet: {flops} float32 operations per 256^2 image, 3 "
              f"per policy step: bound "
              f"{traces['predicted']['semantics_bound_ms']:.4f} ms at 67 "
              f"TFLOP/s against {semantics_ms:.4f} ms in the semantics range")

        print("phase 10: the latent baselines' tour evals through run_exp, "
              "one tour per lane")
        for variant, (flags, layers) in LATENT_VARIANTS.items():
            path = f"latent_{variant}"
            config = latent_config(flags)
            latent_ckpt = os.path.join(tmp, f"ckpt_{path}.0.pth")
            save_checkpoint(seeded_latent_policy(config), config,
                            latent_ckpt)
            e2e[path] = phase_end_to_end(card, tmp, latent_ckpt, path,
                                         one_tour)
            if e2e[path]["recurrent_layers"] != layers:
                raise SystemExit(f"{path} loaded a policy with "
                                 f"{e2e[path]['recurrent_layers']} "
                                 f"recurrent layers, not {layers}")
        print("phase 11: the memory_at_end baseline traced")
        path = "latent_4_pool_end_cma"
        traces["latent"] = trace = phase_trace(
            card, tmp, latent_ckpt, e2e[path]["wall_ms_per_step"], path,
            one_tour)
        ranges = trace["range_device_ms_per_step"]
        if not ranges.get("rgb_encoder") or not ranges.get("depth_encoder"):
            raise SystemExit("no device time in the encoder ranges")
        flops = latent_encoder_flops()
        lanes = e2e[path]["lanes"]
        trace["resnet_flops_per_frame"] = flops
        trace["rgb_bound_ms"] = lanes * flops["rgb"] / FP32_FLOPS * 1e3
        trace["depth_bound_ms"] = lanes * flops["depth"] / FP32_FLOPS * 1e3
        print(f"  ResNet-50s: RGB 224^2 {flops['rgb']}, depth 256^2 "
              f"{flops['depth']} float32 operations per frame, {lanes} "
              f"frames each per policy step: bounds "
              f"{trace['rgb_bound_ms']:.4f} ms (RGB) and "
              f"{trace['depth_bound_ms']:.4f} ms (depth) at 67 TFLOP/s "
              f"against {ranges['rgb_encoder']:.4f} ms in the rgb_encoder "
              f"range and {ranges['depth_encoder']:.4f} ms in the "
              f"depth_encoder range")

        print("phase 12: episodic evals through run_exp")
        e2e["map_episodic"] = phase_end_to_end(card, tmp, ckpt,
                                               "map_episodic")
        rxr_ckpt = os.path.join(tmp, "ckpt_rxr.0.pth")
        save_checkpoint(seeded_latent_policy(get_config(RXR_CONFIG),
                                             RXR_SEED),
                        get_config(RXR_CONFIG), rxr_ckpt)
        e2e["rxr"] = phase_end_to_end(card, tmp, rxr_ckpt, "rxr")

        print("phase 13: the eval surface: checkpoint kinds, videos and "
              "the trace (host phases: every run_exp eval above)")
        for kind, run in phase_checkpoint_kinds(card, tmp,
                                                one_tour).items():
            e2e[f"ckpt_{kind}"] = run
        e2e["map_episodic_videos"] = phase_videos_and_trace(card, tmp, ckpt)

        print("phase 14: training: MapCMA teacher forcing and LatentCMA "
              "through run_exp, a train step card vs CPU, the trace")
        training = phase_training(card, tmp, one_tour)
        e2e["train_map_cma_eval"] = training.pop("train_map_cma_eval")

        print("phase 15: tour-BPTT training through run_exp, two carried "
              "batches card vs CPU")
        training.update(phase_tour_training(card, tmp))

        print("phase 16: TPU.compute_dtype bfloat16: the parts card vs CPU, "
              "the evals traced, training")
        bf16 = phase_bf16(card, tmp, {"map": ckpt, "latent": latent_ckpt,
                                      "rxr": rxr_ckpt}, one_tour, e2e,
                          traces)
        training.update(bf16.pop("training"))

    # each kernel's launches come from the path that runs it
    kernel_path = {"accumulate": "iterative", "rasterize": "iterative",
                   "known_load": "known"}
    replaces = {
        "accumulate": "ivlnce_tpu/mapping/mapper.py:333",
        "rasterize": "ivlnce_tpu/mapping/mapper.py:393",
        "known_load": "ivlnce_tpu/mapping/mapper.py:510",
    }
    line = {"kernels": [
        {
            "name": k,
            "route": "cuda",
            "source": "ivlnce_tpu_torch/csrc/mapper_kernels.cu",
            "replaces": replaces[k],
            "launches": e2e[kernel_path[k]]["launches"][k],
            "max_abs_err": worst[k],
            "match": worst[k] == 0,
            "ms": timing[k]["ms"],
            "plain_ms": timing[k]["plain_ms"],
            "bound_ms": timing[k]["bound_ms"],
            "bound_by": timing[k]["bound_by"],
            "library_ms": None,
            "yardstick_ms": timing[k]["yardstick_ms"],
            "cuda_kernels": KERNEL_NAMES[k],
            "launches_by_path": {
                **{p: v["launches"][k] for p, v in e2e.items()},
                **{p: training[p]["launches"][k]
                   for p in ("train_map_cma", "train_latent", "train_tour",
                             "train_map_cma_bf16", "train_latent_bf16",
                             "train_tour_bf16")}},
            "pass_ms": timing[k]["pass_ms"],
        }
        for k in ("accumulate", "rasterize", "known_load")
    ]}
    for k in ("accumulate", "rasterize"):
        entry = next(e for e in line["kernels"] if e["name"] == k)
        entry["walk"] = "fakesim walk B=64"
        entry["walks"] = {w: {f: v[k][f] for f in ("ms", "plain_ms",
                                                   "bound_ms", "pass_ms")}
                          for w, v in walks_timed.items()}
    entry = next(e for e in line["kernels"] if e["name"] == "known_load")
    entry["size"] = "B=64, 2^18 points per cloud, G=1024, the whole load"
    entry["touched_bound_ms"] = timing["known_load"]["touched_bound_ms"]
    entry["sizes"] = {
        size: {f: v[f] for f in ("ms", "device_ms", "plain_ms", "bound_ms",
                                 "touched_bound_ms", "pass_ms",
                                 "peak_bytes")}
        for size, v in known_timed.items()}
    print(json.dumps({"end_to_end": e2e, "trace": traces,
                      "training": training,
                      "reference": reference, "bf16": bf16,
                      "kernel_walks": walks_timed,
                      "known_load_timing": known_timed,
                      "seconds": time.perf_counter() - t_start}))
    print(card)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
