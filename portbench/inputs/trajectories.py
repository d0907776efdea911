"""Seeded batches of the IL update in the form the DAgger collate hands
``_update_agent``: observations T-major over (T * N) rows, padded to the
batch's longest trajectory with 1.0 as the collate pads them, and in the
form collection stores them: the frozen depth encoder's features in place
of the depth frames, the egocentric maps, the instruction tokens and the
progress sensor.

Every batch holds the same trajectory lengths, spread evenly over
``trajectory_steps``, in a seeded order, so that each seed gives the same
amount of work. Expert actions follow a seeded walk: runs of one action
(a turn or a step forward) of seeded lengths, ending in STOP; the
inflection weight is ``inflection_weight_coef`` where the action changes
(and at t = 0), else 1."""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from portbench.inputs.scenes import rng_for


class Batch(NamedTuple):
    observations: Dict[str, np.ndarray]  # (T * N, ...) T-major
    prev_actions: np.ndarray  # (T * N, 1) int64
    not_done_masks: np.ndarray  # (T * N, 1) uint8
    corrected: np.ndarray  # (T, N) int64
    weights: np.ndarray  # (T, N) float32
    lengths: np.ndarray  # (N,) valid steps of each trajectory

    @property
    def valid_rows(self) -> int:
        return int(self.lengths.sum())


def expert_actions(rng: np.random.Generator, n: int) -> np.ndarray:
    """(n,) actions: runs of 1 (forward), 2 or 3 (turns), the last 0."""
    out = np.empty(n, np.int64)
    t = 0
    while t < n - 1:
        action = 1 if rng.random() < 0.6 else int(rng.integers(2, 4))
        run = int(rng.integers(1, 9 if action == 1 else 5))
        out[t:min(t + run, n - 1)] = action
        t += run
    out[n - 1] = 0
    return out


def make_batch(seed: int, index: int, traffic: Dict, shapes: Dict,
               device: torch.device) -> Batch:
    """Batch ``index`` of run ``seed``: ``traffic`` gives the trajectory
    count, lengths, vocabulary and inflection weight; ``shapes`` the
    stored features' shape and the map side."""
    n = int(traffic["trajectories"])
    lo, hi = traffic["trajectory_steps"]
    rng = rng_for(seed, 10, index)
    lengths = np.round(np.linspace(lo, hi, n)).astype(np.int64)
    lengths = lengths[rng.permutation(n)]
    t = int(lengths.max())
    max_length = int(traffic["max_length"])
    coef = float(traffic["inflection_weight_coef"])

    corrected = np.zeros((t, n), np.int64)
    prev = np.zeros((t, n), np.int64)
    weights = np.zeros((t, n), np.float32)
    tokens = np.ones((t, n, max_length), np.int64)
    progress = np.ones((t, n), np.float32)
    valid = np.arange(t)[:, None] < lengths[None, :]
    for j in range(n):
        k = int(lengths[j])
        acts = expert_actions(rng, k)
        corrected[:k, j] = acts
        prev[1:k, j] = acts[:-1]
        change = np.concatenate([[True], acts[1:] != acts[:-1]])
        weights[:k, j] = np.where(change, coef, 1.0)
        m = int(rng.integers(traffic["instruction_tokens"][0],
                             traffic["instruction_tokens"][1] + 1))
        tokens[:k, j] = 0
        tokens[:k, j, :m] = rng.integers(1, int(traffic["vocab_size"]), m)
        progress[:k, j] = np.arange(1, k + 1) / k

    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(0, 2 ** 62)))
    rows = t * n
    feat = torch.randn((rows,) + tuple(shapes["depth_features"]),
                       generator=gen, device=device).abs_()
    side = int(shapes["map_side"])
    u = torch.rand((2, rows, side, side), generator=gen, device=device)
    occ = (u[0] < 0.35).to(torch.uint8)
    sem = torch.where((occ == 1) & (u[1] < 0.6),
                      (u[1] * 20).to(torch.uint8) + 1, 0).to(torch.uint8)
    pad = torch.from_numpy(~valid.reshape(-1)).to(device)
    feat[pad] = 1.0
    occ[pad] = 1
    sem[pad] = 1
    not_done = np.ones((t, n), np.uint8)
    not_done[0] = 0
    obs = {
        "depth_features": feat.cpu().numpy(),
        "occupancy_map": occ.cpu().numpy(),
        "semantic_map": sem.cpu().numpy(),
        "instruction": tokens.reshape(rows, max_length),
        "progress": progress.reshape(rows),
    }
    return Batch(obs, prev.reshape(-1, 1), not_done.reshape(-1, 1),
                 corrected, weights, lengths)
