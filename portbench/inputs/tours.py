"""The seeded episode and tour schedule of a closed loop of eval lanes.

Each lane walks tours of ``episodes_per_tour`` episodes whose lengths are
drawn uniformly from ``episode_steps``; every episode has an instruction
of ``instruction_tokens`` tokens, drawn uniformly from the vocabulary
and padded to ``max_length``. The first step of the run starts a tour in
every lane; to stagger the lanes, the first tour has a seeded number of
episodes left and its first episode a seeded number of steps left.

The masks follow the iterative eval loop with the oracle phases off (the
agent teleports between episodes): at the first step of an episode the
agent and sim masks are 0 and the previous action is 0; at the first step
of a tour the tour mask is 0 too, which clears the lane's world map; the
action mask is 1 throughout."""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np

from portbench.inputs.scenes import rng_for

# episodes drawn per lane, far more than a run of a few minutes takes
EPISODES_PER_LANE = 400


class StepMasks(NamedTuple):
    episode_start: np.ndarray  # (L,) bool
    tour_start: np.ndarray  # (L,) bool
    episode: np.ndarray  # (L,) int64: the lane's episode index


class TourSchedule:
    def __init__(self, seed: int, lanes: int, traffic: Dict):
        lo, hi = traffic["episode_steps"]
        self.seed = seed
        self.lanes = lanes
        self.per_tour = int(traffic["episodes_per_tour"])
        self.token_range = traffic["instruction_tokens"]
        self.vocab = int(traffic["vocab_size"])
        self.max_length = int(traffic["max_length"])
        rng = rng_for(seed, 3)
        lengths = rng.integers(lo, hi + 1, (lanes, EPISODES_PER_LANE))
        # the first episode is entered at a seeded step of its length
        lengths[:, 0] = rng.integers(1, lengths[:, 0] + 1)
        self.starts = np.concatenate(
            [np.zeros((lanes, 1), np.int64), np.cumsum(lengths, 1)], 1)
        first_tour = rng.integers(1, self.per_tour + 1, lanes)
        # tour index of each episode: the first tour has first_tour
        # episodes, the rest per_tour
        e = np.arange(EPISODES_PER_LANE)[None, :]
        self.tour_of = np.where(
            e < first_tour[:, None], 0,
            1 + (e - first_tour[:, None]) // self.per_tour)
        self._episode = np.full(lanes, -1, np.int64)
        self.tokens = np.zeros((lanes, self.max_length), np.int64)

    def masks(self, step: int) -> StepMasks:
        """The schedule at global ``step`` (0 is the run's first)."""
        episode = (self.starts <= step).sum(1) - 1
        if int(episode.max()) >= EPISODES_PER_LANE:
            raise RuntimeError("the tour schedule ran out of episodes")
        lanes = np.arange(self.lanes)
        start = self.starts[lanes, episode] == step
        tour = start & ((episode == 0)
                        | (self.tour_of[lanes, episode]
                           != self.tour_of[lanes, np.maximum(episode - 1, 0)]))
        return StepMasks(start, tour, episode)

    def instruction(self, lane: int, episode: int) -> np.ndarray:
        """The (max_length,) padded tokens of a lane's episode."""
        rng = rng_for(self.seed, 4, lane, episode)
        lo, hi = self.token_range
        n = int(rng.integers(lo, hi + 1))
        out = np.zeros(self.max_length, np.int64)
        out[:n] = rng.integers(1, self.vocab, n)
        return out

    def update_tokens(self, m: StepMasks) -> np.ndarray:
        """The (L, max_length) tokens of the lanes' current episodes,
        updated in place where an episode started."""
        for i in np.nonzero(m.episode != self._episode)[0]:
            self.tokens[i] = self.instruction(int(i), int(m.episode[i]))
        self._episode = m.episode.copy()
        return self.tokens


def frame_index(step: int, frames: int) -> int:
    """The pool frame of global ``step``: the walks run back and forth
    through their ``frames`` poses."""
    if frames == 1:
        return 0
    p = step % (2 * frames - 2)
    return p if p < frames else 2 * frames - 2 - p
