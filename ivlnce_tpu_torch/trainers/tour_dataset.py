"""Tour-ordered training data: the PyTorch port's copy of
``ivlnce_tpu/trainers/tour_dataset.py`` (reference
ivlnce_baselines/trainers/tour_dataset.py): binpacked tour lanes and the
tour-aware collate.

The TourSampler solves multiway number partitioning (tours -> batch_size
lanes) greedily and emits TRANSPOSED batches so consecutive batches
continue the same tours: the RNN state carries across batches (truncated
BPTT at batch granularity, iterative_dagger_trainer.py:218-253).

The sampler shuffles each tour's episodes with ``rng``, a
``np.random.RandomState``; ``None`` draws from numpy's global state, as
the JAX package does, so ``RandomState(s)`` and ``np.random.seed(s)``
give the same batches.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Set, Tuple

import numpy as np

from ivlnce_tpu_torch.trainers.dagger_trainer import _pad_to
from ivlnce_tpu_torch.trainers.trajectory_store import TrajectoryStore
from ivlnce_tpu_torch.utils import logging_util

logger = logging_util.logger


def to_constant_bin_number(weights: Dict, n_bins: int) -> List[Dict]:
    """Greedy multiway number partitioning (the binpacking package's
    to_constant_bin_number): sort items by weight descending, place each
    in the currently lightest bin."""
    bins: List[Dict] = [dict() for _ in range(n_bins)]
    sums = [0.0] * n_bins
    for key, w in sorted(weights.items(), key=lambda kv: -kv[1]):
        i = int(np.argmin(sums))
        bins[i][key] = w
        sums[i] += w
    return bins


def collate_fn(batch: List[Tuple]) -> Tuple:
    """Tour collate (tour_dataset.py:20-104): adds tour_not_done_masks
    (0 at tour starts); episode masks zero at t=0 like the episodic
    collate."""
    obs_list, prev_list, corr_list, weight_list, tour_mask_list = zip(*batch)
    max_t = max(p.shape[0] for p in prev_list)

    obs_out: Dict[str, np.ndarray] = {}
    for sensor in obs_list[0]:
        stacked = np.stack(
            [_pad_to(np.asarray(o[sensor]), max_t, 1.0) for o in obs_list],
            axis=1,
        )
        obs_out[sensor] = stacked.reshape((-1,) + stacked.shape[2:])

    prev_actions = np.stack(
        [_pad_to(np.asarray(p), max_t) for p in prev_list], 1
    )
    corrected = np.stack(
        [_pad_to(np.asarray(c), max_t) for c in corr_list], 1
    )
    weights = np.stack(
        [_pad_to(np.asarray(w), max_t) for w in weight_list], 1
    )
    tour_masks = np.stack(
        [_pad_to(np.asarray(m), max_t, 1) for m in tour_mask_list], 1
    ).astype(np.uint8)
    episode_masks = np.ones_like(corrected, np.uint8)
    episode_masks[0] = 0

    return (
        obs_out,
        prev_actions.reshape(-1, 1),
        episode_masks.reshape(-1, 1),
        tour_masks.reshape(-1, 1),
        corrected,
        weights,
    )


class TourSampler:
    """Binpack tours into batch lanes, emit transposed index batches
    (tour_dataset.py:107-205)."""

    def __init__(
        self,
        tours_to_idx: Dict[str, List[int]],
        batch_size: int = 1,
        shuffle: bool = True,
        drop_last: bool = True,
        rng: Optional[np.random.RandomState] = None,
    ):
        num_tours = len(tours_to_idx)
        assert batch_size <= num_tours
        self.batched_idxs, self.tour_done_idxs = self._binpack_and_batch(
            tours_to_idx, batch_size, shuffle, drop_last,
            np.random if rng is None else rng,
        )
        pre = sum(len(v) for v in tours_to_idx.values())
        post = sum(len(b) for b in self.batched_idxs)
        logger.info(
            f"TourSampler: tours={num_tours} episodes={pre} "
            f"batched={post} dropped={pre - post} "
            f"batches={len(self.batched_idxs)}"
        )

    @staticmethod
    def _binpack_and_batch(
        tours_to_idx, batch_size, shuffle, drop_last, rng
    ) -> Tuple[List[List[int]], Set[int]]:
        bins = to_constant_bin_number(
            {k: len(v) for k, v in tours_to_idx.items()}, batch_size
        )
        assert len(bins) == batch_size
        batches: List[List[int]] = [[] for _ in range(batch_size)]
        tour_done_idxs: Set[int] = set()
        for i, packed_bin in enumerate(bins):
            for k in packed_bin.keys():
                tour_ids = list(tours_to_idx[k])
                if shuffle:
                    rng.shuffle(tour_ids)
                batches[i].extend(tour_ids)
                tour_done_idxs.add(tour_ids[0])

        transposed: List[List[int]] = [
            [] for _ in range(max(len(seq) for seq in batches))
        ]
        for lane in batches:
            for i, elem in enumerate(lane):
                transposed[i].append(elem)

        if drop_last:
            # keep the full-width prefix: lanes run out at different tour
            # lengths; a short batch would break the fixed (T, N) shapes
            n_full = len(transposed)
            for i, b in enumerate(transposed):
                if len(b) < batch_size:
                    n_full = i
                    break
            transposed = transposed[:n_full]
        return transposed, tour_done_idxs

    def get_num_batches(self) -> int:
        return len(self.batched_idxs)

    def get_tour_done_idxs(self) -> Set[int]:
        return self.tour_done_idxs

    def __iter__(self) -> Iterator[List[int]]:
        return iter(self.batched_idxs)


class TourTrajectoryDataset:
    """Map-style trajectory reads with tour_done flags
    (tour_dataset.py:208-289)."""

    def __init__(
        self,
        store_path: str,
        use_iw: bool,
        inflection_weight_coef: float = 1.0,
    ):
        self.store = TrajectoryStore(store_path)
        self.tour_done_idxs: Set[int] = None
        if use_iw:
            self.inflec_weights = np.array([1.0, inflection_weight_coef])
        else:
            self.inflec_weights = np.array([1.0, 1.0])

    def set_tour_done_idxs(self, tour_done_idxs: Set[int]) -> None:
        self.tour_done_idxs = set(tour_done_idxs)

    def __getitem__(self, idx: int):
        assert self.tour_done_idxs is not None
        obs, prev_actions, oracle_actions = self.store.get(idx)
        obs = {k: np.asarray(v) for k, v in obs.items()}
        prev_actions = np.asarray(prev_actions)
        oracle_actions = np.asarray(oracle_actions)
        inflections = np.concatenate(
            [[1], (oracle_actions[1:] != oracle_actions[:-1]).astype(np.int64)]
        )
        tour_done_mask = np.ones_like(prev_actions)
        tour_done_mask[0] = int(idx not in self.tour_done_idxs)
        return (
            obs,
            prev_actions,
            oracle_actions,
            self.inflec_weights[inflections],
            tour_done_mask,
        )

    def batches(self, sampler: TourSampler) -> Iterator[Tuple]:
        for idx_batch in sampler:
            yield collate_fn([self[i] for i in idx_batch])

    def close(self):
        self.store.close()
