"""The inputs come from the seed alone."""

import numpy as np
import torch

from portbench.inputs import scenes as SC
from portbench.inputs.tours import TourSchedule, frame_index
from portbench.inputs.trajectories import make_batch

TRAFFIC = {"episode_steps": [3, 6], "episodes_per_tour": 2,
           "instruction_tokens": [2, 5], "vocab_size": 50, "max_length": 8,
           "trajectories": 3, "trajectory_steps": [3, 6],
           "inflection_weight_coef": 3.2}


def _frames(seed):
    scn = SC.make_scenes(seed, 8)
    walks = SC.make_walks(seed, scn, 3)
    return SC.render_pool(walks, scn, {"depth": (16, 16), "semantic12": True,
                                       "rgb": (8, 8)}, torch.device("cpu"))


def test_the_same_seed_gives_the_same_frames_and_another_does_not():
    a, b, c = _frames(2 ** 31 + 11), _frames(2 ** 31 + 11), _frames(5)
    for k in a:
        assert np.array_equal(a[k], b[k])
    assert not np.array_equal(a["depth"], c["depth"])
    assert a["depth"].dtype == np.uint16 and a["depth"].max() > 0
    assert a["semantic12"].max() > 0


def test_the_schedule_starts_tours_and_episodes():
    s = TourSchedule(-3, 4, TRAFFIC)
    m0 = s.masks(0)
    assert m0.episode_start.all() and m0.tour_start.all()
    starts = sum(s.masks(i).episode_start.sum() for i in range(1, 40))
    tours = sum(s.masks(i).tour_start.sum() for i in range(1, 40))
    assert 0 < tours < starts
    tokens = s.update_tokens(m0)
    assert (tokens[:, 0] > 0).all() and tokens.shape == (4, 8)
    assert [frame_index(i, 3) for i in range(6)] == [0, 1, 2, 1, 0, 1]


def test_batches_hold_the_same_lengths_for_every_seed():
    shapes = {"depth_features": (4, 2, 2), "map_side": 8}
    a = make_batch(1, 0, TRAFFIC, shapes, torch.device("cpu"))
    b = make_batch(9, 0, TRAFFIC, shapes, torch.device("cpu"))
    assert sorted(a.lengths) == sorted(b.lengths)
    assert a.valid_rows == b.valid_rows == int((a.weights > 0).sum())
    assert a.observations["depth_features"].shape[0] == a.corrected.size
    assert (a.weights[0] == 3.2).all()
