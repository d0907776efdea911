"""The operation counts of the encoders, from shapes alone."""

import pytest

from portbench import flops


@pytest.mark.parametrize("fn,args,gflop", [
    (flops.depth_encoder, (256,), 0.699),
    (flops.map_encoder, (64, 13, 32, 4), 0.694),
    (flops.rgb_encoder, (224,), 8.17),
])
def test_encoder_counts(fn, args, gflop):
    assert fn(*args)["flops"] / 1e9 == pytest.approx(gflop, abs=0.005)


def test_step_counts_follow_the_widths():
    w = {"hidden_size": 512, "instruction_hidden": 128, "max_length": 200,
         "depth_side": 256, "depth_output": 128, "map_side": 64,
         "map_classes": 13, "map_channels": 32, "map_last_ch_mult": 4,
         "map_output": 256, "embedding_size": 50, "rgb_side": 224,
         "rgb_output": 256}
    lane = flops.eval_lane_step_flops("map", w)
    assert 1.39e9 < lane < 1.45e9
    assert flops.step_flops("map", dict(w, hidden_size=1024)) > \
        flops.step_flops("map", w)
    assert flops.least_seconds(67e12, 0) == pytest.approx(1.0)
