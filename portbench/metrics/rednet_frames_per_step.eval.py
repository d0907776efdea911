"""Frames RedNet labelled per eval step (the program's ``rednet_frames``
counter over the traced window): every live lane's frame, so the lane
count where no label is kept between steps."""

from portbench import spans


def read(summary):
    return spans.per_step(summary, "rednet_frames")
