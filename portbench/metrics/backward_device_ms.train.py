"""Device time per IL update of the kernels launched in the ``backward``
range (the backward pass), in ms."""

from portbench import trace


def read(summary):
    return trace.range_ms(summary, "backward")
