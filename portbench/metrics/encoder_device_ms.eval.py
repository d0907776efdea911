"""Device time per eval step of the kernels launched in the policy's
``encoders`` range (depth, map or RGB encoder, projections), in ms."""

from portbench import trace


def read(summary):
    return trace.range_ms(summary, "encoders")
