"""Device time per eval step of the kernels launched in the ``mapper``
range (the mapper obs transform's device step: K1, K2 and their inputs),
in ms."""

from portbench import trace


def read(summary):
    return trace.range_ms(summary, "mapper")
