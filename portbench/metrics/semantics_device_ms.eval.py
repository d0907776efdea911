"""Device time per eval step of the kernels launched in the mapper's
``semantics`` range (RedNet's input preparation, network and argmax, for
every lane's frame), in ms."""

from portbench import trace


def read(summary):
    return trace.range_ms(summary, "semantics")
