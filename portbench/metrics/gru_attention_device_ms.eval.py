"""Device time per eval step of the kernels launched in the policy's
``gru_attention`` range (the two GRUs and three attentions), in ms."""

from portbench import trace


def read(summary):
    return trace.range_ms(summary, "gru_attention")
