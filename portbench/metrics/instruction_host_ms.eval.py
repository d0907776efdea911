"""Host ms per eval step inside the program's ``instruction_cache`` span:
the instruction tokens compared with the cached ones and, on a change,
their upload and the bi-LSTM's issue (``instruction_encoder``), with its
blocking read of the lengths."""

from portbench import spans


def read(summary):
    return spans.host_ms(summary, "instruction_cache")
