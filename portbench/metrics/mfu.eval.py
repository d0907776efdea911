"""The whole step's share of the card's float32 peak: the needed FLOPs of
the traced eval steps: every lane's encoders and step, and one
instruction encode per episode started (``portbench/flops.py``), over
the traced window, in %."""

from portbench import trace


def read(summary):
    return trace.peak_share_pct(summary)
