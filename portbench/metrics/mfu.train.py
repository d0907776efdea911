"""The whole step's share of the card's float32 peak: the needed FLOPs of
the traced updates' valid rows: three times the forward of the trained
parts, and the map statistics' forward (``portbench/flops.py``), over
the traced window, in %."""

from portbench import trace


def read(summary):
    return trace.peak_share_pct(summary)
