"""Share of the traced IL update window in which no kernel, copy or memset
ran on the card, in %."""

from portbench import trace


def read(summary):
    return trace.idle_pct(summary)
