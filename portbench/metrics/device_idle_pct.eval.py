"""Share of the traced eval window in which no kernel, copy or memset ran
on the card, in %."""

from portbench import trace


def read(summary):
    return trace.idle_pct(summary)
