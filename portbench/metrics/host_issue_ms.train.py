"""Host time to issue one IL update: from the benchmark's span around
``_update_agent`` to the update's last CUDA launch, mean over the traced
updates, in ms."""

from portbench import trace


def read(summary):
    return trace.host_issue_ms(summary)
