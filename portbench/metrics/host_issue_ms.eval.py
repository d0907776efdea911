"""Host time to issue one eval step: from the benchmark's span around
``_policy_step`` to the step's last CUDA launch, mean over the traced
steps, in ms."""

from portbench import trace


def read(summary):
    return trace.host_issue_ms(summary)
