"""Host ms per eval step inside the program's ``upload`` spans: every
host-to-device copy of ``_policy_step`` (the wire obs, the instruction
tokens on a change, the masks and previous actions), from the copies'
call to their return."""

from portbench import spans


def read(summary):
    return spans.host_ms(summary, "upload")
