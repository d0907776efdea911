"""Host ms per eval step inside the program's ``device_sync`` spans: each
blocking device-to-host read (the actions, and the bi-LSTM's lengths at
an instruction encode), the host's wait for the card included."""

from portbench import spans


def read(summary):
    return spans.host_ms(summary, "device_sync")
