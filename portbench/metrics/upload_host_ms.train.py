"""Host ms per IL update inside the program's ``upload`` spans: the
batch's host-to-device copies in ``_update_agent``."""

from portbench import spans


def read(summary):
    return spans.host_ms(summary, "upload")
