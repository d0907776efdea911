"""Share of the eval step's host-to-device bytes sent through the
program's staging arena over the traced window: 100 x the
``upload_bytes_staged`` counter over it plus ``upload_bytes_blocking``
(the bytes of the copies that still wait for the stream). Standard error
also gets the blocking bytes per step. None where the program counts
neither."""

import sys

from portbench import spans


def read(summary):
    staged = spans.per_step(summary, "upload_bytes_staged")
    blocking = spans.per_step(summary, "upload_bytes_blocking")
    if staged is None and blocking is None:
        return None
    staged, blocking = staged or 0.0, blocking or 0.0
    print(f"upload_bytes_blocking per step {blocking!r}", file=sys.stderr)
    if staged + blocking == 0:
        return None
    return 100.0 * staged / (staged + blocking)
