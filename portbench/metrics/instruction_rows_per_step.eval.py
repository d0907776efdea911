"""Instruction rows the bi-LSTM encoded per eval step (the program's
``instruction_rows_encoded`` counter over the traced window). Standard
error also gets ``instruction_rows_changed`` per step: the rows whose
tokens had changed, the least an encode of changed rows alone would
take."""

import sys

from portbench import spans


def read(summary):
    changed = spans.per_step(summary, "instruction_rows_changed")
    if changed is not None:
        print(f"instruction_rows_changed per step {changed!r}",
              file=sys.stderr)
    return spans.per_step(summary, "instruction_rows_encoded")
