"""What the program's own spans and counters recorded over the traced
window, for the per-layer readers of ``portbench/metrics/``.

Under a ``torch.profiler`` capture each span of the port
(``ivlnce_tpu_torch/utils/profiling.py::span``) adds its host time to a
table by name, children included, and each counter its count; the
program's ``profiling.traced()`` returns both for the capture that ran
last, which in a ``--trace 1`` run is the benchmark's window. Per step
means per span of the benchmark's ``portbench.step`` (``summary["steps"]``).
Each helper returns None where the traced run holds nothing to read: no
steps, a program without ``traced()``, or no such span or counter."""

from __future__ import annotations

from typing import Dict, Optional


def _traced() -> Dict:
    from ivlnce_tpu_torch.utils import profiling

    traced = getattr(profiling, "traced", None)
    return traced() if traced is not None else {}


def host_ms(summary: Dict, name: str) -> Optional[float]:
    """Host ms per traced step inside the program's spans ``name``."""
    if not summary.get("steps"):
        return None
    us = _traced().get("host_us", {}).get(name)
    return us / summary["steps"] / 1e3 if us else None


def per_step(summary: Dict, counter: str) -> Optional[float]:
    """The program's counter ``counter`` over the traced window, per
    step; 0 is a reading where the counter exists."""
    if not summary.get("steps"):
        return None
    n = _traced().get("counts", {}).get(counter)
    return n / summary["steps"] if n is not None else None
