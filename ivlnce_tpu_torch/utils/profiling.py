"""Tracing and host-phase timing: the PyTorch counterpart of
``ivlnce_tpu/utils/profiling.py``, with one span API.

- ``span(name)``: a named range of host code. While a ``torch.profiler``
  capture records, it is a ``torch.profiler.record_function`` range (on
  the same clock as the card's kernels and copies in the trace) and adds
  its host time to ``traced()``'s table; with ``IVLNCE_PHASE_TIMES`` set
  in the environment at import, the outermost spans add their wall time
  to the phase report. Otherwise it does nothing but count its depth;
- ``count(name, n)``: adds ``n`` to ``traced()``'s counters while a
  capture records;
- ``traced()``: the host time of each span name and the counters over
  the capture that records now, or over the last one: the tables
  restart at the first span or count under a capture after one outside
  it;
- ``maybe_start_trace(config, device)`` / ``maybe_stop_trace()``: an
  on-demand ``torch.profiler`` capture, controlled by the config's
  ``TPU.profile_dir`` (empty = off) or the ``IVLNCE_PROFILE_DIR``
  environment variable; the stop writes a Chrome trace (JSON) there;
- ``phase_report()``, ``reset_phases()``: the per-phase wall times of the
  outermost spans (the eval, collection and training loops' phases).
"""

from __future__ import annotations

import os
import time as _time
from typing import Dict, Optional

import torch

_profiler = None
_profiler_dir: Optional[str] = None
_recording = torch._C._autograd._profiler_enabled


def profile_dir_from(config=None) -> Optional[str]:
    env = os.environ.get("IVLNCE_PROFILE_DIR")
    if env:
        return env
    if config is not None and "TPU" in config:
        d = getattr(config.TPU, "profile_dir", "")
        return d or None
    return None


def maybe_start_trace(config=None, device=None) -> bool:
    """Start a trace of the host and, for a CUDA ``device``, the card;
    nothing when no directory is set or a trace is already open."""
    global _profiler, _profiler_dir
    d = profile_dir_from(config)
    if not d or _profiler is not None:
        return False
    os.makedirs(d, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    _profiler = torch.profiler.profile(activities=activities)
    _profiler.start()
    _profiler_dir = d
    return True


def maybe_stop_trace() -> Optional[str]:
    """Close the open trace and write it; returns the file's path."""
    global _profiler, _profiler_dir
    if _profiler is None:
        return None
    prof, d = _profiler, _profiler_dir
    _profiler = _profiler_dir = None
    prof.stop()
    path = os.path.join(
        d, f"trace_{os.getpid()}_{_time.time_ns()}.pt.trace.json"
    )
    prof.export_chrome_trace(path)
    return path


# -- spans ---------------------------------------------------------------
_phase_times: Dict[str, float] = {}  # s per outermost span name
_phase_counts: Dict[str, int] = {}
_traced_us: Dict[str, float] = {}  # host µs per span name under a capture
_traced_counts: Dict[str, int] = {}
_PHASES_ON = bool(os.environ.get("IVLNCE_PHASE_TIMES"))
_depth = 0  # spans open now
_capturing = False  # the last span or count ran under a capture


def _under_capture() -> bool:
    """Whether a capture records now; the traced tables restart when one
    has begun since the last span or count."""
    global _capturing
    now = _recording()
    if now and not _capturing:
        _traced_us.clear()
        _traced_counts.clear()
    _capturing = now
    return now


class span:
    """A named range of host code (see the module's docstring). A span
    opened under a capture is recorded whole, even if the capture stops
    inside it; a name should not nest in itself."""

    __slots__ = ("name", "_range", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _depth
        self._range = self._t0 = None
        if _under_capture():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
            self._t0 = _time.perf_counter()
        elif _PHASES_ON and _depth == 0:
            self._t0 = _time.perf_counter()
        _depth += 1
        return self

    def __exit__(self, *exc):
        global _depth
        _depth -= 1
        if self._t0 is None:
            return False
        dt = _time.perf_counter() - self._t0
        if self._range is not None:
            _traced_us[self.name] = _traced_us.get(self.name, 0.0) + dt * 1e6
            self._range.__exit__(*exc)
        if _PHASES_ON and _depth == 0:
            _phase_times[self.name] = _phase_times.get(self.name, 0.0) + dt
            _phase_counts[self.name] = _phase_counts.get(self.name, 0) + 1
        return False


def count(name: str, n: int) -> None:
    """Add ``n`` to counter ``name`` while a capture records."""
    if _under_capture():
        _traced_counts[name] = _traced_counts.get(name, 0) + int(n)


def traced() -> Dict[str, Dict]:
    """What the spans and counters recorded under the current or last
    capture: ``host_us`` (host µs per span name, children included) and
    ``counts``."""
    return {"host_us": dict(_traced_us), "counts": dict(_traced_counts)}


def phase_report() -> str:
    if not _phase_times:
        return ""
    total = sum(_phase_times.values())
    parts = [
        f"{k}={v:.1f}s/{_phase_counts[k]} ({100 * v / total:.0f}%)"
        for k, v in sorted(_phase_times.items(), key=lambda kv: -kv[1])
    ]
    return " ".join(parts)


def reset_phases() -> None:
    _phase_times.clear()
    _phase_counts.clear()
