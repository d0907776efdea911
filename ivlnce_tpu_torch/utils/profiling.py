"""Tracing and host-phase timing: the PyTorch counterpart of
``ivlnce_tpu/utils/profiling.py``.

- ``range_context(name)``: ``torch.profiler.record_function``, a named
  range on the host timeline and, under a CUDA trace, on the device's;
- ``maybe_start_trace(config, device)`` / ``maybe_stop_trace()``: an
  on-demand ``torch.profiler`` capture, controlled by the config's
  ``TPU.profile_dir`` (empty = off) or the ``IVLNCE_PROFILE_DIR``
  environment variable; the stop writes a Chrome trace (JSON) there;
- ``wall_range(name)``, ``phase_report()``, ``reset_phases()``: coarse
  per-phase wall times of the eval loops, on when ``IVLNCE_PHASE_TIMES``
  is set in the environment at import.
"""

from __future__ import annotations

import contextlib
import os
import time as _time
from typing import Optional

import torch

_profiler = None
_profiler_dir: Optional[str] = None


def range_context(name: str):
    return torch.profiler.record_function(name)


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


# -- wall-clock phase accounting ---------------------------------------------
# The eval loops accumulate coarse per-phase wall times here. Enabled by
# the IVLNCE_PHASE_TIMES env var; when disabled it is a no-op context.
_phase_times: dict = {}
_phase_counts: dict = {}
_PHASES_ON = bool(os.environ.get("IVLNCE_PHASE_TIMES"))


@contextlib.contextmanager
def wall_range(name: str):
    if not _PHASES_ON:
        yield
        return
    t0 = _time.perf_counter()
    try:
        yield
    finally:
        dt = _time.perf_counter() - t0
        _phase_times[name] = _phase_times.get(name, 0.0) + dt
        _phase_counts[name] = _phase_counts.get(name, 0) + 1


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
