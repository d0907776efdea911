"""The traced window: a ``torch.profiler`` capture of the host and the
card over the traced steps, reduced to what the per-layer readers take.

Device events (kernels, copies, memsets) are matched to the runtime call
that launched them by the CUPTI correlation id; the call's host time
places them in the named ranges open at that moment: the program's own
``record_function`` ranges and the benchmark's spans around its calls.
A device event is credited to every range its launch fell in (ranges
nest), so a range's device time includes its children's."""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

STEP = "portbench.step"
LAUNCH_WORDS = ("Launch", "Memcpy", "Memset")


class Window:
    """Profile the host and the card while open."""

    def __init__(self, device: torch.device):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)

    def __enter__(self):
        self.prof.start()
        return self

    def __exit__(self, *exc):
        self.prof.stop()
        return False

    def events(self) -> Dict:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                return json.load(f)
        finally:
            os.remove(path)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def reduce(trace: Dict) -> Dict:
    """The traced window's numbers, in microseconds of the host clock:
    ``window_us`` (first step span's start to the last one's end),
    ``busy_us`` (the union of device events inside it), ``steps``,
    ``by_range_us`` (device time by range, inclusive), ``kernels_us``
    (device time by kernel name), ``host_issue_us`` (per step: its span's
    start to its last launch), ``idle_by_range_us`` (device idle time by
    the innermost range the host was in when the gap began)."""
    launches: Dict[int, float] = {}
    launch_ts: List[float] = []
    spans: List[Tuple[float, float, str]] = []
    device = []
    for ev in trace["traceEvents"]:
        cat, name = ev.get("cat"), ev.get("name", "")
        if cat in ("cuda_runtime", "cuda_driver"):
            if any(w in name for w in LAUNCH_WORDS):
                launches[ev.get("args", {}).get("correlation")] = ev["ts"]
                launch_ts.append(ev["ts"])
        elif cat == "user_annotation" and "dur" in ev:
            spans.append((ev["ts"], ev["ts"] + ev["dur"], name))
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            device.append(ev)
    steps = sorted((s, e) for s, e, n in spans if n == STEP)
    if not steps:
        return {}
    w0, w1 = steps[0][0], steps[-1][1]
    spans = sorted(sp for sp in spans if sp[1] > w0 and sp[0] < w1)
    launch_ts.sort()

    host_issue = []
    for s, e in steps:
        i = bisect.bisect_left(launch_ts, e) - 1
        if i >= 0 and launch_ts[i] >= s:
            host_issue.append(launch_ts[i] - s)

    by_range = defaultdict(float)
    kernels = defaultdict(float)
    busy = []
    starts = [sp[0] for sp in spans]
    longest = max((e - s for s, e, _ in spans), default=0.0)

    def enclosing(ts):
        """Names of the spans open at host time ``ts``, outermost
        first."""
        found = []
        j = bisect.bisect_right(starts, ts) - 1
        while j >= 0 and spans[j][0] >= ts - longest:
            if spans[j][1] > ts:
                found.append(spans[j][2])
            j -= 1
        return found[::-1]

    for ev in device:
        ts, dur = ev["ts"], ev.get("dur", 0.0)
        a, b = max(ts, w0), min(ts + dur, w1)
        if b <= a:
            continue
        busy.append((a, b))
        kernels[ev["name"]] += b - a
        lt = launches.get(ev.get("args", {}).get("correlation"))
        if lt is None:
            continue
        for name in set(enclosing(lt)):
            by_range[name] += b - a
    merged = _union(busy)
    busy_us = sum(e - s for s, e in merged)

    gaps = []
    prev = w0
    for s, e in merged + [(w1, w1)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    idle = defaultdict(float)
    for s, e in gaps:
        inner = enclosing(s)
        idle[inner[-1] if inner else "outside the ranges"] += e - s
    return {
        "window_us": w1 - w0,
        "busy_us": busy_us,
        "steps": len(steps),
        "by_range_us": dict(by_range),
        "kernels_us": dict(kernels),
        "host_issue_us": host_issue,
        "idle_by_range_us": dict(idle),
    }


def breakdown(reduced: Dict) -> Dict:
    """The result line's ``breakdown``: the ten device operations that
    took most time and the ten host ranges the card waited in longest, in
    seconds."""
    top = sorted(reduced.get("kernels_us", {}).items(),
                 key=lambda kv: -kv[1])[:10]
    idle = sorted(reduced.get("idle_by_range_us", {}).items(),
                  key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v * 1e-6] for k, v in top],
            "idle_gaps": [[k, v * 1e-6] for k, v in idle]}


# what the per-layer readers share (portbench/metrics/<metric>.py); each
# returns None where the traced run holds nothing to read


def range_ms(summary: Dict, name: str):
    """Device ms per traced step of the kernels launched in range
    ``name``."""
    us = summary.get("by_range_us", {}).get(name)
    return us / summary["steps"] / 1e3 if us else None


def idle_pct(summary: Dict):
    """Share of the traced window with no device event, in %."""
    window = summary.get("window_us")
    return 100.0 * (1.0 - summary["busy_us"] / window) if window else None


def host_issue_ms(summary: Dict):
    """Mean host ms from a step's span to its last CUDA launch."""
    issue = summary.get("host_issue_us")
    return sum(issue) / len(issue) / 1e3 if issue else None


def peak_share_pct(summary: Dict):
    """The driver's needed FLOPs over the traced window, as a share of
    the card's peak, in %."""
    if not summary.get("flops") or not summary.get("window_us"):
        return None
    rate = summary["flops"] / (summary["window_us"] * 1e-6)
    return 100.0 * rate / summary["peak_flops"]
