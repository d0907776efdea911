"""One cell's traced run, split by the program's spans:

    python3 -m portbench.split --workload <cell> --seed <n> --seconds <s> \
        --trace 1

runs ``portbench.run`` as it is, keeps the raw trace of its window and
prints, as the last line of standard error, ``split`` and a JSON object:
per step (per span of ``trace.STEP``), the host ms inside each span name
(the union of its intervals on the steps' thread, children included),
the card's idle ms while each was open (every idle instant credited to
each span open then), the idle ms in all, the host ms of ``policy_step``
or ``train_step`` outside every span inside it, the spans of each name,
the kernel launches (``LaunchKernel`` and ``GraphLaunch`` calls) and the
device ms of host-to-device copies. It reads what ``trace.reduce`` does
not keep; the result line is the run's own."""

from __future__ import annotations

import json
import sys
from collections import defaultdict
from typing import Dict, List

from portbench import trace

LAUNCH = ("LaunchKernel", "GraphLaunch")
TOPS = ("policy_step", "collect_step", "train_step")


def _union(intervals) -> List[List[float]]:
    return [list(iv) for iv in trace._union(intervals)]


def _length(intervals) -> float:
    return sum(e - s for s, e in intervals)


def _overlap(a, b) -> float:
    """The length two sorted unions share."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def analyse(events: Dict) -> Dict:
    spans, device, launches = [], [], []
    for ev in events["traceEvents"]:
        cat, name = ev.get("cat"), ev.get("name", "")
        if cat == "user_annotation" and "dur" in ev:
            spans.append((ev["ts"], ev["ts"] + ev["dur"], name, ev.get("tid")))
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            device.append((ev["ts"], ev["ts"] + ev.get("dur", 0.0), name))
        elif cat in ("cuda_runtime", "cuda_driver") and any(
                w in name for w in LAUNCH):
            launches.append(ev["ts"])
    steps = sorted((s, e, t) for s, e, n, t in spans if n == trace.STEP)
    if not steps:
        return {}
    w0, w1, tid = steps[0][0], steps[-1][1], steps[0][2]
    n = len(steps)
    parts, counts = defaultdict(list), defaultdict(int)
    for s, e, name, t in spans:
        if t == tid and e > w0 and s < w1:
            parts[name].append((max(s, w0), min(e, w1)))
            counts[name] += 1
    by_name = {k: _union(v) for k, v in parts.items()}
    busy = _union([(max(s, w0), min(e, w1)) for s, e, _ in device
                   if min(e, w1) > max(s, w0)])
    gaps, prev = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            gaps.append([prev, s])
        prev = max(prev, e)
    top = next((k for k in TOPS if k in by_name), None)
    unexplained = None
    if top is not None:
        inside = _union([iv for k, v in by_name.items()
                         if k not in (top, trace.STEP) for iv in v
                         if any(a <= iv[0] and iv[1] <= b
                                for a, b in by_name[top])])
        unexplained = (_length(by_name[top]) - _length(inside)) / n / 1e3
    upload_us = sum(min(e, w1) - max(s, w0) for s, e, name in device
                    if "HtoD" in name and min(e, w1) > max(s, w0))

    def per_step_ms(table):
        return dict(sorted(((k, v / n / 1e3) for k, v in table.items()),
                           key=lambda kv: -kv[1]))

    return {
        "steps": n,
        "step_ms": (w1 - w0) / n / 1e3,
        "host_ms": per_step_ms({k: _length(v) for k, v in by_name.items()}),
        "idle_ms": per_step_ms({k: _overlap(gaps, v)
                                for k, v in by_name.items()}),
        "idle_total_ms": _length(gaps) / n / 1e3,
        "unexplained_ms": unexplained,
        "spans_per_step": {k: c / n for k, c in counts.items()},
        "launches_per_step": sum(w0 <= t < w1 for t in launches) / n,
        "htod_device_ms": upload_us / n / 1e3,
    }


def main(argv=None) -> int:
    from portbench import run

    kept = {}
    reduce = trace.reduce

    def keep(events):
        kept["events"] = events
        return reduce(events)

    trace.reduce = keep
    try:
        rc = run.main(argv)
    finally:
        trace.reduce = reduce
    if "events" in kept:
        print("split " + json.dumps(analyse(kept["events"])),
              file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
