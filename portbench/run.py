"""The benchmark's one command:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

It finds the cell in ``portbench/workloads/<cell>.json``, its
configuration in ``portbench/configs/<config>.json`` and its driver in
``portbench/drivers/<driver>.py``; the metrics it reports are those
``BENCHMARK.json`` gives the cell, end-to-end ones with ``--trace 0`` and
per-layer ones, each read by ``portbench/metrics/<metric>.py``, with
``--trace 1``. The last line of standard output is the result's JSON
object; the numbers compared with the plain reference, each beside its
limit, end standard error.

``--control tf32`` (or ``bf16``, the port's ``TPU.compute_dtype``) runs
the program in a lower precision than the configuration states: the
check's control, which must come out not correct. The benchmark's own
runs never pass it."""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "ivlnce_tpu")


def process_started() -> float:
    """``perf_counter`` at this process's start (the kernel's record of
    it), so set-up counts the interpreter's start too."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - ticks / os.sysconf("SC_CLK_TCK")
        if 0 <= age < 60:
            return time.perf_counter() - age
    except (OSError, ValueError, IndexError):
        pass
    return _T0


def foreign_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``ivlnce_tpu_torch`` is not ``ivlnce_tpu``)."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def _load_file(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str):
    from portbench.harness import HERE

    return _load_file(str(HERE / "drivers" / f"{name}.py"),
                      f"portbench_driver_{name}")


def reader(metric: str):
    from portbench.harness import HERE

    return _load_file(str(HERE / "metrics" / f"{metric}.py"),
                      "portbench_metric_" + metric.replace(".", "_"))


def metrics_of(bench: dict, cell: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries of ``BENCHMARK.json``
    that ``cell`` reports: those whose ``workloads`` list it, and the
    end-to-end ones without such a list (``setup_s``). A per-layer entry
    lists its cells."""
    return [m for m in bench[kind] if cell in m.get(
        "workloads", [cell] if kind == "end_to_end" else [])]


def power_limit_w():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20).stdout.strip()
        return float(out.splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def result_line(outcome, metrics: dict, device: dict, traced: bool) -> dict:
    """The result's JSON object: the contract's keys, the traced run's
    busy and window seconds and breakdown, and last the numbers compared
    with their limits."""
    from portbench import trace

    result = {"correct": outcome.correct, "attempted": outcome.attempted,
              "failed": outcome.failed, "metrics": metrics, "device": device}
    if traced and outcome.summary.get("window_us"):
        device["busy_s"] = outcome.summary["busy_us"] * 1e-6
        device["window_s"] = outcome.summary["window_us"] * 1e-6
        result["breakdown"] = trace.breakdown(outcome.summary)
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in outcome.checks}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("", "tf32", "bf16"), default="")
    args = p.parse_args(argv)
    started = process_started()

    from portbench import harness

    harness.env_for_run()
    import torch

    imported = time.perf_counter()
    cell = harness.load("workloads", args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: cell {args.workload} needs {cell['chips']} "
              "CUDA device(s); none or too few are visible", file=sys.stderr)
        return 2
    config = harness.load("configs", cell["config"])
    bench = harness.benchmark()
    device = torch.device("cuda", 0)
    ctx = harness.RunContext(cell=cell, config=config, seed=args.seed,
                             seconds=args.seconds, trace=bool(args.trace),
                             device=device, started=started,
                             control=args.control,
                             marks=[("imports", imported)])
    outcome = driver(cell["driver"]).run(ctx)
    return report(bench, args.workload, cell, outcome, bool(args.trace),
                  torch.cuda.get_device_name(device), ctx.setup_notes())


def report(bench: dict, workload: str, cell: dict, outcome, traced: bool,
           kind: str, notes=()) -> int:
    """Read the cell's metrics, print the compared numbers and then the
    result's line; no line where the process holds JAX or the JAX package
    by then, the readers' imports included."""
    metrics = {}
    if traced:
        for m in metrics_of(bench, workload, "per_layer"):
            value = reader(m["name"]).read(outcome.summary)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in metrics_of(bench, workload, "end_to_end"):
            if m["name"] in outcome.end_to_end:
                metrics[m["name"]] = {"value": outcome.end_to_end[m["name"]],
                                      "unit": m["unit"]}
    dev = {"platform": "gpu", "kind": kind, "count": int(cell["chips"]),
           "memory_peak_bytes": outcome.memory_peak_bytes,
           "power_limit_w": power_limit_w()}
    result = result_line(outcome, metrics, dev, traced)
    sys.stdout.flush()
    for note in list(notes) + outcome.summary.get("notes", []):
        print(note, file=sys.stderr)
    for c in outcome.checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    found = foreign_modules()
    if found:
        print("portbench: the run loaded JAX or the JAX package: "
              + ", ".join(found), file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
