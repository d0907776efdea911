"""What every driver shares: the data files found by name, the port's
config built from a configuration file, seeded weights made on the
device, the compared numbers and the result."""

from __future__ import annotations

import json
import math
import os
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load(kind: str, name: str) -> Dict:
    """``portbench/<kind>/<name>.json``."""
    path = HERE / kind / f"{name}.json"
    if not path.exists():
        raise SystemExit(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def benchmark() -> Dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@dataclass
class Check:
    """A number compared with the plain reference, and its limit: the
    run is correct when every value is at most its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class RunContext:
    cell: Dict
    config: Dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    started: float  # perf_counter at process start
    control: str = ""  # "tf32" or "bf16": the lower-precision control
    overrides: Dict = field(default_factory=dict)  # tests: small sizes
    fault: Optional[Callable] = None  # tests: breaks the timed path
    marks: List = field(default_factory=list)  # set-up's phases

    @property
    def traffic(self) -> Dict:
        return {**self.cell["traffic"], **self.overrides.get("traffic", {})}

    def mark(self, phase: str) -> None:
        """The end of a phase of set-up."""
        self.marks.append((phase, time.perf_counter()))

    def setup_notes(self) -> List[str]:
        """Each phase of set-up in seconds, for standard error."""
        prev, parts = self.started, []
        for phase, t in self.marks:
            parts.append(f"{phase} {t - prev:.3f}")
            prev = t
        return ["setup phases (s): " + ", ".join(parts)] if parts else []


class HostLoad:
    """What the host gave this process between its start and ``note``:
    the machine's CPU time taken by other guests (steal), the process's
    CPU seconds (every thread) and its involuntary context switches, read
    from ``/proc``; empty where that cannot be read."""

    def __init__(self):
        self.wall = time.perf_counter()
        self.cpu = sum(os.times()[:2])
        self.stat = self._stat()
        self.switches = self._switches()

    @staticmethod
    def _stat() -> List[int]:
        try:
            with open("/proc/stat") as f:
                return [int(x) for x in f.readline().split()[1:]]
        except (OSError, ValueError):
            return []

    @staticmethod
    def _switches() -> int:
        try:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("nonvoluntary_ctxt_switches"):
                        return int(line.split()[1])
        except (OSError, ValueError):
            pass
        return -1

    def note(self, what: str) -> str:
        wall = time.perf_counter() - self.wall
        cpu = sum(os.times()[:2]) - self.cpu
        stat = [b - a for a, b in zip(self.stat, self._stat())]
        steal = (100.0 * stat[7] / max(1, sum(stat))
                 if len(stat) > 7 else float("nan"))
        return (f"host over {what}: {wall:.2f} s wall, process CPU "
                f"{cpu:.2f} s, machine steal {steal:.2f}%, involuntary "
                f"switches {self._switches() - self.switches}")


@dataclass
class Outcome:
    end_to_end: Dict[str, float]
    checks: List[Check]
    attempted: int
    failed: int
    memory_peak_bytes: int
    summary: Dict[str, Any] = field(default_factory=dict)  # traced run

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks)


def scratch_dir(name: str) -> str:
    """A fixed directory of the checkout for files the program writes
    (its checkpoint and results folders): ``build/portbench/<name>``."""
    path = ROOT / "build" / "portbench" / name
    path.mkdir(parents=True, exist_ok=True)
    return str(path)


def port_config(ctx: RunContext, extra: Dict):
    """The port's config: its defaults, the configuration file's
    ``opts``, then ``extra`` and the tests' ``opts`` overrides; the
    ``bf16`` control runs ``TPU.compute_dtype`` bfloat16."""
    from ivlnce_tpu_torch.config import get_config

    opts = {**ctx.config["opts"], **extra, **ctx.overrides.get("opts", {}),
            "TASK_CONFIG.SEED": ctx.seed % (2 ** 31),
            "CHECKPOINT_FOLDER": scratch_dir("checkpoints"),
            "RESULTS_DIR": scratch_dir("results"),
            "TENSORBOARD_DIR": scratch_dir("tensorboard")}
    if ctx.control == "bf16":
        opts["TPU.compute_dtype"] = "bfloat16"
    flat = []
    for k, v in opts.items():
        flat += [k, v]
    return get_config(None, flat)


def _init(mod: torch.nn.Module, name: str, t: torch.Tensor, z: torch.Tensor,
          u: torch.Tensor) -> torch.Tensor:
    """A leaf's seeded value from standard normal ``z`` and uniform ``u``
    draws of its shape."""
    if isinstance(mod, (torch.nn.BatchNorm2d, torch.nn.GroupNorm)):
        return {"weight": 0.5 + u, "bias": 0.1 * z, "running_mean": 0.2 * z,
                "running_var": 0.5 + 1.5 * u}[name]
    if isinstance(mod, torch.nn.Embedding):
        if mod.padding_idx is not None:
            z = z.clone()
            z[mod.padding_idx] = 0
        return z
    if isinstance(mod, torch.nn.RNNBase):
        return (2 * u - 1) / math.sqrt(mod.hidden_size)
    if name == "bias":
        return 0.1 * z / math.sqrt(max(1, mod.weight[0].numel()))
    return z / math.sqrt(t[0].numel())


@torch.no_grad()
def seed_weights(policy: torch.nn.Module, seed: int) -> int:
    """Overwrite every floating parameter and buffer of ``policy`` with
    draws from one generator on its device seeded with ``seed``, made in
    two calls (normal and uniform) and split by leaf: layers get
    1/sqrt(fan-in) scales, norms scales about 1 and running statistics far
    from a fresh init's, so a wrong statistic shows. Returns the count of
    values drawn."""
    leaves = []
    for mod in policy.modules():
        for name, t in list(mod.named_parameters(recurse=False)) + list(
                mod.named_buffers(recurse=False)):
            if t.is_floating_point():
                leaves.append((mod, name, t))
    total = sum(t.numel() for _, _, t in leaves)
    device = leaves[0][2].device
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (2 ** 63))
    normal = torch.randn(total, generator=gen, device=device)
    uniform = torch.rand(total, generator=gen, device=device)
    offset = 0
    for mod, name, t in leaves:
        k = t.numel()
        z = normal[offset:offset + k].view(t.shape)
        u = uniform[offset:offset + k].view(t.shape)
        t.copy_(_init(mod, name, t, z, u))
        offset += k
    return total


def weights_of(policy: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """Detached float32 copies of the policy's state, by name."""
    return {k: v.detach().clone() for k, v in policy.state_dict().items()
            if v.is_floating_point()}


def allow_tf32(on: bool) -> None:
    """TF32 in float32 matrix products and cuDNN convolutions: the
    ``tf32`` control turns it on after the program has turned it off."""
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def release(device: torch.device) -> None:
    """Hand the program's freed device memory back before the reference
    runs (its state may sit in reference cycles until collected)."""
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def memory_peak(device: torch.device) -> int:
    return (int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else 0)


def env_for_run() -> None:
    """What the process keeps: kernel caches inside the checkout at fixed
    paths, no trace window of the program's own, no JAX through
    ``transformers``."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for var in ("IVLNCE_PROFILE_DIR", "IVLNCE_PHASE_TIMES"):
        os.environ.pop(var, None)
