"""Host-to-device uploads of the eval step.

``StagedUpload`` owns, for one device, two pairs of byte arenas: a host
arena (pinned on a CUDA device) and a device arena. A call packs host
arrays into aligned slots of the current host arena, one ``copy_`` per
array (torch's threaded CPU copy), sends the span it filled to the device
arena in one ``non_blocking`` copy, and returns typed views of the device
arena, each with the shape and dtype ``torch.from_numpy(a).to(device)``
would give. On the card nothing in it waits for the stream: the pinned
copy returns at once, and the host writes into a host arena again only
after the event recorded behind its last copy has passed. On the CPU the
host arena is an ordinary tensor and the copy a CPU copy, so the packing
and the views run the same code. (Torch's OpenMP workers spin for a while
after each copy; numpy copies in a pool of sleeping threads packed more
slowly on the card's host.)

The owner calls ``begin_step()`` once per step; the step's calls then
fill one pair of arenas, and the next step fills the other. A view
handed out in a step holds until the second ``begin_step()`` after it:
keep none beyond the step, or clone it. An arena that a step outgrows is
replaced by a larger one (the old one lives on while views of it do) and
is never shrunk.

``blocking`` is the plain copy, one pageable ``torch.from_numpy(a).to()``
per array, for callers outside a step. Under a capture the bytes each
sends are counted, as ``upload_bytes_staged`` and
``upload_bytes_blocking`` (``utils/profiling.py::count``)."""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ivlnce_tpu_torch.utils import profiling

ALIGN = 256  # bytes between slots: the card's allocation alignment
ARENAS = 2  # pairs of arenas, taken by the steps in turn

# host arrays -> device tensors: a StagedUpload, or ``blocking_to(device)``
Upload = Callable[[Dict[str, np.ndarray]], Dict[str, torch.Tensor]]


def _aligned(offset: int) -> int:
    return -(-offset // ALIGN) * ALIGN


def _tensor(a: np.ndarray) -> torch.Tensor:
    """``a`` as a CPU tensor, sharing its memory where torch allows it."""
    if not a.flags.writeable or any(s < 0 for s in a.strides):
        a = np.array(a)
    return torch.from_numpy(a)


def blocking(arrays: Dict[str, np.ndarray],
             device) -> Dict[str, torch.Tensor]:
    """Each array in its own copy, ``torch.from_numpy(a).to(device)``:
    on a card a pageable copy that waits for the stream."""
    out = {k: torch.from_numpy(np.ascontiguousarray(a)).to(device)
           for k, a in arrays.items()}
    profiling.count("upload_bytes_blocking",
                    sum(t.numel() * t.element_size() for t in out.values()))
    return out


def blocking_to(device) -> Upload:
    """``blocking`` to ``device``, called as a ``StagedUpload`` is."""
    return functools.partial(blocking, device=device)


class _Arenas:
    """One host arena and one device arena, the bytes a step has used of
    them and the event behind their last copy."""

    __slots__ = ("host", "device", "used", "copied")

    def __init__(self):
        self.host: Optional[torch.Tensor] = None
        self.device: Optional[torch.Tensor] = None
        self.used = 0
        self.copied = None

    @property
    def capacity(self) -> int:
        return 0 if self.host is None else self.host.numel()


class StagedUpload:
    """Uploads staged through a pinned arena (see the module's
    docstring)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self._arenas = [_Arenas() for _ in range(ARENAS)]
        self._turn = 0

    def begin_step(self) -> None:
        """Take the next pair of arenas for this step's copies, once the
        last copy out of its host arena has run."""
        self._turn = (self._turn + 1) % len(self._arenas)
        arenas = self._arenas[self._turn]
        if arenas.copied is not None:
            arenas.copied.synchronize()
        arenas.used = 0

    def _grow(self, arenas: _Arenas, nbytes: int) -> None:
        """New arenas of at least ``nbytes`` and twice the old size; the
        old ones stay alive while their views do."""
        size = _aligned(max(nbytes, 2 * arenas.capacity))
        # ordinary tensors even inside inference_mode, so a later step
        # outside it (a collection under no_grad) may still write them
        with torch.inference_mode(False):
            arenas.host = torch.empty(size, dtype=torch.uint8,
                                      pin_memory=self._cuda)
            arenas.device = torch.empty(size, dtype=torch.uint8,
                                        device=self.device)

    def __call__(self, arrays: Dict[str, np.ndarray]
                 ) -> Dict[str, torch.Tensor]:
        """Device views of ``arrays``, sent in one copy."""
        arenas = self._arenas[self._turn]
        host = [(k, _tensor(np.asarray(a))) for k, a in arrays.items()]
        first = _aligned(arenas.used)
        slots: List[int] = []
        end = first
        for _, t in host:
            slots.append(_aligned(end))
            end = slots[-1] + t.numel() * t.element_size()
        if end > arenas.capacity:
            # room for the step's bytes so far and these; these go first
            self._grow(arenas, end)
            slots = [s - first for s in slots]
            first, end = 0, end - first
        out = {}
        for (k, t), start in zip(host, slots):
            n = t.numel() * t.element_size()
            arenas.host[start:start + n].view(t.dtype).view(
                t.shape).copy_(t)
            out[k] = arenas.device[start:start + n].view(t.dtype).view(
                t.shape)
        arenas.device[first:end].copy_(arenas.host[first:end],
                                       non_blocking=True)
        if self._cuda:
            if arenas.copied is None:
                arenas.copied = torch.cuda.Event()
            arenas.copied.record(torch.cuda.current_stream(self.device))
        arenas.used = end
        profiling.count("upload_bytes_staged",
                        sum(t.numel() * t.element_size() for _, t in host))
        return out
