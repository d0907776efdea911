"""TensorBoard writer (habitat-baselines TensorboardWriter equivalent) via
tensorboardX, or ``torch.utils.tensorboard`` where tensorboardX is not
installed; degrades to a no-op when the directory is empty like the
reference, or when neither is installed."""

from __future__ import annotations

from typing import Optional


class TensorboardWriter:
    def __init__(self, log_dir: str, flush_secs: int = 30, purge_step=None):
        self._writer = None
        if log_dir:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                try:
                    from torch.utils.tensorboard import SummaryWriter
                except ImportError:
                    return
            self._writer = SummaryWriter(
                log_dir, flush_secs=flush_secs, purge_step=purge_step
            )

    def add_scalar(self, tag: str, value, step) -> None:
        if self._writer:
            self._writer.add_scalar(tag, value, step)

    def add_video_from_np_images(self, name, step, images, fps: int = 10):
        if self._writer is None:
            return
        import numpy as np

        frames = np.stack(images, 0).transpose(0, 3, 1, 2)[None]
        self._writer.add_video(name, frames, step, fps=fps)

    def close(self) -> None:
        if self._writer:
            self._writer.close()

    def __enter__(self) -> "TensorboardWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
