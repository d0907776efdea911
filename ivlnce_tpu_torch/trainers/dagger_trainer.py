"""The DAgger trainer under its reference name, for evaluation: the
PyTorch counterpart of ``ivlnce_tpu/trainers/dagger_trainer.py:265``
(reference dagger_trainer.py). Collection and training wait for the
training slice of the port (ROADMAP item 13)."""

from __future__ import annotations

from ivlnce_tpu_torch.trainers.base_trainer import BaseVLNCETrainer
from ivlnce_tpu_torch.utils.registry import registry


@registry.register_trainer(name="dagger")
class DaggerTrainer(BaseVLNCETrainer):
    def train(self) -> None:
        raise NotImplementedError(
            f"{type(self).__name__}.train: DAgger training waits for the "
            "training slice of the port (ROADMAP item 13); only eval runs"
        )
