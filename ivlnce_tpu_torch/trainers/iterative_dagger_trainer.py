"""The iterative DAgger trainer under its reference name, for evaluation:
the PyTorch counterpart of
``ivlnce_tpu/trainers/iterative_dagger_trainer.py:31``. Its tour-BPTT
training waits for the training slice of the port."""

from __future__ import annotations

from ivlnce_tpu_torch.trainers.iterative_collection_dagger_trainer import (
    IterativeCollectionDaggerTrainer,
)
from ivlnce_tpu_torch.utils.registry import registry


@registry.register_trainer(name="iterative_dagger")
class IterativeDaggerTrainer(IterativeCollectionDaggerTrainer):
    pass
