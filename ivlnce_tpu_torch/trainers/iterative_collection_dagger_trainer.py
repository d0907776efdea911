"""The iterative-collection DAgger trainer under its reference name, for
evaluation: the PyTorch counterpart of
``ivlnce_tpu/trainers/iterative_collection_dagger_trainer.py:32``. Its
tour-ordered collection waits for the training slice of the port."""

from __future__ import annotations

from ivlnce_tpu_torch.trainers.dagger_trainer import DaggerTrainer
from ivlnce_tpu_torch.utils.registry import registry


@registry.register_trainer(name="iterative_collection_dagger")
class IterativeCollectionDaggerTrainer(DaggerTrainer):
    pass
