"""The iterative DAgger trainer under its reference name: the PyTorch
counterpart of ``ivlnce_tpu/trainers/iterative_dagger_trainer.py:31``.
It evaluates and collects as its parent does; its tour-BPTT training
(``tour_dataset.py``'s ``TourSampler``, iterative_dagger_trainer.py:33-179)
waits for the next slice of the port."""

from __future__ import annotations

from ivlnce_tpu_torch.trainers.iterative_collection_dagger_trainer import (
    IterativeCollectionDaggerTrainer,
)
from ivlnce_tpu_torch.utils.registry import registry


@registry.register_trainer(name="iterative_dagger")
class IterativeDaggerTrainer(IterativeCollectionDaggerTrainer):
    def train(self) -> None:
        raise NotImplementedError(
            f"{type(self).__name__}.train: the tour-BPTT training "
            "(TourSampler, a carried RNN state across a tour's episodes) "
            "waits for the tour-BPTT slice of the port (ROADMAP); the "
            "dagger and iterative_collection_dagger trainers train"
        )
