"""Tour-ordered DAgger training (latent memory models): the PyTorch
counterpart of ``ivlnce_tpu/trainers/iterative_dagger_trainer.py``
(reference ivlnce_baselines/trainers/iterative_dagger_trainer.py).

Collection is the iterative one, with the ``tours_to_idxs`` index at
store key 0. Training binpacks the tours into ``IL.batch_size`` lanes
(``TourSampler``) and carries the RNN hidden state across consecutive
batches of the same lanes (truncated BPTT at batch granularity,
:218-253): episodic slots reset each batch unless tour memory is
configured; the tour-memory slot persists and is re-masked by the
tour_not_done flags inside the net."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ivlnce_tpu_torch.trainers.iterative_collection_dagger_trainer import (
    IterativeCollectionDaggerTrainer,
)
from ivlnce_tpu_torch.trainers.tour_dataset import (
    TourSampler,
    TourTrajectoryDataset,
)
from ivlnce_tpu_torch.trainers.trajectory_store import TrajectoryStore
from ivlnce_tpu_torch.utils.prefetch import prefetch
from ivlnce_tpu_torch.utils.registry import registry
from ivlnce_tpu_torch.utils.tb import TensorboardWriter

def carry_in(policy, model_config, rnn_states: Optional[torch.Tensor],
             n: int, device) -> torch.Tensor:
    """The RNN state a tour batch starts from (iterative_dagger_trainer.py
    :33-94): a fresh one without ``tour_memory`` or
    ``tour_memory_variant``; with ``tour_memory_variant`` the episodic
    slots (all but the last) zeroed and the tour slot kept. Detached: no
    gradient flows back into the previous batch."""
    reset = not (model_config.tour_memory or model_config.tour_memory_variant)
    if rnn_states is None or reset:
        rnn_states = policy.initial_rnn_states(n, device)
    rnn_states = rnn_states.detach()
    if model_config.tour_memory_variant:
        rnn_states = rnn_states.clone()
        rnn_states[:, : policy.num_recurrent_layers - 1] = 0.0
    return rnn_states


@registry.register_trainer(name="iterative_dagger")
class IterativeDaggerTrainer(IterativeCollectionDaggerTrainer):
    def _update_agent_iterative(
        self,
        observations,
        prev_actions,
        episode_not_done_masks,
        tour_not_done_masks,
        corrected_actions,
        weights,
        rnn_states: Optional[torch.Tensor] = None,
    ):
        """One BPTT update of a tour batch from the carried state. Returns
        (loss, action loss, aux loss) as floats and the final rnn_states
        (detached), the next batch's carry."""
        n = corrected_actions.shape[1]
        return self._update_agent(
            observations,
            prev_actions,
            episode_not_done_masks,
            corrected_actions,
            weights,
            tour_not_done_masks=tour_not_done_masks,
            rnn_states=carry_in(self.policy, self.config.MODEL, rnn_states,
                                n, self.device),
        )

    def _train(self) -> None:
        config = self._start_training()
        with TensorboardWriter(
            config.TENSORBOARD_DIR, flush_secs=self.flush_secs
        ) as writer:
            for dagger_it in range(config.IL.DAGGER.iterations):
                step_id = 0
                if config.IL.DAGGER.preload_lmdb_features:
                    with TrajectoryStore(self.lmdb_features_dir) as store:
                        tours_to_idxs = store.get(0)["tours_to_idxs"]
                else:
                    tours_to_idxs = self._collect(
                        dagger_it + (1 if config.IL.load_from_ckpt else 0),
                        save_tour_idx_data=True,
                    )

                for epoch in range(config.IL.epochs):
                    dataset = TourTrajectoryDataset(
                        self.lmdb_features_dir,
                        config.IL.use_iw,
                        inflection_weight_coef=(
                            config.IL.inflection_weight_coef
                        ),
                    )
                    sampler = TourSampler(
                        tours_to_idx=tours_to_idxs,
                        batch_size=config.IL.batch_size,
                        shuffle=True,
                        drop_last=True,
                    )
                    dataset.set_tour_done_idxs(sampler.get_tour_done_idxs())

                    rnn_states = self.policy.initial_rnn_states(
                        config.IL.batch_size, self.device
                    )
                    with prefetch(
                        dataset.batches(sampler), depth=3
                    ) as batches:
                        for batch in batches:
                            (
                                observations, prev_actions, episode_masks,
                                tour_masks, corrected, weights,
                            ) = batch
                            (
                                loss, action_loss, aux_loss, rnn_states,
                            ) = self._update_agent_iterative(
                                {
                                    k: v.astype(np.float32)
                                    if v.dtype == np.float16
                                    else v
                                    for k, v in observations.items()
                                },
                                prev_actions,
                                episode_masks,
                                tour_masks,
                                corrected,
                                weights,
                                rnn_states=rnn_states,
                            )
                            self._log_train_step(writer, dagger_it, epoch,
                                                 step_id, loss, action_loss,
                                                 aux_loss)
                            step_id += 1
                    dataset.close()

                    self.save_training_checkpoint(
                        f"ckpt.{dagger_it * config.IL.epochs + epoch}.pth",
                        dagger_it=dagger_it,
                        epoch=epoch,
                        step_id=step_id,
                    )
