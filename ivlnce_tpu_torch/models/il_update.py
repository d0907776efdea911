"""The IL update (reference base_il_trainer.py:173-219): ``train_step``,
which the trainers' ``_update_agent`` calls, and the parts that
``parallel/train.py``'s data-parallel step shares with it."""

from __future__ import annotations

from typing import Optional

import torch

from ivlnce_tpu_torch.models.cma import progress_monitor_loss
from ivlnce_tpu_torch.utils import profiling, upload as U


def train_mode(policy):
    """The modes a policy trains in: eval, but for the recurrent modules,
    which cuDNN's backward needs in train mode; BatchNorm is switched by
    the forward's ``training`` argument. Returns ``policy``."""
    policy.eval()
    for module in policy.modules():
        if isinstance(module, torch.nn.RNNBase):
            module.train()
    return policy


def make_optimizer(policy, config) -> torch.optim.Adam:
    """Adam at ``IL.lr`` (optax's defaults: betas 0.9 / 0.999, eps 1e-8);
    with ``SEMANTIC_MAP_ENCODER.custom_lr`` the map encoder's parameters
    form a second group at ``SEMANTIC_MAP_ENCODER.lr`` (JAX
    base_trainer.py:193-211)."""
    params = list(policy.parameters())
    map_encoder = getattr(policy.net, "map_encoder", None)
    if not config.MODEL.SEMANTIC_MAP_ENCODER.custom_lr or map_encoder is None:
        return torch.optim.Adam(params, lr=config.IL.lr)
    in_map = {id(p) for p in map_encoder.parameters()}
    return torch.optim.Adam([
        {"params": [p for p in params if id(p) not in in_map],
         "lr": config.IL.lr},
        {"params": list(map_encoder.parameters()),
         "lr": config.MODEL.SEMANTIC_MAP_ENCODER.lr},
    ])


def refreshes_map_bn(policy) -> bool:
    """Whether an update recomputes a trained map encoder's statistics."""
    return (hasattr(policy.net, "map_encoder")
            and policy.net.cfg.SEMANTIC_MAP_ENCODER.trainable)


def to_device(a, device: torch.device) -> torch.Tensor:
    """``a`` on ``device``: a tensor moved, a host array copied by
    ``utils/upload.py::blocking``."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return U.blocking({"a": a}, device)["a"]


def train_loss(policy, observations, prev_actions, episode_masks,
               tour_masks, corrected, weights, rnn_states,
               use_progress: bool, alpha: float,
               n_lanes: Optional[int] = None,
               n_aux_rows: Optional[int] = None):
    """The training forward and its loss (JAX base_trainer.py:69-93):
    ``mean_n(sum_t w * CE / sum_t w)`` over the (T, N) ``corrected``
    actions and inflection ``weights``, plus ``alpha`` times the progress
    monitor's squared error over the rows with w > 0. Returns (loss,
    action loss, aux loss, final rnn_states).

    A shard of a larger batch (``parallel/train.py``) passes the whole
    batch's lane count ``n_lanes`` and its count of rows with w > 0
    ``n_aux_rows``: its terms are then its share of the whole batch's, and
    the shards' terms add up to them."""
    t, n = corrected.shape
    logits, features, rnn_out = policy.build_distribution(
        observations, rnn_states, prev_actions, episode_masks, tour_masks,
        training=True,
    )
    with profiling.span("train_loss"):
        logp = torch.log_softmax(logits.reshape(t, n, -1), dim=-1)
        action_loss = -logp.gather(-1, corrected[..., None])[..., 0]
        action_loss = (weights * action_loss).sum(0) / weights.sum(0)
        action_loss = (action_loss.mean() if n_lanes is None
                       else action_loss.sum() / n_lanes)
        aux_loss = torch.zeros((), device=logits.device)
        if use_progress:
            p_loss = progress_monitor_loss(policy.net, features,
                                           observations["progress"])
            aux_mask = (weights > 0).reshape(-1).float()
            aux_loss = alpha * (p_loss * aux_mask).sum() / (
                aux_mask.sum() if n_aux_rows is None else n_aux_rows)
    return action_loss + aux_loss, action_loss, aux_loss, rnn_out


def train_step(policy, optimizer, observations, prev_actions, episode_masks,
               tour_masks, corrected, weights, rnn_states,
               use_progress: bool, alpha: float, update_map_bn: bool):
    """One BPTT update (JAX ``make_train_step``): host arrays copied to the
    policy's device, the loss, its gradients, an optimizer step, then,
    with ``update_map_bn``, the map encoder's running BatchNorm statistics
    recomputed over the batch's maps with the UPDATED weights, as JAX does
    after its optimizer update. Returns the loss terms and the final
    rnn_states, detached."""
    device = next(policy.parameters()).device
    with profiling.span("upload"):
        observations = {k: to_device(v, device)
                        for k, v in observations.items()}
        batch = [to_device(a, device) for a in (
            prev_actions, episode_masks, tour_masks, corrected, weights)]
    loss, action_loss, aux_loss, rnn_out = train_loss(
        policy, observations, *batch, rnn_states, use_progress, alpha,
    )
    with profiling.span("backward"):
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
    with profiling.span("optimizer"):
        optimizer.step()
    if update_map_bn:
        with profiling.span("map_bn_stats"):
            policy.net.map_encoder.update_running_stats(
                observations["occupancy_map"], observations["semantic_map"]
            )
    return (loss.detach(), action_loss.detach(), aux_loss.detach(),
            rnn_out.detach())
