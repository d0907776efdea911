"""IL policies with a categorical action head: the PyTorch counterpart of
``ivlnce_tpu/models/policy.py`` (reference policy.py:12-83,
map_cma_policy.py:28-100, latent_cma_policy.py:28-193).

``CMAPolicy`` holds the act plumbing both nets share and the training
forward (``build_distribution``); the subclasses name their net, the
sensors its step reads and, for LatentCMA, which masks restart the GRUs
in a tour."""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.distributions import Categorical
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from ivlnce_tpu_torch.models.cma import (
    NUM_ACTIONS,
    CMAFeatures,
    LatentCMANet,
    MapCMANet,
)
from ivlnce_tpu_torch.utils.registry import registry


class PolicyOutput(NamedTuple):
    actions: torch.Tensor  # (N, 1) int64
    rnn_states: torch.Tensor  # (N, L, H)
    logits: torch.Tensor  # (N, A)


class CategoricalNet(nn.Module):
    def __init__(self, num_inputs: int, num_outputs: int):
        super().__init__()
        self.linear = nn.Linear(num_inputs, num_outputs)
        nn.init.orthogonal_(self.linear.weight, gain=0.01)
        nn.init.constant_(self.linear.bias, 0)


def sample_actions(logits: torch.Tensor,
                   generator: torch.Generator) -> torch.Tensor:
    """One draw per row from Categorical(logits=...), (N, 1), taken with
    ``generator`` so a seed gives the same actions."""
    probs = Categorical(logits=logits).probs
    return torch.multinomial(probs, 1, generator=generator)


class CMAPolicy(nn.Module):
    """Shared act plumbing (``_CMAPolicyBase``, JAX policy.py:54-176)."""

    def __init__(self, config, net_fn):
        super().__init__()
        model_config = config.MODEL.clone()
        # both CMA nets force per-token instruction features
        # (map_cma_policy.py:116-118, latent_cma_policy.py:209-211)
        model_config.INSTRUCTION_ENCODER.final_state_only = False
        # the encoders' dtype (JAX policy.py:62-67)
        model_config.compute_dtype = config.TPU.compute_dtype
        self.model_config = model_config.freeze()
        # rows per recomputed encoder chunk of the training forward
        # (TPU.train_encode_chunk; 0 = one pass over all T*N rows)
        self.encode_chunk = int(config.TPU.train_encode_chunk)
        self.net = net_fn(self.model_config)
        self.action_distribution = CategoricalNet(
            self.net.hidden_size, NUM_ACTIONS
        )

    @classmethod
    def from_config(cls, config, observation_info):
        return cls(config, observation_info)

    @property
    def num_recurrent_layers(self) -> int:
        return self.net.num_recurrent_layers

    @property
    def hidden_size(self) -> int:
        return self.net.hidden_size

    def initial_rnn_states(self, batch_size: int, device) -> torch.Tensor:
        return torch.zeros(
            (batch_size, self.num_recurrent_layers, self.hidden_size),
            device=device,
        )

    def _iterative_masks(
        self, agent_masks, sim_masks, tour_masks
    ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        """(episode, tour) masks of act_iterative; None takes the agent
        masks. MapCMA resets its GRUs at agent-episode boundaries
        (map_cma_policy.py:45-71)."""
        return None, None

    def _act(self, observations, rnn_states, prev_actions, action_masks,
             episode_masks, tour_masks, generator) -> PolicyOutput:
        # named ranges a torch.profiler trace attributes device time to
        with record_function("encoders"):
            feats = self.net.encode(observations, prev_actions, action_masks)
        with record_function("gru_attention"):
            features, rnn_out = self.net.step(
                feats, rnn_states, episode_masks, tour_masks
            )
        logits = self.action_distribution.linear(features)
        if generator is None:
            actions = torch.argmax(logits, dim=-1, keepdim=True)
        else:
            actions = sample_actions(logits, generator)
        return PolicyOutput(actions, rnn_out, logits)

    def _training_masks(self, agent_masks, tour_masks):
        """(episode, tour) masks of the training forward, (T, N) each;
        MapCMA restarts its GRUs at agent-episode boundaries."""
        return agent_masks, tour_masks

    def build_distribution(
        self,
        observations: Dict[str, torch.Tensor],
        rnn_states: torch.Tensor,  # (N, L, H)
        prev_actions: torch.Tensor,  # (T*N, 1)
        agent_episode_not_done_masks: torch.Tensor,  # (T*N, 1) or (T, N)
        tour_not_done_masks: Optional[torch.Tensor] = None,
        training: bool = True,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The sequence forward over T-major T*N rows (the trainers' BPTT
        path, JAX policy.py:177-229): the encoders run over all rows at
        once, the recurrent step loops over T. Returns (logits (T*N, A),
        features (T*N, H), final rnn_states)."""
        n = rnn_states.shape[0]
        agent = agent_episode_not_done_masks.reshape(-1, n)
        t = agent.shape[0]
        tour = agent if tour_not_done_masks is None else (
            tour_not_done_masks.reshape(t, n))
        episode_t, tour_t = self._training_masks(agent, tour)
        with record_function("train_encode"):
            feats = self._encode_seq(observations, prev_actions,
                                     agent.reshape(-1), training)
        with record_function("train_rnn"):
            feats_t = [x.reshape((t, n) + x.shape[1:]) for x in feats]
            features, h = [], rnn_states
            for i in range(t):
                out, h = self.net.step(CMAFeatures(*(x[i] for x in feats_t)),
                                       h, episode_t[i], tour_t[i])
                features.append(out)
            features = torch.cat(features, 0)
            logits = self.action_distribution.linear(features)
        return logits, features, h

    def _encode_seq(self, observations, prev_actions, masks, training):
        """``net.encode`` over the T*N rows; while training with
        ``encode_chunk`` > 0 and smaller than T*N, in chunks of that many
        rows, each recomputed in the backward pass
        (``torch.utils.checkpoint``), so only the chunks' outputs are kept.
        The rows are zero-padded up to a whole number of chunks and the
        padding is cut from the outputs; each chunk's map BatchNorm sees
        that chunk's rows, padding included, as the JAX scan's does."""
        chunk = self.encode_chunk
        tn = masks.shape[0]
        if not training or chunk <= 0 or tn <= chunk:
            return self.net.encode(observations, prev_actions, masks,
                                   training)
        k = -(-tn // chunk)
        pad = k * chunk - tn

        def chunked(a):
            if pad:
                a = torch.cat([a, a.new_zeros((pad,) + a.shape[1:])], 0)
            return a.split(chunk)

        keys = [k_ for k_, v in observations.items()
                if isinstance(v, torch.Tensor)]
        obs_c = [dict(zip(keys, parts)) for parts in
                 zip(*(chunked(observations[k_]) for k_ in keys))]
        pa_c = chunked(prev_actions.reshape(-1, 1))
        m_c = chunked(masks)

        def encode_chunk(o, pa, m):
            return tuple(self.net.encode(o, pa, m, training))

        outs = [checkpoint(encode_chunk, o, pa, m, use_reentrant=False)
                for o, pa, m in zip(obs_c, pa_c, m_c)]
        return CMAFeatures(*(torch.cat(parts, 0)[:tn]
                             for parts in zip(*outs)))

    def act(self, observations, rnn_states, prev_actions, masks,
            generator: Optional[torch.Generator] = None) -> PolicyOutput:
        """The mode action, or a draw when a ``generator`` is given."""
        masks = masks.reshape(-1)
        return self._act(observations, rnn_states, prev_actions, masks,
                         masks, None, generator)

    def act_iterative(
        self,
        observations: Dict[str, torch.Tensor],
        rnn_states: torch.Tensor,
        prev_actions: torch.Tensor,
        agent_episode_not_done_masks: torch.Tensor,
        sim_episode_not_done_masks: torch.Tensor,
        tour_not_done_masks: torch.Tensor,
        action_masks: torch.Tensor,
        generator: Optional[torch.Generator] = None,
    ) -> PolicyOutput:
        """The previous-action embedding is reset by the agent masks; the
        GRUs by the masks ``_iterative_masks`` picks."""
        agent = agent_episode_not_done_masks.reshape(-1)
        episode, tour = self._iterative_masks(
            agent, sim_episode_not_done_masks.reshape(-1),
            tour_not_done_masks.reshape(-1),
        )
        if episode is None:
            episode = agent
        return self._act(observations, rnn_states, prev_actions, agent,
                         episode, tour, generator)


@registry.register_policy(name="MapCMAPolicy")
class MapCMAPolicy(CMAPolicy):
    # sensors the act step reads (the upload filter keeps the rest, rgb
    # included, on the host)
    device_obs_keys = frozenset({"depth", "occupancy_map", "semantic_map"})

    def __init__(self, config, observation_info: Dict):
        super().__init__(config, lambda cfg: MapCMANet(
            cfg, observation_info["depth_hw"], observation_info["map_hw"]))


@registry.register_policy(name="LatentCMAPolicy")
class LatentCMAPolicy(CMAPolicy):
    device_obs_keys = frozenset({"depth", "rgb"})

    def __init__(self, config, observation_info: Dict):
        super().__init__(config, lambda cfg: LatentCMANet(
            cfg, observation_info["depth_hw"]))

    def _iterative_masks(self, agent_masks, sim_masks, tour_masks):
        """latent_cma_policy.py:48-88: ``tour_memory_variant`` keeps the
        episodic resets and clears the memory slot at tour boundaries;
        ``tour_memory`` restarts the GRUs only at tour boundaries."""
        cfg = self.model_config
        if cfg.tour_memory_variant:
            return agent_masks, tour_masks
        if cfg.tour_memory:
            return tour_masks, None
        return None, None

    def _training_masks(self, agent_masks, tour_masks):
        """JAX policy.py:360-367: ``tour_memory`` restarts the GRUs at
        tour boundaries only."""
        cfg = self.model_config
        if cfg.tour_memory and not cfg.tour_memory_variant:
            return tour_masks, tour_masks
        return agent_masks, tour_masks
