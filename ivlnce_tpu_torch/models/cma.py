"""Cross-modal attention networks: the PyTorch counterpart of
``ivlnce_tpu/models/cma.py``: MapCMA (reference map_cma_policy.py:103-368)
and LatentCMA (latent_cma_policy.py:196-497).

RNN state is (B, L, H): one slot per GRU, and for LatentCMA's
``tour_memory_variant`` a third slot, the tour memory. Masks: the action
mask zeroes the previous-action embedding index, the episode mask
restarts both GRUs, the tour mask clears the tour memory. Each net runs
in two stages as in the JAX package: ``encode`` (encoders and K/V
projections) and ``step`` (two GRU cells and three attentions).

``TPU.compute_dtype`` bfloat16 (``model_config.compute_dtype``, set by the
policies) runs the depth, RGB and map encoders in bfloat16 on cast
copies of their weights (JAX cma.py:164-183,364-379); the map encoder
stays float32 in a training forward, and everything after the encoders
runs in float32."""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch
from torch import nn
from torch.profiler import record_function

from ivlnce_tpu_torch.models import instruction_encoder as IE
from ivlnce_tpu_torch.models.map_encoder import SemanticMapEncoder
from ivlnce_tpu_torch.models.nn import attend, compute_dtype
from ivlnce_tpu_torch.models.resnet import (
    TorchVisionResNetSpatial,
    VlnResnetDepthEncoder,
)
from ivlnce_tpu_torch.models.rnn import RNNStateEncoder

NUM_ACTIONS = 4  # STOP, MOVE_FORWARD, TURN_LEFT, TURN_RIGHT


class CMAFeatures(NamedTuple):
    """Per-frame encoder outputs consumed by the recurrent step."""

    txt: torch.Tensor  # (N, C_txt, T_tokens)
    text_mask: torch.Tensor  # (N, T_tokens)
    vis1_in: torch.Tensor  # (N, d_out)
    vis2_in: torch.Tensor  # (N, m_out)
    vis1_k: torch.Tensor  # (N, half, I)
    vis1_v: torch.Tensor  # (N, d_out, I)
    vis2_k: torch.Tensor
    vis2_v: torch.Tensor
    prev_a: torch.Tensor  # (N, 32)


class MapCMANet(nn.Module):
    def __init__(self, model_config, depth_hw: int, map_hw: int):
        super().__init__()
        cfg = model_config
        self.cfg = cfg
        hidden = cfg.STATE_ENCODER.hidden_size
        half = hidden // 2
        self.hidden_size = hidden
        self.half = half
        self.compute_dtype = compute_dtype(
            getattr(cfg, "compute_dtype", "float32"))
        self.instruction_encoder = IE.InstructionEncoder(
            cfg.INSTRUCTION_ENCODER
        )
        instr_out = IE.output_size(cfg.INSTRUCTION_ENCODER)
        self.depth_encoder = VlnResnetDepthEncoder(depth_hw // 2)
        smc = cfg.SEMANTIC_MAP_ENCODER
        self.map_encoder = SemanticMapEncoder(
            map_hw, smc.num_semantic_classes, smc.channels, smc.last_ch_mult
        )
        d_shape = self.depth_encoder.output_shape
        m_shape = self.map_encoder.output_shape
        d_out = cfg.DEPTH_ENCODER.output_size
        m_out = smc.output_size
        self.d_out, self.m_out = d_out, m_out
        self.prev_action_embedding = nn.Embedding(NUM_ACTIONS + 1, 32)
        self.depth_linear = nn.Sequential(
            nn.Flatten(), nn.Linear(math.prod(d_shape), d_out), nn.ReLU(True)
        )
        self.map_linear = nn.Sequential(
            nn.Flatten(), nn.Linear(math.prod(m_shape), m_out), nn.ReLU(True)
        )
        self.state_encoder = RNNStateEncoder(d_out + m_out + 32, hidden)
        self.dep_kv = nn.Conv1d(d_shape[0], half + d_out, 1)
        self.map_kv = nn.Conv1d(m_shape[0], half + m_out, 1)
        self.state_q = nn.Linear(hidden, half)
        self.text_k = nn.Conv1d(instr_out, half, 1)
        self.text_q = nn.Linear(instr_out, half)
        self.second_state_compress = nn.Sequential(
            nn.Linear(hidden + d_out + instr_out + m_out + 32, hidden),
            nn.ReLU(True),
        )
        self.second_state_encoder = RNNStateEncoder(hidden, hidden)
        self.progress_monitor = nn.Linear(hidden, 1)

    def encode(
        self,
        observations: Dict[str, torch.Tensor],
        prev_actions: torch.Tensor,
        action_masks: torch.Tensor,
        training: bool = False,
    ) -> CMAFeatures:
        """``training`` runs a trainable map encoder's BatchNorm on batch
        statistics (JAX cma.py:173-181); ``depth_features`` (a trajectory
        store's frozen-encoder features) stand in for the depth encoder."""
        cfg = self.cfg
        half = self.half
        txt = self.instruction_encoder(observations)
        if "depth_features" in observations:
            dep = observations["depth_features"]
        else:
            with record_function("depth_encoder"):
                dep = self.depth_encoder(observations["depth"],
                                         self.compute_dtype)
        dep = dep.flatten(2)
        with record_function("map_encoder"):
            map_feat = self.map_encoder(
                observations["occupancy_map"], observations["semantic_map"],
                training=training and cfg.SEMANTIC_MAP_ENCODER.trainable,
                dtype=self.compute_dtype,
            ).flatten(2)
        idx = ((prev_actions.reshape(-1).float() + 1)
               * action_masks.reshape(-1).float()).long()
        prev_a = self.prev_action_embedding(idx)
        if cfg.ablate_instruction:
            txt = txt * 0
        if cfg.ablate_depth:
            dep = dep * 0
        if cfg.ablate_map:
            map_feat = map_feat * 0
        dep_kv = self.dep_kv(dep)
        map_kv = self.map_kv(map_feat)
        return CMAFeatures(
            txt=txt,
            text_mask=(txt == 0.0).all(dim=1),
            vis1_in=self.depth_linear(dep),
            vis2_in=self.map_linear(map_feat),
            vis1_k=dep_kv[:, :half],
            vis1_v=dep_kv[:, half:],
            vis2_k=map_kv[:, :half],
            vis2_v=map_kv[:, half:],
            prev_a=prev_a,
        )

    num_recurrent_layers = 2

    def step(
        self,
        feats: CMAFeatures,
        rnn_states: torch.Tensor,  # (N, 2, hidden)
        episode_masks: torch.Tensor,  # (N,)
        tour_masks=None,  # MapCMA has no tour memory
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        scale = 1.0 / math.sqrt(self.half)
        state_in = torch.cat([feats.vis1_in, feats.vis2_in, feats.prev_a], 1)
        h1 = self.state_encoder(state_in, rnn_states[:, 0], episode_masks)
        text_embedding = attend(
            self.state_q(h1), self.text_k(feats.txt), feats.txt, scale,
            feats.text_mask,
        )
        text_q = self.text_q(text_embedding)
        v1_att = attend(text_q, feats.vis1_k, feats.vis1_v, scale)
        v2_att = attend(text_q, feats.vis2_k, feats.vis2_v, scale)
        x = torch.cat([h1, text_embedding, v1_att, v2_att, feats.prev_a], 1)
        x = self.second_state_compress(x)
        h2 = self.second_state_encoder(x, rnn_states[:, 1], episode_masks)
        return h2, torch.stack([h1, h2], dim=1)


class LatentCMANet(nn.Module):
    """LatentCMA (``ivlnce_tpu/models/cma.py:295-520``): depth and RGB
    encoders in place of the map, and with ``tour_memory_variant`` a tour
    memory slot fed to the first GRU and max-pooled with its output."""

    def __init__(self, model_config, depth_hw: int):
        super().__init__()
        cfg = model_config
        self.cfg = cfg
        hidden = cfg.STATE_ENCODER.hidden_size
        half = hidden // 2
        self.hidden_size = hidden
        self.half = half
        self.num_recurrent_layers = 2 + int(cfg.tour_memory_variant)
        self.compute_dtype = compute_dtype(
            getattr(cfg, "compute_dtype", "float32"))
        self.instruction_encoder = IE.InstructionEncoder(
            cfg.INSTRUCTION_ENCODER
        )
        instr_out = IE.output_size(cfg.INSTRUCTION_ENCODER)
        self.depth_encoder = VlnResnetDepthEncoder(depth_hw // 2)
        self.rgb_encoder = TorchVisionResNetSpatial(cfg.RGB_ENCODER.cnn_type)
        d_shape = self.depth_encoder.output_shape
        r_shape = self.rgb_encoder.output_shape
        d_out = cfg.DEPTH_ENCODER.output_size
        r_out = cfg.RGB_ENCODER.output_size
        self.prev_action_embedding = nn.Embedding(NUM_ACTIONS + 1, 32)
        self.rgb_linear = nn.Sequential(
            nn.AdaptiveAvgPool1d(1), nn.Flatten(),
            nn.Linear(r_shape[0], r_out), nn.ReLU(True),
        )
        self.depth_linear = nn.Sequential(
            nn.Flatten(), nn.Linear(math.prod(d_shape), d_out), nn.ReLU(True)
        )
        rnn_in = d_out + r_out + 32
        if cfg.tour_memory_variant:
            rnn_in += hidden
        self.state_encoder = RNNStateEncoder(rnn_in, hidden)
        self.rgb_kv = nn.Conv1d(r_shape[0], half + r_out, 1)
        self.depth_kv = nn.Conv1d(d_shape[0], half + d_out, 1)
        self.state_q = nn.Linear(hidden, half)
        self.text_k = nn.Conv1d(instr_out, half, 1)
        self.text_q = nn.Linear(instr_out, half)
        self.second_state_compress = nn.Sequential(
            nn.Linear(hidden + r_out + d_out + instr_out + 32, hidden),
            nn.ReLU(True),
        )
        self.second_state_encoder = RNNStateEncoder(hidden, hidden)
        self.progress_monitor = nn.Linear(hidden, 1)
        if cfg.memory_at_end:
            self.out_layer = nn.Sequential(
                nn.Linear(hidden * 2, hidden), nn.ReLU(True)
            )

    def encode(
        self,
        observations: Dict[str, torch.Tensor],
        prev_actions: torch.Tensor,
        action_masks: torch.Tensor,
        training: bool = False,
    ) -> CMAFeatures:
        """``training`` changes nothing here: LatentCMA has no trainable
        BatchNorm (its RGB trunk's statistics are frozen)."""
        cfg = self.cfg
        half = self.half
        txt = self.instruction_encoder(observations)
        if "depth_features" in observations:
            dep = observations["depth_features"]
        else:
            with record_function("depth_encoder"):
                dep = self.depth_encoder(observations["depth"],
                                         self.compute_dtype)
        dep = dep.flatten(2)
        if "rgb_features" in observations:
            rgb = observations["rgb_features"]
        else:
            with record_function("rgb_encoder"):
                rgb = self.rgb_encoder(observations["rgb"],
                                       self.compute_dtype)
        rgb = rgb.flatten(2)
        idx = ((prev_actions.reshape(-1).float() + 1)
               * action_masks.reshape(-1).float()).long()
        prev_a = self.prev_action_embedding(idx)
        if cfg.ablate_instruction:
            txt = txt * 0
        if cfg.ablate_depth:
            dep = dep * 0
        if cfg.ablate_rgb:
            rgb = rgb * 0
        rgb_kv = self.rgb_kv(rgb)
        dep_kv = self.depth_kv(dep)
        return CMAFeatures(
            txt=txt,
            text_mask=(txt == 0.0).all(dim=1),
            vis1_in=self.rgb_linear(rgb),
            vis2_in=self.depth_linear(dep),
            vis1_k=rgb_kv[:, :half],
            vis1_v=rgb_kv[:, half:],
            vis2_k=dep_kv[:, :half],
            vis2_v=dep_kv[:, half:],
            prev_a=prev_a,
        )

    def step(
        self,
        feats: CMAFeatures,
        rnn_states: torch.Tensor,  # (N, L, hidden)
        episode_masks: torch.Tensor,  # (N,)
        tour_masks=None,  # (N,) or None: the episode masks
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """latent_cma_policy.py:375-497. The memory is cleared by the tour
        mask; the new memory is max(memory, h1) without a gradient, and
        ``memory_at_end`` reads the cleared memory from before the max."""
        cfg = self.cfg
        scale = 1.0 / math.sqrt(self.half)
        if cfg.disable_tour_memory or tour_masks is None:
            tour_masks = episode_masks
        state_inputs = [feats.vis1_in, feats.vis2_in, feats.prev_a]
        memory = None
        if cfg.tour_memory_variant:
            memory = rnn_states[:, 2] * tour_masks.reshape(-1, 1)
            state_inputs.append(memory)
        h1 = self.state_encoder(
            torch.cat(state_inputs, 1), rnn_states[:, 0], episode_masks
        )
        text_embedding = attend(
            self.state_q(h1), self.text_k(feats.txt), feats.txt, scale,
            feats.text_mask,
        )
        text_q = self.text_q(text_embedding)
        v1_att = attend(text_q, feats.vis1_k, feats.vis1_v, scale)
        v2_att = attend(text_q, feats.vis2_k, feats.vis2_v, scale)
        x = torch.cat([h1, text_embedding, v1_att, v2_att, feats.prev_a], 1)
        x = self.second_state_compress(x)
        h2 = self.second_state_encoder(x, rnn_states[:, 1], episode_masks)
        x = h2
        slots = [h1, h2]
        if cfg.tour_memory_variant:
            slots.append(torch.maximum(memory, h1).detach())
        if cfg.memory_at_end:
            x = self.out_layer(torch.cat([x, memory], 1))
        return x, torch.stack(slots, dim=1)


def progress_monitor_loss(net: nn.Module, features: torch.Tensor,
                          progress: torch.Tensor) -> torch.Tensor:
    """Per-row squared error of tanh(progress head) against the progress
    sensor (map_cma_policy.py:355-366, JAX cma.py:523-530); the trainer
    reduces it over the rows with a positive inflection weight."""
    progress_hat = torch.tanh(net.progress_monitor(features))
    return (progress_hat[:, 0] - progress.reshape(-1).float()) ** 2
