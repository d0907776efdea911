"""Instruction encoder: the PyTorch counterpart of
``ivlnce_tpu/models/instruction_encoder.py`` (reference
instruction_encoder.py). Embedding (PAD = 0) -> bi-LSTM -> per-token
features (B, 2H, T) with padded positions zeroed. With ``sensor_uuid``
``rxr_instruction`` there is no embedding: the bi-LSTM reads RxR's
precomputed (T, embedding_size) features, and a row's length is the
number of feature rows with any non-zero entry."""

from __future__ import annotations

import gzip
import json
import os
from typing import Dict

import numpy as np
import torch
from torch import nn

from ivlnce_tpu_torch.models.rnn import bi_lstm_padded


def load_embeddings(embedding_file: str) -> np.ndarray:
    with gzip.open(embedding_file, "rt") as f:
        return np.asarray(json.load(f), dtype=np.float32)


def output_size(config) -> int:
    return config.hidden_size * (1 + int(config.bidirectional))


class InstructionEncoder(nn.Module):
    def __init__(self, config):
        super().__init__()
        if config.rnn_type != "LSTM":
            raise ValueError("the instruction encoder is an LSTM")
        self.config = config
        if config.sensor_uuid != "instruction":
            self.embedding_layer = None
        elif config.use_pretrained_embeddings and os.path.exists(
            config.embedding_file
        ):
            weights = torch.from_numpy(load_embeddings(config.embedding_file))
            self.embedding_layer = nn.Embedding.from_pretrained(
                weights, freeze=True, padding_idx=0
            )
        else:
            self.embedding_layer = nn.Embedding(
                config.vocab_size, config.embedding_size, padding_idx=0
            )
        self.encoder_rnn = nn.LSTM(
            config.embedding_size, config.hidden_size,
            bidirectional=config.bidirectional, batch_first=True,
        )

    def forward(self, observations: Dict[str, torch.Tensor]) -> torch.Tensor:
        if "instruction_features" in observations:
            # per-episode cache (trainers/base_trainer.py)
            return observations["instruction_features"]
        if self.embedding_layer is None:
            embedded = observations["rxr_instruction"].float()
            lengths = (embedded != 0).any(dim=2).sum(dim=1)
        else:
            tokens = observations["instruction"].long()
            lengths = (tokens != 0).sum(dim=1)
            embedded = self.embedding_layer(tokens)
        outputs, final = bi_lstm_padded(self.encoder_rnn, embedded, lengths)
        if self.config.final_state_only:
            return final
        return outputs.permute(0, 2, 1)
