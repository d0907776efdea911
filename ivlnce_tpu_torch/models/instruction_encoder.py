"""Instruction encoder: the PyTorch counterpart of
``ivlnce_tpu/models/instruction_encoder.py`` (reference
instruction_encoder.py). Embedding (PAD = 0) -> bi-LSTM -> per-token
features (B, 2H, T) with padded positions zeroed. With ``sensor_uuid``
``rxr_instruction`` there is no embedding: the bi-LSTM reads RxR's
precomputed (T, embedding_size) features, and a row's length is the
number of feature rows with any non-zero entry.

``InstructionCache`` is the eval step's per-episode cache: its
``RowEncoder`` writes the features of the rows that changed into a
persistent (B, T, 2H) tensor in place (``models/rnn.py::bi_lstm_rows``),
from lengths counted on the host and sent with the changed rows' tokens
through the step's upload (``utils/upload.py``). ``forward`` (the IL
update, with autograd) keeps ``bi_lstm_padded``."""

from __future__ import annotations

import gzip
import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ivlnce_tpu_torch.models.rnn import bi_lstm_padded, bi_lstm_rows
from ivlnce_tpu_torch.utils import profiling, upload as U


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
            # the per-episode cache (InstructionCache)
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


class RowEncoder:
    """``InstructionEncoder``'s per-token features for some rows of a
    persistent (B, T, 2H) tensor, written in place by one launch
    (``models/rnn.py::bi_lstm_rows``), from the encoder's weights as they
    are when it is made: every token's input pre-activations of both
    directions in one (vocab, 8H) table (RxR's features keep W_ih and the
    biases for one matrix product per call) and each direction's W_hh laid
    out [H][4H]."""

    def __init__(self, encoder: InstructionEncoder):
        lstm = encoder.encoder_rnn
        self.w_ih = torch.cat([lstm.weight_ih_l0, lstm.weight_ih_l0_reverse])
        self.bias = torch.cat([
            lstm.bias_ih_l0 + lstm.bias_hh_l0,
            lstm.bias_ih_l0_reverse + lstm.bias_hh_l0_reverse])
        self.table = None
        if encoder.embedding_layer is not None:
            self.table = torch.addmm(self.bias,
                                     encoder.embedding_layer.weight,
                                     self.w_ih.t())
        self.w_hh_t = torch.stack([lstm.weight_hh_l0.t(),
                                   lstm.weight_hh_l0_reverse.t()])

    def __call__(self, inputs: np.ndarray, rows: np.ndarray,
                 out: torch.Tensor,
                 upload: Optional[U.Upload] = None) -> None:
        """Rows ``rows`` of ``out`` as ``forward``'s (permuted) features of
        the host ``inputs``: (k, T) tokens, or (k, T, F) RxR features. The
        lengths are counted here, as ``forward`` counts them, and the
        inputs are cut to the longest before they are uploaded in one
        ``upload`` call (a ``utils/upload.py::StagedUpload``; by default
        ``upload.blocking_to``): nothing is read back from the card."""
        rxr = self.table is None
        nonzero = inputs != 0
        lengths = (nonzero.any(2) if rxr else nonzero).sum(1)
        k, tg = len(inputs), int(lengths.max())
        cut = np.ascontiguousarray(inputs[:, :tg])
        if rxr:  # the features' gates, one row per step, read in order
            index = np.arange(k * tg)
        elif cut.size and not 0 <= cut.min() <= cut.max() < len(self.table):
            raise ValueError(f"instruction tokens outside the vocabulary of "
                             f"{len(self.table)}")
        else:
            index = cut
        upload = upload or U.blocking_to(out.device)
        with profiling.span("upload"):
            host = {"ints": np.concatenate(
                [index.reshape(-1), rows, lengths]).astype(np.int64)}
            if rxr:
                host["cut"] = cut
            got = upload(host)
        ints = got["ints"]
        gates = got["cut"] if rxr else self.table
        if rxr:
            gates = torch.addmm(self.bias,
                                gates.reshape(k * tg, inputs.shape[2]).float(),
                                self.w_ih.t())
        n = k * tg
        bi_lstm_rows(gates, ints[:n].view(k, tg), self.w_hh_t,
                     lengths=ints[n + k:], rows=ints[n:n + k], out=out)


class InstructionCache:
    """The eval step's instruction features, encoded once per episode: only
    the rows whose host tokens (or RxR features) changed are re-encoded, in
    place, into a persistent (B, T, 2H) tensor read as (B, 2H, T). Every
    row is, with a new ``RowEncoder``, on the first call, a new shape or
    lane count, and after ``clear`` (call it when the weights change)."""

    def __init__(self, encoder: InstructionEncoder):
        self.encoder = encoder
        self.tokens: Optional[np.ndarray] = None  # the host rows encoded
        self._store = self._encode = None  # (B, T, 2H), its RowEncoder

    def clear(self) -> None:
        self.tokens = None

    def __call__(self, inputs, upload: U.Upload
                 ) -> Tuple[torch.Tensor, int]:
        """The features of host (B, T) tokens or (B, T, F) features, and
        the rows encoded, sent through ``upload``; no read from the card."""
        with profiling.span("instruction_cache"):
            tokens = np.asarray(inputs)
            rows = len(tokens)
            if self.tokens is None or self.tokens.shape != tokens.shape:
                changed = np.arange(rows)
                self._store = torch.empty(
                    (rows, tokens.shape[1], output_size(self.encoder.config)),
                    dtype=torch.float32,
                    device=next(self.encoder.parameters()).device)
                self._encode = RowEncoder(self.encoder)
            else:
                changed = np.flatnonzero(
                    (self.tokens != tokens).reshape(rows, -1).any(1))
            if len(changed):
                with profiling.span("instruction_encoder"):
                    self._encode(tokens[changed], changed, self._store,
                                 upload)
                self.tokens = tokens.copy()
                profiling.count("instruction_rows_encoded", len(changed))
                profiling.count("instruction_rows_changed", len(changed))
        return self._store.permute(0, 2, 1), len(changed)
