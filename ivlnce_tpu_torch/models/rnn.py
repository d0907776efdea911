"""Recurrent pieces of the MapCMA path: the PyTorch counterpart of
``ivlnce_tpu/models/rnn.py``. Weight layouts are torch's own (GRU gates
[r, z, n], LSTM gates [i, f, g, o])."""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence


class RNNStateEncoder(nn.Module):
    """habitat's RNNStateEncoder for one GRU layer (module attribute
    ``rnn``, as in the reference checkpoints)."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.rnn = nn.GRU(input_size, hidden_size)

    def forward(
        self, x: torch.Tensor, h: torch.Tensor, masks: torch.Tensor
    ) -> torch.Tensor:
        """One step: ``masked_gru_step`` (ivlnce_tpu/models/rnn.py:89);
        the hidden state is multiplied by the not-done mask first."""
        h = (h * masks.reshape(-1, 1))[None].contiguous()
        out, _ = self.rnn(x[None], h)
        return out[0]

    def sequence(
        self, xs: torch.Tensor, h: torch.Tensor, masks: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The masked recurrence over (T, B, I) inputs and (T, B)
        not-done masks, h <- GRU(x_t, h * m_t) one step at a time
        (``gru_sequence``, ivlnce_tpu/models/rnn.py:97). Returns
        (outputs (T, B, H), h_T)."""
        outs = []
        for x, m in zip(xs, masks):
            h = self(x, h, m)
            outs.append(h)
        return torch.stack(outs), h


def bi_lstm_padded(
    lstm: nn.LSTM, xs: torch.Tensor, lengths: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bidirectional LSTM over padded (B, T, I) sequences:
    pack_padded_sequence -> LSTM -> pad_packed_sequence. Padded outputs are
    0. Returns (outputs (B, T, 2H), final hidden (B, 2H)); an empty row
    gives zeros."""
    b, t, _ = xs.shape
    packed = pack_padded_sequence(
        xs, lengths.clamp(min=1).cpu(), batch_first=True,
        enforce_sorted=False,
    )
    out, (h_n, _) = lstm(packed)
    out, _ = pad_packed_sequence(out, batch_first=True, total_length=t)
    empty = (lengths == 0).to(out.device)
    out = out.masked_fill(empty[:, None, None], 0.0)
    final = torch.cat([h_n[0], h_n[1]], dim=-1).masked_fill(
        empty[:, None], 0.0
    )
    return out, final
