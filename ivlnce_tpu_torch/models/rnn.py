"""Recurrent pieces of the MapCMA path: the PyTorch counterpart of
``ivlnce_tpu/models/rnn.py``. Weight layouts are torch's own (GRU gates
[r, z, n], LSTM gates [i, f, g, o]).

``nn.GRU`` and ``nn.LSTM`` (cuDNN on the card) run the recurrences. A
module that holds its weights split over a mesh's model devices
(``parallel/tensor.py``) computes the gate pre-activations ``gi`` and
``gh`` itself and runs the gate arithmetic here (``gru_gates``,
``lstm_gates``: JAX's ``gru_cell`` and ``lstm_cell``). The eval step's
instruction cache re-encodes the rows that changed with ``bi_lstm_rows``:
the plain recurrence on the CPU, one launch of the
``csrc/instruction_lstm.cu`` kernel on the card."""

from __future__ import annotations

import ctypes
from typing import Callable, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

from ivlnce_tpu_torch.utils import profiling


class RNNStateEncoder(nn.Module):
    """habitat's RNNStateEncoder for one GRU layer (module attribute
    ``rnn``, as in the reference checkpoints; a model-axis copy holds a
    ``parallel/tensor.py::GateSplitGRU`` there, with the GRU's call)."""

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


def gru_gates(gi: torch.Tensor, gh: torch.Tensor,
              h: torch.Tensor) -> torch.Tensor:
    """nn.GRU's update from ``gi = x W_ih^T + b_ih`` and ``gh = h W_hh^T +
    b_hh`` (3H each): the reset gate scales (W_hn h + b_hn) only."""
    i_r, i_z, i_n = gi.chunk(3, -1)
    h_r, h_z, h_n = gh.chunk(3, -1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1 - z) * n + z * h


def lstm_gates(gi: torch.Tensor, gh: torch.Tensor, c: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """nn.LSTM's update from the 4H pre-activations: (h, c)."""
    i, f, g, o = (gi + gh).chunk(4, -1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


LSTMStep = Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                    Tuple[torch.Tensor, torch.Tensor]]


def bi_lstm_cells(step_fwd: LSTMStep, step_bwd: LSTMStep, hidden: int,
                  xs: torch.Tensor, lengths: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``bi_lstm_padded`` one step at a time, from a cell per direction
    (``step(x, h, c) -> (h, c)``), as JAX's ``bi_lstm_padded`` runs it:
    the forward direction holds its state over padded steps; the backward
    one reads each row from t = len - 1 down to 0 (the row reversed within
    its own length); padded outputs are 0; the final hidden states are
    each row's own last steps'."""
    b, t, _ = xs.shape
    steps = torch.arange(t, device=xs.device)[None]
    lengths = lengths.to(xs.device)
    valid = steps < lengths[:, None]  # (B, T)

    def run(step, seq):
        h = c = xs.new_zeros((b, hidden))
        outs = []
        for i in range(t):
            h_new, c_new = step(seq[:, i], h, c)
            keep = valid[:, i, None]
            h = torch.where(keep, h_new, h)
            c = torch.where(keep, c_new, c)
            outs.append(torch.where(keep, h_new, torch.zeros_like(h_new)))
        return torch.stack(outs, 1), h

    out_f, h_f = run(step_fwd, xs)
    rev = (lengths[:, None] - 1 - steps).clamp(0, t - 1)  # (B, T)

    def reverse(a):
        return a.gather(1, rev[:, :, None].expand(-1, -1, a.shape[2]))

    out_b, h_b = run(step_bwd, reverse(xs))
    out_b = torch.where(valid[:, :, None], reverse(out_b),
                        torch.zeros_like(out_b))
    return torch.cat([out_f, out_b], -1), torch.cat([h_f, h_b], -1)


def bi_lstm_padded(
    lstm: nn.Module, xs: torch.Tensor, lengths: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bidirectional LSTM over padded (B, T, I) sequences:
    pack_padded_sequence -> LSTM -> pad_packed_sequence. Padded outputs are
    0. Returns (outputs (B, T, 2H), final hidden (B, 2H)); an empty row
    gives zeros. An LSTM split over model devices
    (``parallel/tensor.py``) runs its own cells (``padded``)."""
    if not isinstance(lstm, nn.LSTM):
        return lstm.padded(xs, lengths)
    b, t, _ = xs.shape
    with profiling.span("device_sync"):
        host_lengths = lengths.clamp(min=1).cpu()
    packed = pack_padded_sequence(
        xs, host_lengths, batch_first=True, enforce_sorted=False,
    )
    out, (h_n, _) = lstm(packed)
    out, _ = pad_packed_sequence(out, batch_first=True, total_length=t)
    empty = (lengths == 0).to(out.device)
    out = out.masked_fill(empty[:, None, None], 0.0)
    final = torch.cat([h_n[0], h_n[1]], dim=-1).masked_fill(
        empty[:, None], 0.0
    )
    return out, final


class LaunchCounter:
    """Launches of the ``bi_lstm_rows`` kernel; the plain version never
    counts."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.bi_lstm_rows = 0


launches = LaunchCounter()


def _check_rows(gates: torch.Tensor, index: torch.Tensor,
                w_hh_t: torch.Tensor, lengths: torch.Tensor,
                rows: torch.Tensor, out: torch.Tensor) -> None:
    h = w_hh_t.shape[1]
    k, tg = index.shape
    if (w_hh_t.shape != (2, h, 4 * h) or gates.ndim != 2
            or gates.shape[1] != 8 * h or out.ndim != 3
            or out.shape[2] != 2 * h or tg > out.shape[1]):
        raise ValueError(f"bi_lstm_rows: gates {tuple(gates.shape)}, index "
                         f"{tuple(index.shape)}, w_hh_t "
                         f"{tuple(w_hh_t.shape)}, out {tuple(out.shape)}")
    for name, t, dtype in (("gates", gates, torch.float32),
                           ("index", index, torch.int64),
                           ("w_hh_t", w_hh_t, torch.float32),
                           ("lengths", lengths, torch.int64),
                           ("rows", rows, torch.int64),
                           ("out", out, torch.float32)):
        if t.dtype != dtype:
            raise TypeError(f"bi_lstm_rows: {name} {t.dtype}, not {dtype}")
        if t.device != out.device:
            raise ValueError(f"bi_lstm_rows: {name} on {t.device}, out on "
                             f"{out.device}")
        if not t.is_contiguous():
            raise ValueError(f"bi_lstm_rows: {name} must be contiguous")
    if lengths.shape != (k,) or rows.shape != (k,):
        raise ValueError(f"bi_lstm_rows: lengths {tuple(lengths.shape)}, "
                         f"rows {tuple(rows.shape)} for {k} rows")


def bi_lstm_rows_plain(gates: torch.Tensor, index: torch.Tensor,
                       w_hh_t: torch.Tensor, lengths: torch.Tensor,
                       rows: torch.Tensor, out: torch.Tensor) -> None:
    """``bi_lstm_rows`` one step at a time (``bi_lstm_cells`` with
    ``lstm_gates``), on any device."""
    hidden = w_hh_t.shape[1]
    g = 4 * hidden
    if index.shape[1] == 0:  # every row empty
        out.index_fill_(0, rows, 0.0)
        return

    def cell(w: torch.Tensor, lo: int) -> LSTMStep:
        def step(x, h, c):
            return lstm_gates(x[:, lo:lo + g], torch.matmul(h, w), c)
        return step

    feats, _ = bi_lstm_cells(cell(w_hh_t[0], 0), cell(w_hh_t[1], g),
                             hidden, gates[index], lengths)
    out.index_copy_(0, rows, F.pad(feats, (0, 0, 0, out.shape[1]
                                             - feats.shape[1])))


def bi_lstm_rows(gates: torch.Tensor, index: torch.Tensor,
                 w_hh_t: torch.Tensor, lengths: torch.Tensor,
                 rows: torch.Tensor, out: torch.Tensor) -> None:
    """Rows ``rows`` of ``out`` (B, T, 2H), in place, as
    ``bi_lstm_padded``'s outputs for those rows: the forward direction over
    t < len, the backward one from each row's own last token down, zeros
    at t >= len and for an empty row. Row r's input pre-activations at
    step t are ``gates[index[r, t]]``: ``gates`` (V, 8H) holds
    ``x W_ih^T + b_ih + b_hh``, the forward direction's 4H gates then the
    backward one's, ``index`` (k, Tg), Tg <= T; ``w_hh_t`` (2, H, 4H): each
    direction's W_hh transposed; ``lengths`` and ``rows`` (k,); every
    index int64. CPU tensors run the plain version, CUDA tensors one
    launch of the kernel."""
    _check_rows(gates, index, w_hh_t, lengths, rows, out)
    dev = out.device
    if dev.type == "cpu":
        bi_lstm_rows_plain(gates, index, w_hh_t, lengths, rows, out)
        return
    if dev.type != "cuda":
        raise ValueError(f"bi_lstm_rows: unsupported device {dev}")
    from ivlnce_tpu_torch.ops import kernels
    from ivlnce_tpu_torch.ops.scatter import stream_arg

    lib = kernels.lstm_library()
    k, tg = index.shape
    ptr = [ctypes.c_void_p(t.data_ptr())
           for t in (gates, index, w_hh_t, lengths, rows, out)]
    with torch.cuda.device(dev):
        err = lib.instruction_lstm_rows(*ptr, k, tg, out.shape[1],
                                        w_hh_t.shape[1], stream_arg(dev))
    launches.bi_lstm_rows += 1
    kernels.check(err, "instruction_lstm_rows")
