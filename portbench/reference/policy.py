"""Plain forward passes of the two CMA policies, frozen with the
benchmark: functions of a dict of weights named as the policies' state
dicts name them, in float32 torch operations, with no kernels, caches or
batching of the program.

- Depth: habitat's DDPPO ResNet-50 with GroupNorm (16 groups, 32 base
  planes) on the depth frame average-pooled by 2, a 3x3 compression to
  2048 / cells channels with GroupNorm(1), and a learned embedding of the
  spatial cells stacked on the channels.
- RGB: torchvision's BatchNorm ResNet-50 (conv1 .. layer4, frozen
  statistics) on uint8 / 255, adaptive average pool to 4x4, and a learned
  16-cell embedding.
- Map: four blocks of 7x7 conv, BatchNorm, ReLU, 2x2 average pool over
  one occupancy and 13 one-hot label channels.
- Instruction: an embedding (index 0 is padding) and a bidirectional LSTM
  over each row's own length; padded positions give zeros.
- CMA step: GRU 1 over the visual features and the previous-action
  embedding, attention of its state over the instruction, attention of
  the instruction summary over each visual stream, GRU 2 over all of it.
  LatentCMA's ``tour_memory_variant`` feeds a tour memory to GRU 1 and
  keeps max(memory, h1) as the new memory; ``memory_at_end`` reads the
  memory after GRU 2."""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

RESNET50 = (3, 4, 6, 3)


def _gn_block(w, p, x, stride, down):
    out = F.conv2d(x, w[p + "convs.0.weight"])
    out = F.relu(F.group_norm(out, 16, w[p + "convs.1.weight"],
                              w[p + "convs.1.bias"]))
    out = F.conv2d(out, w[p + "convs.3.weight"], stride=stride, padding=1)
    out = F.relu(F.group_norm(out, 16, w[p + "convs.4.weight"],
                              w[p + "convs.4.bias"]))
    out = F.conv2d(out, w[p + "convs.6.weight"])
    out = F.group_norm(out, 16, w[p + "convs.7.weight"], w[p + "convs.7.bias"])
    if down:
        x = F.conv2d(x, w[p + "downsample.0.weight"], stride=stride)
        x = F.group_norm(x, 16, w[p + "downsample.1.weight"],
                         w[p + "downsample.1.bias"])
    return F.relu(out + x)


def depth_encoder(w: Dict, depth: torch.Tensor,
                  prefix: str = "net.depth_encoder.") -> torch.Tensor:
    """(B, H, W) depth in [0, 1] -> (B, C + 64, h, w)."""
    p = prefix + "visual_encoder."
    x = F.avg_pool2d(depth[:, None], 2)
    b = p + "backbone."
    x = F.conv2d(x, w[b + "conv1.0.weight"], stride=2, padding=3)
    x = F.relu(F.group_norm(x, 16, w[b + "conv1.1.weight"],
                            w[b + "conv1.1.bias"]))
    x = F.max_pool2d(x, 3, 2, 1)
    for si, blocks in enumerate(RESNET50):
        for bi in range(blocks):
            key = f"{b}layer{si + 1}.{bi}."
            stride = 2 if (si > 0 and bi == 0) else 1
            x = _gn_block(w, key, x, stride, bi == 0)
    x = F.conv2d(x, w[p + "compression.0.weight"], padding=1)
    x = F.relu(F.group_norm(x, 1, w[p + "compression.1.weight"],
                            w[p + "compression.1.bias"]))
    emb = w[prefix + "spatial_embeddings.weight"]
    n, _, h, ww = x.shape
    return torch.cat([x, emb.t().reshape(1, -1, h, ww).expand(n, -1, h, ww)],
                     1)


def _bn(w, p, x):
    return F.batch_norm(x, w[p + "running_mean"], w[p + "running_var"],
                        w[p + "weight"], w[p + "bias"], False, 0.0, 1e-5)


def rgb_encoder(w: Dict, rgb: torch.Tensor,
                prefix: str = "net.rgb_encoder.") -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, 2048 + 64, 4, 4)."""
    c = prefix + "cnn."
    x = rgb.permute(0, 3, 1, 2).float() / 255.0
    x = F.relu(_bn(w, c + "1.", F.conv2d(x, w[c + "0.weight"], stride=2,
                                         padding=3)))
    x = F.max_pool2d(x, 3, 2, 1)
    for si, blocks in enumerate(RESNET50):
        for bi in range(blocks):
            p = f"{c}{4 + si}.{bi}."
            stride = 2 if (si > 0 and bi == 0) else 1
            out = F.relu(_bn(w, p + "bn1.",
                             F.conv2d(x, w[p + "conv1.weight"])))
            out = F.relu(_bn(w, p + "bn2.", F.conv2d(
                out, w[p + "conv2.weight"], stride=stride, padding=1)))
            out = _bn(w, p + "bn3.", F.conv2d(out, w[p + "conv3.weight"]))
            if bi == 0:
                x = _bn(w, p + "downsample.1.", F.conv2d(
                    x, w[p + "downsample.0.weight"], stride=stride))
            x = F.relu(out + x)
    x = F.adaptive_avg_pool2d(x, 4)
    emb = w[prefix + "spatial_embeddings.weight"]
    n = x.shape[0]
    return torch.cat([x, emb.t().reshape(1, -1, 4, 4).expand(n, -1, 4, 4)], 1)


def map_inputs(occupancy, semantic, classes: int = 13):
    # a label beyond the classes gives an all-zero row
    sem = F.one_hot(semantic.long().clamp(max=classes),
                    classes + 1)[..., :classes]
    return torch.cat([occupancy.float()[:, None],
                      sem.float().permute(0, 3, 1, 2)], 1)


def map_encoder(w: Dict, occupancy, semantic, training: bool = False,
                prefix: str = "net.map_encoder.") -> torch.Tensor:
    """(B, R, C) uint8 maps -> (B, C_out, R / 16, C / 16); ``training``
    normalises each block with the batch's statistics (biased variance)."""
    x = map_inputs(occupancy, semantic)
    for i in range(4):
        p = f"{prefix}cnn.{i}.conv."
        pre = F.conv2d(x, w[p + "0.weight"], w[p + "0.bias"], padding=3)
        if training:
            dims = (0, 2, 3)
            mean = pre.mean(dims, keepdim=True)
            var = ((pre - mean) ** 2).mean(dims, keepdim=True)
            y = (pre - mean) / torch.sqrt(var + 1e-5)
            y = y * w[p + "1.weight"][None, :, None, None] + \
                w[p + "1.bias"][None, :, None, None]
        else:
            y = _bn(w, p + "1.", pre)
        x = F.avg_pool2d(F.relu(y), 2)
    return x


def map_running_stats(w: Dict, occupancy, semantic, momentum: float = 0.1,
                      prefix: str = "net.map_encoder."
                      ) -> Dict[str, torch.Tensor]:
    """The map encoder's running statistics after one update over a
    batch: per block, the unbiased variance and the mean of its conv
    output, block by block with batch-normalised outputs feeding the next;
    running = (1 - momentum) * running + momentum * batch."""
    out = {}
    x = map_inputs(occupancy, semantic)
    for i in range(4):
        p = f"{prefix}cnn.{i}.conv."
        pre = F.conv2d(x, w[p + "0.weight"], w[p + "0.bias"], padding=3)
        n = pre.numel() // pre.shape[1]
        pre64 = pre.double()  # the statistics in float64
        mean64 = pre64.mean((0, 2, 3))
        var64 = ((pre64 - mean64[None, :, None, None]) ** 2).mean((0, 2, 3))
        mean, var_b = mean64.float(), var64.float()
        out[p + "1.running_mean"] = ((1 - momentum) * w[p + "1.running_mean"]
                                     + momentum * mean)
        out[p + "1.running_var"] = ((1 - momentum) * w[p + "1.running_var"]
                                    + momentum * (var64 * n / (n - 1)).float())
        y = (pre - mean[None, :, None, None]) / torch.sqrt(
            var_b[None, :, None, None] + 1e-5)
        y = y * w[p + "1.weight"][None, :, None, None] + \
            w[p + "1.bias"][None, :, None, None]
        x = F.avg_pool2d(F.relu(y), 2)
    return out


def _lstm_dir(w, sfx, xs, lengths, reverse):
    """One direction of the instruction LSTM over (B, T, E) with per-row
    lengths; returns (B, T, H) outputs, zero beyond each row's length."""
    p = "net.instruction_encoder.encoder_rnn."
    wi, wh = w[p + "weight_ih_l0" + sfx], w[p + "weight_hh_l0" + sfx]
    bias = w[p + "bias_ih_l0" + sfx] + w[p + "bias_hh_l0" + sfx]
    b, t, _ = xs.shape
    hidden = wh.shape[1]
    gi = xs @ wi.t() + bias
    h = xs.new_zeros(b, hidden)
    c = xs.new_zeros(b, hidden)
    outs = [None] * t
    steps = range(t - 1, -1, -1) if reverse else range(t)
    for i in steps:
        live = (i < lengths)[:, None]
        g = gi[:, i] + h @ wh.t()
        gi_, gf, gg, go = g.chunk(4, 1)
        c_new = torch.sigmoid(gf) * c + torch.sigmoid(gi_) * torch.tanh(gg)
        h_new = torch.sigmoid(go) * torch.tanh(c_new)
        c = torch.where(live, c_new, c)
        h = torch.where(live, h_new, h)
        outs[i] = torch.where(live, h_new, torch.zeros_like(h_new))
    return torch.stack(outs, 1)


def instruction_encoder(w: Dict, tokens: torch.Tensor) -> torch.Tensor:
    """(B, L) tokens, 0 padding -> (B, 2H, L) per-token features."""
    lengths = (tokens != 0).sum(1)
    table = w["net.instruction_encoder.embedding_layer.weight"]
    emb = F.embedding(tokens, table, padding_idx=0)
    t = int(lengths.max())
    xs = emb[:, :t]
    fwd = _lstm_dir(w, "", xs, lengths, False)
    # the backward direction runs over each row's own tokens from its last
    # one: a run from the padded end holds the zero state over the padding
    bwd = _lstm_dir(w, "_reverse", xs, lengths, True)
    out = torch.cat([fwd, bwd], -1)
    full = out.new_zeros(tokens.shape[0], tokens.shape[1], out.shape[2])
    full[:, :t] = out
    return full.permute(0, 2, 1)


def gru(w, p, x, h, mask):
    """One GRU step with its state multiplied by the not-done mask."""
    h = h * mask[:, None]
    gi = x @ w[p + "weight_ih_l0"].t() + w[p + "bias_ih_l0"]
    gh = h @ w[p + "weight_hh_l0"].t() + w[p + "bias_hh_l0"]
    ir, iz, inn = gi.chunk(3, 1)
    hr, hz, hn = gh.chunk(3, 1)
    r = torch.sigmoid(ir + hr)
    z = torch.sigmoid(iz + hz)
    n = torch.tanh(inn + r * hn)
    return (1 - z) * n + z * h


def linear(w, p, x):
    return x @ w[p + "weight"].t() + w[p + "bias"]


def conv1x1(w, p, x):
    """(B, C, I) -> (B, O, I)."""
    return torch.einsum("oc,bci->boi", w[p + "weight"][:, :, 0], x) + \
        w[p + "bias"][None, :, None]


def attention(q, k, v, scale, mask=None):
    logits = torch.einsum("bc,bci->bi", q, k)
    if mask is not None:
        logits = logits - mask.float() * 1e8
    a = torch.softmax(logits * scale, 1)
    return torch.einsum("bci,bi->bc", v, a)


def visual_features(w: Dict, kind: str, vis: Dict) -> Tuple:
    """Per-frame features of one family: (vis1_in, vis2_in, k1, v1, k2,
    v2) from ``vis``, which holds ``depth`` (B, C, h, w) depth-encoder
    features and ``map`` (MapCMA) or ``rgb`` (LatentCMA) encoder
    features."""
    n = "net."
    hidden = w[n + "state_q.weight"].shape[1]
    half = hidden // 2
    dep = vis["depth"].flatten(2)
    if kind == "map":
        other = vis["map"].flatten(2)
        v1_in = F.relu(linear(w, n + "depth_linear.1.", dep.flatten(1)))
        v2_in = F.relu(linear(w, n + "map_linear.1.", other.flatten(1)))
        kv1 = conv1x1(w, n + "dep_kv.", dep)
        kv2 = conv1x1(w, n + "map_kv.", other)
    else:
        rgb = vis["rgb"].flatten(2)
        v1_in = F.relu(linear(w, n + "rgb_linear.2.", rgb.mean(2)))
        v2_in = F.relu(linear(w, n + "depth_linear.1.", dep.flatten(1)))
        kv1 = conv1x1(w, n + "rgb_kv.", rgb)
        kv2 = conv1x1(w, n + "depth_kv.", dep)
    return (v1_in, v2_in, kv1[:, :half], kv1[:, half:], kv2[:, :half],
            kv2[:, half:])


def cma_step(w: Dict, kind: str, feats: Tuple, txt: torch.Tensor,
             prev_idx: torch.Tensor, rnn: torch.Tensor,
             episode_mask: torch.Tensor,
             tour_mask: Optional[torch.Tensor] = None,
             memory_variant: bool = False, memory_at_end: bool = False):
    """One recurrent step: returns (features (B, H), new rnn (B, L, H))."""
    n = "net."
    v1_in, v2_in, k1, v1, k2, v2 = feats
    hidden = w[n + "state_q.weight"].shape[1]
    scale = 1.0 / math.sqrt(hidden // 2)
    prev_a = F.embedding(prev_idx, w[n + "prev_action_embedding.weight"])
    inputs = [v1_in, v2_in, prev_a]
    memory = None
    if memory_variant:
        tm = episode_mask if tour_mask is None else tour_mask
        memory = rnn[:, 2] * tm[:, None]
        inputs.append(memory)
    h1 = gru(w, n + "state_encoder.rnn.", torch.cat(inputs, 1), rnn[:, 0],
             episode_mask)
    text_mask = (txt == 0.0).all(1)
    text = attention(linear(w, n + "state_q.", h1),
                     conv1x1(w, n + "text_k.", txt), txt, scale, text_mask)
    tq = linear(w, n + "text_q.", text)
    a1 = attention(tq, k1, v1, scale)
    a2 = attention(tq, k2, v2, scale)
    x = F.relu(linear(w, n + "second_state_compress.0.",
                      torch.cat([h1, text, a1, a2, prev_a], 1)))
    h2 = gru(w, n + "second_state_encoder.rnn.", x, rnn[:, 1], episode_mask)
    slots = [h1, h2]
    out = h2
    if memory_variant:
        slots.append(torch.maximum(memory, h1).detach())
    if memory_at_end:
        out = F.relu(linear(w, n + "out_layer.0.", torch.cat([h2, memory], 1)))
    return out, torch.stack(slots, 1)


def action_logits(w: Dict, features: torch.Tensor) -> torch.Tensor:
    return linear(w, "action_distribution.linear.", features)


def progress(w: Dict, features: torch.Tensor) -> torch.Tensor:
    return torch.tanh(linear(w, "net.progress_monitor.", features))[:, 0]
