"""Operation and byte counts, from shapes alone, and the card's peaks.

Operations are float32 multiply-adds counted twice, of every convolution,
linear layer, recurrent cell and attention the model's definition needs
for the work done: the instruction bi-LSTM once per episode in an eval
lane (once per row in training, as the model defines it), the encoders
once per frame. What the program does beyond that (re-encoding
instructions that did not change, padded rows) is not counted, so a
share of a peak says how much of the card the needed work used.

Bytes are those a kernel must move at least: each input read once, each
output written once, for the inputs the step had."""

from __future__ import annotations

from typing import Dict, List, Tuple

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
PEAK_FP32_FLOPS = 67e12  # float32 outside the tensor cores (TF32 is off)
PEAK_HBM_BYTES_PER_S = 3.35e12

Conv = Tuple[int, int, int, int, int]  # out side, cout, cin, k, stride


def _convs_resnet(side: int, cin: int, base: int, stem_k: int = 7
                  ) -> Tuple[List[Conv], int, int]:
    """The convolutions of a bottleneck ResNet-50 (expansion 4) on a
    ``side`` square input of ``cin`` channels, with ``base`` planes in
    its first stage; returns (convs, out side, out channels)."""
    convs = []
    s = (side + 2 * 3 - stem_k) // 2 + 1
    convs.append((s, base, cin, stem_k, 2))
    s = (s + 2 - 3) // 2 + 1  # max pool 3, stride 2, pad 1
    inplanes = base
    for stage, blocks in enumerate((3, 4, 6, 3)):
        planes = base * 2 ** stage
        for b in range(blocks):
            stride = 2 if (stage > 0 and b == 0) else 1
            out = (s - 1) // stride + 1
            convs.append((s, planes, inplanes, 1, 1))
            convs.append((out, planes, planes, 3, stride))
            convs.append((out, planes * 4, planes, 1, 1))
            if b == 0:
                convs.append((out, planes * 4, inplanes, 1, stride))
            inplanes = planes * 4
            s = out
    return convs, s, inplanes


def _macs(convs: List[Conv]) -> int:
    return sum(side * side * cout * cin * k * k
               for side, cout, cin, k, _ in convs)


def depth_encoder(side: int) -> Dict[str, int]:
    """The DDPPO GroupNorm ResNet-50 on a ``side`` depth frame (pooled by
    2 inside) with its 3x3 compression: FLOPs and output shape."""
    convs, s, c = _convs_resnet(side // 2, 1, 32)
    comp = int(round(2048 / (s * s)))
    convs.append((s, comp, c, 3, 1))
    return {"flops": 2 * _macs(convs), "channels": comp + 64, "side": s}


def rgb_encoder(side: int) -> Dict[str, int]:
    """torchvision's ResNet-50 trunk on a ``side`` RGB frame."""
    convs, s, c = _convs_resnet(side, 3, 64)
    return {"flops": 2 * _macs(convs), "channels": c + 64, "side": 4}


def map_encoder(side: int, classes: int, ch: int, mult: int) -> Dict[str, int]:
    """Four 7x7 conv blocks, each followed by a 2x2 pool."""
    widths = [ch, ch * 2, ch * 4, ch * mult]
    macs, cin, s = 0, 1 + classes, side
    for w in widths:
        macs += s * s * w * cin * 49
        cin, s = w, s // 2
    return {"flops": 2 * macs, "channels": widths[-1], "side": s}


def lstm_flops(tokens: int, inp: int, hidden: int, directions: int = 2) -> int:
    """A (bi)directional LSTM over ``tokens`` tokens."""
    return 2 * directions * tokens * 4 * hidden * (inp + hidden)


def gru_flops(inp: int, hidden: int) -> int:
    return 2 * 3 * hidden * (inp + hidden)


def step_flops(kind: str, w: Dict) -> int:
    """One lane's recurrent step and the layers between the encoders and
    it: projections, the two GRUs, three attentions, the action head.
    ``w`` holds the configuration's widths."""
    hidden = w["hidden_size"]
    half = hidden // 2
    instr = 2 * w["instruction_hidden"]
    tokens = w["max_length"]
    d = depth_encoder(w["depth_side"])
    d_in, d_cells = d["channels"], d["side"] ** 2
    d_out = w["depth_output"]
    if kind == "map":
        m = map_encoder(w["map_side"], w["map_classes"], w["map_channels"],
                        w["map_last_ch_mult"])
        o_in, o_cells, o_out = m["channels"], m["side"] ** 2, w["map_output"]
        o_linear = o_in * o_cells * o_out
    else:
        r = rgb_encoder(w["rgb_side"])
        o_in, o_cells, o_out = r["channels"], 16, w["rgb_output"]
        o_linear = o_in * o_out
    macs = (d_in * d_cells * d_out + o_linear  # the two input layers
            + d_in * (half + d_out) * d_cells  # key/value projections
            + o_in * (half + o_out) * o_cells
            + hidden * half  # state query
            + instr * half * tokens  # instruction keys at every token
            + (half + instr) * tokens  # attention over the instruction
            + instr * half  # instruction query
            + (half + d_out) * d_cells + (half + o_out) * o_cells
            + (hidden + d_out + instr + o_out + 32) * hidden  # compress
            + hidden * 4)  # action head
    gru_in = d_out + o_out + 32 + (hidden if w.get("tour_memory") else 0)
    flops = 2 * macs + gru_flops(gru_in, hidden) + gru_flops(hidden, hidden)
    if w.get("memory_at_end"):
        flops += 2 * 2 * hidden * hidden
    return flops


def eval_lane_step_flops(kind: str, w: Dict) -> int:
    """One lane's policy step without the instruction encode: the depth
    encoder, the map or RGB encoder, the step."""
    f = depth_encoder(w["depth_side"])["flops"] + step_flops(kind, w)
    if kind == "map":
        f += map_encoder(w["map_side"], w["map_classes"], w["map_channels"],
                         w["map_last_ch_mult"])["flops"]
    else:
        f += rgb_encoder(w["rgb_side"])["flops"]
    return f


def instruction_flops(tokens: int, w: Dict) -> int:
    """The instruction bi-LSTM over one instruction of ``tokens``."""
    return lstm_flops(tokens, w["embedding_size"], w["instruction_hidden"])


def train_row_flops(w: Dict, instruction_tokens: float) -> int:
    """One valid row of the MapCMA update from stored depth features: the
    forward of the map encoder, the instruction encode of the row, the
    step, three times (forward and backward), and the map encoder's
    forward again for its BatchNorm statistics."""
    m = map_encoder(w["map_side"], w["map_classes"], w["map_channels"],
                    w["map_last_ch_mult"])["flops"]
    fwd = (m + step_flops("map", w)
           + lstm_flops(1, w["embedding_size"], w["instruction_hidden"])
           * instruction_tokens + 2 * w["hidden_size"])  # progress head
    return int(3 * fwd + m)


def mapper_bytes(pixels: int, touched_cells: int, lanes: int, window: int,
                 map_side: int) -> Dict[str, int]:
    """Least bytes of one mapper step: K1 reads each pixel's depth
    (float32) and label once and each touched grid cell's 8-byte word
    once; K2 reads each raster window cell's word once and writes both
    maps. The payload of cells a point wins and of points in the height
    window is left out, so the bound is low and a share of it is a floor."""
    k1 = pixels * 5 + touched_cells * 8
    k2 = lanes * window * window * 8 + 2 * lanes * map_side * map_side
    return {"accumulate": k1, "rasterize": k2}


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: operations over the float32
    peak or bytes over the memory bandwidth, the larger."""
    return max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S)
