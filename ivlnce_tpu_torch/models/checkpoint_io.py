"""The name table between the JAX package's parameter trees and the
reference (torch) module names, from ``ivlnce_tpu/models/checkpoint_io.py``.
The port's modules carry the reference names, so a tree converts to a
``state_dict`` by these renames (``models/convert.py``)."""

from __future__ import annotations

# habitat's RNNStateEncoder wraps the GRU in an ``.rnn`` attribute
RNN_WRAPPED = ("state_encoder", "second_state_encoder")

# kernel-size-1 Conv1d attention projections: torch stores (out, in, 1),
# the JAX package (out, in)
CONV1D_KEYS = ("dep_kv", "map_kv", "rgb_kv", "depth_kv", "text_k")

# instruction encoder submodules: JAX name -> reference name
INSTRUCTION_RENAMES = {
    "embedding": "embedding_layer",
    "lstm_fwd": "encoder_rnn",
    "lstm_bwd": "encoder_rnn",  # the reverse direction (``_reverse``)
}

# the RGB trunk: the JAX package's torchvision stage names -> the
# reference's positions in ``rgb_encoder.cnn``, Sequential(*resnet
# .children()) (resnet_encoders.py:139; 2 relu and 3 maxpool hold no
# parameters)
RGB_TRUNK_POSITIONS = {
    "conv1": "0", "bn1": "1",
    "layer1": "4", "layer2": "5", "layer3": "6", "layer4": "7",
}

# recurrent leaves: JAX name -> torch name (``_l0`` + optional reverse)
RNN_LEAVES = {
    "w_ih": "weight_ih",
    "w_hh": "weight_hh",
    "b_ih": "bias_ih",
    "b_hh": "bias_hh",
}

# norm / linear / conv leaves: JAX name -> torch name
LEAVES = {
    "w": "weight",
    "b": "bias",
    "scale": "weight",
    "bias": "bias",
    "mean": "running_mean",
    "var": "running_var",
}
