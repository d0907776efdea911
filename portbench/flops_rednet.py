"""RedNet's float32 operations per frame, from its widths alone.

Multiply-adds counted twice, of every convolution and transposed
convolution of the eval forward (``portbench/reference/rednet.py``): a
convolution takes its output's elements times its input channels times
its kernel's area; a transposed convolution its input's elements times
its output channels times its kernel's area. Norms, ReLUs, the fusions'
additions, the max-pool and the input preparation are left out. The
stage widths and counts are the plain reference's; no module of the port
is imported."""

from __future__ import annotations

from typing import Sequence

from portbench.reference.rednet import (FINAL_BLOCKS, LAYERS, PLANES,
                                        TRANS_LAYERS, TRANS_PLANES)


def rednet_flops(side: int, classes: int = 13,
                 layers: Sequence[int] = LAYERS,
                 trans_layers: Sequence[int] = TRANS_LAYERS) -> int:
    """Float32 operations of RedNet on one ``side`` x ``side`` frame (the
    RGB already resized to it)."""
    macs = 0
    s = (side + 2 * 3 - 7) // 2 + 1
    macs += s * s * 64 * (3 + 1) * 49  # the two stems
    sides = [s]  # the sides of the fused stem and stage outputs
    s = (s + 2 - 3) // 2 + 1  # max-pool 3, stride 2, pad 1
    stream, inplanes = 0, 64
    for i, (planes, blocks) in enumerate(zip(PLANES, layers)):
        for b in range(blocks):
            stride = 2 if i > 0 and b == 0 else 1
            out = (s - 1) // stride + 1
            stream += s * s * planes * inplanes  # 1x1 before the stride
            stream += out * out * planes * planes * 9
            stream += out * out * planes * 4 * planes
            if b == 0:
                stream += out * out * planes * 4 * inplanes
            inplanes, s = planes * 4, out
        sides.append(s)
    macs += 2 * stream  # RGB and depth streams alike
    widths = [64] + [p * 4 for p in PLANES]
    for k, into in enumerate((64, 64, 128, 256, 512)):  # agant0 .. agant4
        macs += sides[k] ** 2 * into * widths[k]
    s, c = sides[4], PLANES[-1]
    for planes, blocks in zip(TRANS_PLANES, trans_layers):
        macs += (blocks - 1) * 2 * s * s * c * c * 9  # shape-keeping blocks
        macs += s * s * c * c * 9  # the last block's first convolution
        macs += s * s * c * planes * (9 + 4)  # its two transposed ones
        s, c = 2 * s, planes
    macs += FINAL_BLOCKS * 2 * s * s * c * c * 9
    macs += s * s * c * classes * 4  # the head, to 2 s
    return 2 * macs
