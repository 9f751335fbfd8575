"""MobileNet-V1 and dense-layer FLOP counts from the params' kernel shapes.

This module stays only as an independent count: ``perfbench/tests/
test_perfbench_arith.py`` holds ``perfbench/flops.py``'s MobileNet
multi-head count equal to ``_mobilenet_flops`` + ``_dense_flops``. Once
that test reads another independent count, the module can go.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _mobilenet_flops(backbone: Dict, hw) -> float:
    """2 x the MACs of MobileNet-V1's convs at ``hw`` (SAME padding), from
    the kernels' shapes: every output pixel of a layer costs the product of
    its kernel's shape (depthwise (3, 3, C, 1), pointwise (1, 1, C, C'))."""
    from .models.mobilenet import MOBILENET_V1_BLOCKS

    h, w = -(-hw[0] // 2), -(-hw[1] // 2)
    total = 2.0 * h * w * np.prod(backbone["conv1"]["kernel"].shape)
    for i, (stride, _) in enumerate(MOBILENET_V1_BLOCKS, start=1):
        h, w = -(-h // stride), -(-w // stride)
        total += 2.0 * h * w * (np.prod(backbone[f"dw{i}"]["kernel"].shape)
                                + np.prod(backbone[f"pw{i}"]["kernel"].shape))
    return float(total)


def _dense_flops(params: Dict, names) -> float:
    return float(sum(2.0 * np.prod(params[n]["kernel"].shape) for n in names))
