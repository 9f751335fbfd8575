"""MobileNet-V1 backbone (alpha 1.0), inference with folded params.

Counterpart of ``hse_facerec_tf_tpu/models/mobilenet.py``. Each block is
``{"kernel", "bias"}`` in PyTorch layout (``params.to_torch``). Input and
output keep the reference's NHWC layout; the permuted view is already
channels-last in memory, which is the layout cuDNN prefers.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from .layers import conv2d, depthwise_conv2d, relu6

# (stride, out_channels) for the 13 depthwise-separable blocks, alpha=1.0.
MOBILENET_V1_BLOCKS: List[Tuple[int, int]] = [
    (1, 64), (2, 128), (1, 128), (2, 256), (1, 256), (2, 512),
    (1, 512), (1, 512), (1, 512), (1, 512), (1, 512), (2, 1024), (1, 1024),
]


def mobilenet_v1_backbone(params: Dict, x):
    """(N, H, W, 3) -> (N, H/32, W/32, 1024) feature map."""
    x = x.permute(0, 3, 1, 2)
    p = params["conv1"]
    x = relu6(conv2d(x, p["kernel"], p["bias"], stride=2))
    for i, (stride, _) in enumerate(MOBILENET_V1_BLOCKS, start=1):
        pdw, ppw = params[f"dw{i}"], params[f"pw{i}"]
        x = relu6(depthwise_conv2d(x, pdw["kernel"], pdw["bias"], stride=stride))
        x = relu6(conv2d(x, ppw["kernel"], ppw["bias"]))
    return x.permute(0, 2, 3, 1)
