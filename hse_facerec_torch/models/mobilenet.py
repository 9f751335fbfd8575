"""MobileNet-V1 backbone (alpha 1.0): inference and training.

Counterpart of ``hse_facerec_tf_tpu/models/mobilenet.py``. Params come in
PyTorch layout (``params.to_torch``), one dict per layer, in either form:
  - folded:  {"kernel", "bias"}  (imported from frozen pbs; inference)
  - bn:      {"kernel", "bn": {gamma, beta, mean, var}}  (training)
Input and output keep the reference's NHWC layout; the permuted view is
channels-last in memory, which is the layout cuDNN prefers. On a card any
other input (a resize's output) is copied to it once, at the backbone's
entry.

In training mode (``train=True``) a BN layer normalizes with the batch
moments, mean and biased variance over N, H and W, written out as the
reference writes them (``layers.batch_norm``), not through
``F.batch_norm``: its running variance is unbiased, its momentum is
``1 - 0.99``, and its backward rounds otherwise.

Each forward takes the reference's ``precision`` tier (``numerics``) and
``compute_dtype``; the backbone also takes ``bf16_blocks_below``, the
reference's mixed-precision serving dial.

A folded float32 layer on a card ends in one K7 launch
(``ops/kernels/bn_act.py::bias_relu6``): its conv runs without the bias,
and K7 adds the bias and clips in one pass, writing the zero edge of the
next conv where that conv is a stride-2 depthwise conv on an even size (4
of a forward's 27 layers at 224² and 192²), so that conv pads nothing. The
bits are the eager layer's. Every other layer (the BN form, bf16, the CPU)
runs the eager passes.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..numerics import precision_scope
from ..ops.kernels.bn_act import bias_relu6
from ..params import cast_tree
from .layers import (batch_norm, bottom_right_edge, conv2d, dense, depthwise_conv2d,
                     relu6, relu6_train)

# (stride, out_channels) for the 13 depthwise-separable blocks, alpha=1.0.
MOBILENET_V1_BLOCKS: List[Tuple[int, int]] = [
    (1, 64), (2, 128), (1, 128), (2, 256), (1, 256), (2, 512),
    (1, 512), (1, 512), (1, 512), (1, 512), (1, 512), (2, 1024), (1, 1024),
]
BN_EPS = 1e-3


def _conv_bn_relu6(x, p, conv, stride: int, train: bool):
    """conv -> folded bias or BN -> ReLU6. Returns the activation and, for a
    BN layer in training mode, its batch (mean, var), detached."""
    if "bn" not in p:
        return relu6(conv(x, p["kernel"], p["bias"], stride=stride)), None
    y = conv(x, p["kernel"], stride=stride)
    bn = p["bn"]
    if not train:
        return relu6_train(batch_norm(y, bn["gamma"], bn["beta"], bn["mean"],
                                      bn["var"], eps=BN_EPS)), None
    var, mean = torch.var_mean(y, dim=(0, 2, 3), correction=0)
    return (relu6_train(batch_norm(y, bn["gamma"], bn["beta"], mean, var, eps=BN_EPS)),
            (mean.detach(), var.detach()))


def _on_card(x) -> bool:
    return x.device.type == "cuda"


def _on_k7(p: Dict, dt, x) -> bool:
    """A layer runs on K7 when its params are folded and it computes in
    float32 on a card (``x`` is the backbone's input)."""
    return "bn" not in p and dt == torch.float32 and _on_card(x)


def _conv_bias_relu6_k7(x, p, conv, stride: int, padded: bool, nxt=None):
    """A folded layer on K7: the conv without its bias, then the bias and
    ReLU6 in one pass. ``padded``: ``x`` carries this conv's zero edge
    already, so the conv pads nothing. ``nxt``: the next conv's (weight,
    stride) where that conv runs on K7 too; K7 writes its zero edge where
    its SAME padding is one row and one column at the bottom right.
    Returns the activation and whether it carries that edge."""
    y = conv(x, p["kernel"], stride=stride, padding="VALID" if padded else "SAME")
    edge = nxt is not None and bottom_right_edge(y.shape, nxt[0].shape, nxt[1])
    return bias_relu6(y, p["bias"], pad_next=edge), edge


def mobilenet_v1_backbone(params: Dict, x, *, precision="highest",
                          compute_dtype=torch.float32, train: bool = False,
                          stats_out: Optional[Dict] = None,
                          bf16_blocks_below: int = 0, remat: bool = False):
    """(N, H, W, 3) -> (N, H/32, W/32, 1024) feature map.

    The input and every layer's params are cast to ``compute_dtype``, and
    the layers run at ``precision``'s tier. ``bf16_blocks_below``: blocks
    with an index below it (conv1 = 0) run in bf16 (the reference's
    mixed-precision serving dial; its bf16 blocks run at DEFAULT, which is
    what a bf16 op is at every tier here), the rest in ``compute_dtype``.
    With ``train=True`` BN layers use batch moments; pass ``stats_out={}``
    to collect them (per layer {"mean", "var"}) for ``update_bn_stats``.
    ``remat`` recomputes each block's internals in the backward pass
    (``torch.utils.checkpoint``): peak memory is the blocks' inputs plus
    one block's activations."""
    def dtype(i):
        return torch.bfloat16 if i < bf16_blocks_below else compute_dtype

    with precision_scope(precision):
        return _backbone(params, x, dtype, train, stats_out, remat)


def _backbone(params: Dict, x, dtype, train: bool, stats_out: Optional[Dict],
              remat: bool):
    x = x.permute(0, 3, 1, 2).to(dtype(0))
    if _on_card(x):
        # channels-last memory (a no-op for NHWC input), so every conv's
        # output is too, as K7 takes it: on NCHW memory torch's f32
        # depthwise conv is not cuDNN's and sums its bias in with the
        # products, which no epilogue after it reproduces
        x = x.contiguous(memory_format=torch.channels_last)
    n_blocks = len(MOBILENET_V1_BLOCKS)
    # per block (conv1 = 0) whether its layers run on K7, and the conv that
    # follows each block: the next block's depthwise conv and its stride
    k7 = [_on_k7(params[f"dw{i}" if i else "conv1"], dtype(i), x)
          for i in range(n_blocks + 1)]
    nxt = [(params[f"dw{i + 1}"]["kernel"], MOBILENET_V1_BLOCKS[i][0])
           if i < n_blocks and k7[i + 1] else None for i in range(n_blocks + 1)]
    stats: Dict[str, Tuple] = {}
    padded = False    # x carries the next conv's zero edge (K7 wrote it)
    p1 = cast_tree(params["conv1"], dtype(0))
    if k7[0]:
        x, padded = _conv_bias_relu6_k7(x, p1, conv2d, 2, False, nxt[0])
    else:
        x, stats["conv1"] = _conv_bn_relu6(x, p1, conv2d, 2, train)
    for i, (stride, _) in enumerate(MOBILENET_V1_BLOCKS, start=1):
        dt = dtype(i)
        x = x.to(dt)
        pdw, ppw = cast_tree(params[f"dw{i}"], dt), cast_tree(params[f"pw{i}"], dt)
        if k7[i]:
            # x rebound at once: the block's input is freed before pw's pass
            x, _ = _conv_bias_relu6_k7(x, pdw, depthwise_conv2d, stride, padded)
            x, padded = _conv_bias_relu6_k7(x, ppw, conv2d, 1, False, nxt[i])
            continue

        def block(x, pdw=pdw, ppw=ppw, stride=stride):
            y, s_dw = _conv_bn_relu6(x, pdw, depthwise_conv2d, stride, train)
            y, s_pw = _conv_bn_relu6(y, ppw, conv2d, 1, train)
            return y, s_dw, s_pw

        if remat:
            x, s_dw, s_pw = checkpoint(block, x, use_reentrant=False)
        else:
            x, s_dw, s_pw = block(x)
        stats[f"dw{i}"], stats[f"pw{i}"] = s_dw, s_pw
    if stats_out is not None:
        stats_out.update({k: {"mean": s[0], "var": s[1]}
                          for k, s in stats.items() if s is not None})
    return x.permute(0, 2, 3, 1)


@torch.no_grad()
def update_bn_stats(params: Dict, stats: Dict, momentum: float = 0.99) -> Dict:
    """Fold collected batch moments into the running BN statistics, in
    place: ``momentum·old + (1 - momentum)·batch`` (biased variance)."""
    for layer, s in stats.items():
        bn = params[layer]["bn"]
        for key in ("mean", "var"):
            bn[key].mul_(momentum).add_(s[key].to(bn[key].dtype), alpha=1.0 - momentum)
    return params


def mobilenet_embed(params: Dict, x, *, precision="highest",
                    compute_dtype=torch.float32):
    """Face embedding: backbone + GAP -> (N, 1024) f32 (the reference's
    ``reshape_1/Reshape:0`` tap without the vestigial reshape)."""
    h = mobilenet_v1_backbone(params, x, precision=precision,
                              compute_dtype=compute_dtype)
    return torch.mean(h, dim=(1, 2)).to(torch.float32)


def mobilenet_classify(params: Dict, x, *, precision="highest",
                       compute_dtype=torch.float32):
    """Training-time logits head: embedding -> (N, n_classes) (reference
    ``facerec_keras_train.py:46-57``)."""
    with precision_scope(precision):
        emb = mobilenet_embed(params, x, precision=precision,
                              compute_dtype=compute_dtype)
        return dense(emb, params["classifier"]["kernel"],
                     params["classifier"]["bias"])


def init_mobilenet_params(generator: torch.Generator, n_classes: Optional[int] = None,
                          width: float = 1.0, device="cuda") -> Dict:
    """He-normal MobileNet-V1 params with full BN blocks (training form), in
    PyTorch layout on ``device``. Normals are drawn from ``generator`` in the
    reference's shapes and order (conv1, dw1, pw1, ..., classifier)."""
    from ..params import to_torch
    from ..pipelines.detector import resolve_device

    device = resolve_device(device)

    def c(ch):
        return max(8, int(ch * width))

    def he(shape, fan_in):
        return (torch.randn(shape, generator=generator, device=generator.device)
                .cpu().numpy() * np.float32(math.sqrt(2.0 / fan_in)))

    def bn(ch):
        return {"gamma": np.ones(ch, np.float32), "beta": np.zeros(ch, np.float32),
                "mean": np.zeros(ch, np.float32), "var": np.ones(ch, np.float32)}

    in_ch = c(32)
    params: Dict = {"conv1": {"kernel": he((3, 3, 3, in_ch), 27), "bn": bn(in_ch)}}
    for i, (_, out) in enumerate(MOBILENET_V1_BLOCKS, start=1):
        out = c(out)
        params[f"dw{i}"] = {"kernel": he((3, 3, in_ch, 1), 9), "bn": bn(in_ch)}
        params[f"pw{i}"] = {"kernel": he((1, 1, in_ch, out), in_ch), "bn": bn(out)}
        in_ch = out
    if n_classes is not None:
        params["classifier"] = {"kernel": he((in_ch, n_classes), in_ch),
                                "bias": np.zeros(n_classes, np.float32)}
    return to_torch(params, device)
