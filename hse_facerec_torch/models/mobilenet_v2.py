"""MobileNetV2 backbone + AgenderNet age/gender heads.

Counterpart of ``hse_facerec_tf_tpu/models/mobilenet_v2.py``. The reference
benchmarks the external AgenderNet MobileNetV2 on UTKFace (``utkface_test.py:
240-256``): 96² input, Keras ``mobilenet_v2`` preprocessing (x/127.5 − 1),
two softmax heads, decode = gender argmax and age = probs · [0..100]. The
backbone is MobileNetV2 alpha 1.0 with TF SAME padding (asymmetric on the
strided depthwise convs) and BN eps 1e-3; the importer reads the standard
Keras layer naming.

Params are numpy pytrees in the reference's layouts; the forward takes them
as tensors (``params.tree_to_torch``; a block's ``dw`` kernel is
depthwise). Input keeps the reference's NHWC. The forwards take the
reference's ``precision`` tier; the backbone also its ``compute_dtype``
(input and params cast to it, the pooled features float32).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..ops.preprocess import normalize_tf
from ..numerics import precision_scope
from ..params import cast_tree, normal
from .layers import batch_norm, conv2d, dense, depthwise_conv2d, relu6

# (expansion t, out channels c, repeats n, first stride s) — MobileNetV2 paper
MOBILENET_V2_BLOCKS = [
    (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
    (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
]


def _bn(x, p):
    return batch_norm(x, p["gamma"], p["beta"], p["mean"], p["var"])


def _inverted_residual(x, p, stride: int):
    h = x
    if "expand" in p:
        h = relu6(_bn(conv2d(h, p["expand"]), p["expand_bn"]))
    h = relu6(_bn(depthwise_conv2d(h, p["dw"], stride=stride), p["dw_bn"]))
    h = _bn(conv2d(h, p["project"]), p["project_bn"])
    if stride == 1 and x.shape[1] == h.shape[1]:
        h = h + x
    return h


def mobilenet_v2_backbone(params: Dict, x, *, precision="highest",
                          compute_dtype=torch.float32) -> torch.Tensor:
    """(N, H, W, 3) preprocessed (x/127.5 − 1) → (N, 1280) pooled features."""
    dt = compute_dtype
    with precision_scope(precision):
        x = x.to(dt).permute(0, 3, 1, 2)
        conv1 = cast_tree(params["conv1"], dt)
        x = relu6(_bn(conv2d(x, conv1["kernel"], stride=2), conv1["bn"]))
        i = 0
        for _, _, n, s in MOBILENET_V2_BLOCKS:
            for r in range(n):
                x = _inverted_residual(x, cast_tree(params[f"block{i}"], dt),
                                       s if r == 0 else 1)
                i += 1
        last = cast_tree(params["conv_last"], dt)
        x = relu6(_bn(conv2d(x, last["kernel"]), last["bn"]))
    return torch.mean(x, dim=(2, 3)).to(torch.float32)


def agendernet_apply(params: Dict, x, *, precision="highest"
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, 96, 96, 3) RGB 0-255 → (gender_probs (N, 2), age_probs (N, 101)),
    with the Keras mobilenet_v2 preprocessing inside (the reference's
    ``model.prep_image``): inside ``jax.jit`` ``x / 127.5 - 1`` is one FMA
    with the float32 reciprocal of 127.5 (``ops.preprocess.normalize_tf``)."""
    x = normalize_tf(x)
    with precision_scope(precision):
        feat = mobilenet_v2_backbone(params, x, precision=precision)
        gender = torch.softmax(dense(feat, params["gender"]["kernel"],
                                     params["gender"]["bias"]), dim=-1)
        age = torch.softmax(dense(feat, params["age"]["kernel"],
                                  params["age"]["bias"]), dim=-1)
    return gender, age


def decode_agendernet(gender_probs, age_probs):
    """AgenderNet decode (reference :246-252 via ``decode_prediction``):
    gender = argmax (0 = female), age = expectation over [0..100]."""
    gender = torch.argmax(gender_probs, dim=1)
    ages = age_probs @ torch.arange(0.0, 101.0, device=age_probs.device)
    return gender, ages


def init_mobilenet_v2_params(generator: torch.Generator, alpha: float = 1.0,
                             with_heads: bool = True) -> Dict:
    """He-normal convs, identity BN, N(0, 0.01) heads: numpy params,
    normals drawn from ``generator``."""
    def conv(shape):
        return normal(generator, shape, np.sqrt(2.0 / (shape[0] * shape[1] * shape[2])))

    def bn(ch):
        return {"gamma": np.ones(ch, np.float32), "beta": np.zeros(ch, np.float32),
                "mean": np.zeros(ch, np.float32), "var": np.ones(ch, np.float32)}

    def c(ch):
        return max(8, int(ch * alpha + 4) // 8 * 8)  # round to a multiple of 8

    first = c(32)
    p: Dict = {"conv1": {"kernel": conv((3, 3, 3, first)), "bn": bn(first)}}
    in_ch = first
    i = 0
    for t, ch, n, _ in MOBILENET_V2_BLOCKS:
        out = c(ch)
        for _ in range(n):
            blk: Dict = {}
            exp = in_ch * t
            if t != 1:
                blk["expand"] = conv((1, 1, in_ch, exp))
                blk["expand_bn"] = bn(exp)
            blk["dw"] = conv((3, 3, exp, 1))
            blk["dw_bn"] = bn(exp)
            blk["project"] = conv((1, 1, exp, out))
            blk["project_bn"] = bn(out)
            p[f"block{i}"] = blk
            in_ch = out
            i += 1
    last = max(1280, c(1280))
    p["conv_last"] = {"kernel": conv((1, 1, in_ch, last)), "bn": bn(last)}
    if with_heads:
        p["gender"] = {"kernel": normal(generator, (last, 2), 0.01),
                       "bias": np.zeros(2, np.float32)}
        p["age"] = {"kernel": normal(generator, (last, 101), 0.01),
                    "bias": np.zeros(101, np.float32)}
    return p


def mobilenet_v2_params_from_h5(path: str) -> Dict:
    """Importer for the standard Keras MobileNetV2 layer naming (``Conv1``,
    ``bn_Conv1``, ``expanded_conv_*`` for block 0, ``block_{i}_*`` after,
    ``Conv_1``/``Conv_1_bn`` last) + AgenderNet heads
    (``gender_prediction``/``age_prediction``)."""
    from ..core.h5_import import load_keras_h5

    w = load_keras_h5(path)

    def arr(key):
        return np.asarray(w[key], np.float32)

    def bn(layer):
        return {"gamma": arr(f"{layer}/gamma"), "beta": arr(f"{layer}/beta"),
                "mean": arr(f"{layer}/moving_mean"), "var": arr(f"{layer}/moving_variance")}

    p: Dict = {"conv1": {"kernel": arr("Conv1/kernel"), "bn": bn("bn_Conv1")}}
    i = 0
    for t, _, n, _ in MOBILENET_V2_BLOCKS:
        for _ in range(n):
            pre = "expanded_conv" if i == 0 else f"block_{i}"
            blk: Dict = {}
            if t != 1:
                blk["expand"] = arr(f"{pre}_expand/kernel")
                blk["expand_bn"] = bn(f"{pre}_expand_BN")
            blk["dw"] = arr(f"{pre}_depthwise/depthwise_kernel")
            blk["dw_bn"] = bn(f"{pre}_depthwise_BN")
            blk["project"] = arr(f"{pre}_project/kernel")
            blk["project_bn"] = bn(f"{pre}_project_BN")
            p[f"block{i}"] = blk
            i += 1
    p["conv_last"] = {"kernel": arr("Conv_1/kernel"), "bn": bn("Conv_1_bn")}
    for head, layer in (("gender", "gender_prediction"), ("age", "age_prediction")):
        if f"{layer}/kernel" in w:
            p[head] = {"kernel": arr(f"{layer}/kernel"), "bias": arr(f"{layer}/bias")}
    return p
