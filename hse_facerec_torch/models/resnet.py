"""ResNet-50 (VGGFace2 flavor) face-embedding model.

Counterpart of ``hse_facerec_tf_tpu/models/resnet.py``: the reference's
strongest embedder (``models/vgg2_resnet.pb``, tap ``input:0 →
pool5_7x7_s1:0`` with VGGFace2 mean preprocessing, ``facerec_test.py:213``;
the weight blob itself is absent upstream). The architecture is the
keras_vggface ResNet-50: 7×7/2 stem + BN/ReLU + 3×3/2 max-pool, bottleneck
stages [3, 4, 6, 3], global average pool → 2048-d embedding (optionally an
8631-way VGGFace2 classifier for training).

Params come in PyTorch layout (``params.to_torch``), one dict per conv, in
either form: folded {"kernel", "bias"} (the frozen-pb importer,
``core/pb_import.py``) or {"kernel", "bn": {gamma, beta, mean, var}}.
Input and output keep the reference's NHWC layout.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..numerics import precision_scope
from ..params import cast_tree
from .layers import batch_norm, conv2d, dense, global_avg_pool

STAGES = (3, 4, 6, 3)
STAGE_WIDTHS = ((64, 64, 256), (128, 128, 512), (256, 256, 1024), (512, 512, 2048))


def _conv_bn(x, p, *, stride: int = 1, relu: bool = True, stem: bool = False):
    """Conv + BN (or the folded bias) + optional ReLU, on NCHW. The stem is
    the keras_vggface form, ``ZeroPadding2D((3, 3))`` + 7×7/2 VALID conv,
    not TF SAME (which pads (2, 3) and shifts the crop by one pixel)."""
    if stem:
        x = F.conv2d(x, p["kernel"], stride=stride, padding=3)
    else:
        x = conv2d(x, p["kernel"], stride=stride)
    if "bn" in p:
        bn = p["bn"]
        x = batch_norm(x, bn["gamma"], bn["beta"], bn["mean"], bn["var"])
    elif "bias" in p:
        x = x + p["bias"].reshape(1, -1, 1, 1)
    return torch.relu(x) if relu else x


def _bottleneck(x, p, *, stride: int):
    shortcut = x
    if "proj" in p:
        shortcut = _conv_bn(x, p["proj"], stride=stride, relu=False)
    y = _conv_bn(x, p["conv1"], stride=stride)
    y = _conv_bn(y, p["conv2"])
    y = _conv_bn(y, p["conv3"], relu=False)
    return torch.relu(y + shortcut)


def resnet50_backbone(params: Dict, x, *, precision="highest",
                      compute_dtype=torch.float32):
    """(N, H, W, 3) -> (N, H/32, W/32, 2048): stem, 3×3/2 VALID max-pool
    (Keras ``MaxPooling2D`` default), the bottleneck stages, at
    ``precision``'s tier."""
    with precision_scope(precision):
        x = x.permute(0, 3, 1, 2).to(compute_dtype)
        x = _conv_bn(x, cast_tree(params["stem"], compute_dtype), stride=2, stem=True)
        x = F.max_pool2d(x, 3, 2)
        for si, n_blocks in enumerate(STAGES):
            for bi in range(n_blocks):
                stride = 2 if (bi == 0 and si > 0) else 1
                x = _bottleneck(x, cast_tree(params[f"stage{si + 1}_block{bi + 1}"],
                                             compute_dtype), stride=stride)
    return x.permute(0, 2, 3, 1)


def resnet50_embed(params: Dict, x, *, precision="highest",
                   compute_dtype=torch.float32):
    """Face embedding (== the frozen graph's ``pool5_7x7_s1`` tap): (N, 2048)."""
    h = resnet50_backbone(params, x, precision=precision, compute_dtype=compute_dtype)
    return global_avg_pool(h.permute(0, 3, 1, 2)).to(torch.float32)


def resnet50_classify(params: Dict, x, *, precision="highest",
                      compute_dtype=torch.float32):
    with precision_scope(precision):
        emb = resnet50_embed(params, x, precision=precision,
                             compute_dtype=compute_dtype)
        return dense(emb, params["classifier"]["kernel"],
                     params["classifier"]["bias"])


def init_resnet50_params(generator: torch.Generator, n_classes: Optional[int] = None,
                         device="cuda") -> Dict:
    """He-normal ResNet-50 params with full BN blocks, in PyTorch layout on
    ``device``. Normals are drawn from ``generator`` in the reference's
    shapes (HWIO) and order (stem, then per block conv1, conv2, conv3,
    proj, then the classifier)."""
    from ..params import to_torch
    from ..pipelines.detector import resolve_device

    device = resolve_device(device)

    def conv_init(shape):
        fan_in = int(np.prod(shape[:-1]))
        return (torch.randn(shape, generator=generator, device=generator.device)
                .cpu().numpy() * np.float32(math.sqrt(2.0 / fan_in)))

    def bn_init(ch):
        return {"gamma": np.ones(ch, np.float32), "beta": np.zeros(ch, np.float32),
                "mean": np.zeros(ch, np.float32), "var": np.ones(ch, np.float32)}

    def conv_bn(kh, kw, cin, cout):
        return {"kernel": conv_init((kh, kw, cin, cout)), "bn": bn_init(cout)}

    params: Dict = {"stem": conv_bn(7, 7, 3, 64)}
    in_ch = 64
    for si, n_blocks in enumerate(STAGES):
        w1, w2, w3 = STAGE_WIDTHS[si]
        for bi in range(n_blocks):
            p = {
                "conv1": conv_bn(1, 1, in_ch, w1),
                "conv2": conv_bn(3, 3, w1, w2),
                "conv3": conv_bn(1, 1, w2, w3),
            }
            if bi == 0:
                p["proj"] = conv_bn(1, 1, in_ch, w3)
            params[f"stage{si + 1}_block{bi + 1}"] = p
            in_ch = w3
    if n_classes is not None:
        params["classifier"] = {"kernel": conv_init((in_ch, n_classes)),
                                "bias": np.zeros(n_classes, np.float32)}
    return to_torch(params, device)


def _h5_slot(weights: Dict, layer: str, kind: str) -> Optional[np.ndarray]:
    """Find layer weight ``kind`` across Keras weight-name conventions
    (``kernel`` vs old-style ``<base>_W_1``, BN ``moving_mean`` vs
    ``running_mean``); returns None when absent."""
    suffixes = {
        "kernel": ("kernel", "_W_1", "_W"),
        "bias": ("bias", "_b_1", "_b"),
        "gamma": ("gamma",),
        "beta": ("beta",),
        "mean": ("moving_mean", "running_mean"),
        "var": ("moving_variance", "running_std"),
    }[kind]
    prefix = layer + "/"
    for key, v in weights.items():
        if key.startswith(prefix) and key[len(prefix):].endswith(suffixes):
            return np.asarray(v)
    return None


def resnet50_params_from_h5(path: str) -> Dict:
    """keras_vggface (rcmalli) ResNet-50 h5 → ResNet-50 param pytree (BN
    form, the reference's numpy layouts). Layer naming per keras_vggface
    ``RESNET50``: stem ``conv1/7x7_s2`` (+ ``/bn``), bottlenecks
    ``conv{s}_{b}_1x1_reduce`` / ``_3x3`` / ``_1x1_increase`` /
    ``_1x1_proj`` for stages s=2..5 (+ ``/bn`` each). The reference taps its
    ``avg_pool`` output as the clustering feature extractor
    (``facial_clustering_test.py:296-300``) — that equals
    ``resnet50_embed``. Conv biases, when present, fold into the BN running
    mean (``BN(x + b)`` ≡ BN with ``mean - b``)."""
    from ..core.h5_import import load_keras_h5

    w = load_keras_h5(path)

    def block(layer: str) -> Dict:
        kernel = _h5_slot(w, layer, "kernel")
        if kernel is None:
            raise KeyError(
                f"resnet50 h5 import: layer {layer!r} has no kernel among "
                f"{sorted(k for k in w if k.startswith(layer))[:4]}...")
        bn_layer = f"{layer}/bn"
        bn = {k: _h5_slot(w, bn_layer, k)
              for k in ("gamma", "beta", "mean", "var")}
        if any(v is None for v in bn.values()):
            raise KeyError(f"resnet50 h5 import: incomplete BN for {bn_layer}")
        bias = _h5_slot(w, layer, "bias")
        if bias is not None:
            bn["mean"] = bn["mean"] - bias
        # float32, as the reference's jnp.asarray makes them
        return {"kernel": np.asarray(kernel, np.float32),
                "bn": {k: np.asarray(v, np.float32) for k, v in bn.items()}}

    params: Dict = {"stem": block("conv1/7x7_s2")}
    for si, n_blocks in enumerate(STAGES):
        for bi in range(n_blocks):
            s, b = si + 2, bi + 1
            p = {
                "conv1": block(f"conv{s}_{b}_1x1_reduce"),
                "conv2": block(f"conv{s}_{b}_3x3"),
                "conv3": block(f"conv{s}_{b}_1x1_increase"),
            }
            if bi == 0:
                p["proj"] = block(f"conv{s}_{b}_1x1_proj")
            params[f"stage{si + 1}_block{bi + 1}"] = p
    return params
