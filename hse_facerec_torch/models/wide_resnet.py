"""WideResNet-16-8 age/gender model.

Counterpart of ``hse_facerec_tf_tpu/models/wide_resnet.py`` (the reference's
Keras definition, ``age_gender_identity/wide_resnet.py:36-142``): one 3×3
conv, three pre-activation wide-basic groups ([16, 16k, 32k, 64k], two
blocks each, strides 1/2/2), final BN+ReLU, an 8×8 SAME average pool, and
two bias-free softmax heads — gender(2) and age(101) — over the 16·16·512
flatten of a 64² input (``utkface_test.py:290-314``).

Params are numpy pytrees in the reference's layouts; the forward takes them
as tensors (``params.tree_to_torch``). Input keeps the reference's NHWC.
The forward takes the reference's ``precision`` tier and ``compute_dtype``
(input and trunk params cast to it; the flatten and the heads float32).
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..numerics import precision_scope
from ..params import cast_tree, normal
from .layers import _same_pads, batch_norm, conv2d, dense


def _bn_relu(x, bn):
    return torch.relu(batch_norm(x, bn["gamma"], bn["beta"], bn["mean"], bn["var"]))


def _wide_basic(x, p, stride: int):
    """Pre-activation basic block; projection shortcut when widths change.
    When projecting, the reference feeds the BN+ReLU output to both the 3×3
    path and the 1×1 shortcut (``wide_resnet.py:50-55,86-91``)."""
    if "proj" in p:
        pre = _bn_relu(x, p["bn1"])
        y = conv2d(pre, p["conv1"], stride=stride)
        shortcut = conv2d(pre, p["proj"], stride=stride)
    else:
        y = conv2d(_bn_relu(x, p["bn1"]), p["conv1"], stride=stride)
        shortcut = x
    return conv2d(_bn_relu(y, p["bn2"]), p["conv2"]) + shortcut


@functools.lru_cache(maxsize=16)
def _same_recips(h: int, w: int, k: int) -> np.ndarray:
    """float32 reciprocals of the unpadded cells under each k×k stride-1
    SAME window: (H, W)."""
    def one_axis(n):
        lo, _ = _same_pads(n, k, 1)
        start = np.arange(n) - lo
        return np.minimum(start + k, n) - np.maximum(start, 0)

    counts = np.outer(one_axis(h), one_axis(w)).astype(np.float32)
    return np.float32(1.0) / counts


def _avg_pool_same(x, k: int):
    """Keras/TF AveragePooling2D(k, strides=1, 'same') on NCHW: edge windows
    divide by the count of UNPADDED cells (reference head
    ``wide_resnet.py:133``). Inside ``jax.jit`` XLA folds the counts into a
    constant and divides by it as a multiply by its float32 reciprocal, so
    that is the form here (``tests/test_torch_backbones.py`` tells the two
    apart on sums that are exact)."""
    h, w = x.shape[2], x.shape[3]
    top, bottom = _same_pads(h, k, 1)
    left, right = _same_pads(w, k, 1)
    summed = F.avg_pool2d(F.pad(x, (left, right, top, bottom)), k, 1,
                          divisor_override=1)
    return summed * torch.from_numpy(_same_recips(h, w, k)).to(x.device, x.dtype)


def wide_resnet_16_8(params: Dict, x, *, precision="highest",
                     compute_dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, 64, 64, 3) -> (gender_probs (N, 2), age_probs (N, 101)): the
    reference head (``wide_resnet.py:133-138``), AveragePooling2D(8×8,
    strides=1, 'same') → NHWC Flatten → two bias-free softmax heads."""
    dt = compute_dtype
    with precision_scope(precision):
        x = x.to(dt).permute(0, 3, 1, 2)
        x = conv2d(x, params["conv1"]["kernel"].to(dt))
        for g, stride in (("g1", 1), ("g2", 2), ("g3", 2)):
            for b in range(2):
                x = _wide_basic(x, cast_tree(params[f"{g}_b{b}"], dt),
                                stride if b == 0 else 1)
        x = _avg_pool_same(_bn_relu(x, cast_tree(params["bn_final"], dt)), 8)
        flat = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1).to(torch.float32)
        gender = torch.softmax(dense(flat, params["gender"]["kernel"]), dim=-1)
        age = torch.softmax(dense(flat, params["age"]["kernel"]), dim=-1)
    return gender, age


def init_wide_resnet_params(generator: torch.Generator, k: int = 8,
                            input_size: int = 64) -> Dict:
    """He-normal convs, identity BN, N(0, 0.01) heads: numpy params,
    normals drawn from ``generator``."""
    def conv(kh, kw, cin, cout):
        return normal(generator, (kh, kw, cin, cout), np.sqrt(2.0 / (kh * kw * cin)))

    def bn(ch):
        return {"gamma": np.ones(ch, np.float32), "beta": np.zeros(ch, np.float32),
                "mean": np.zeros(ch, np.float32), "var": np.ones(ch, np.float32)}

    widths = [16, 16 * k, 32 * k, 64 * k]
    p: Dict = {"conv1": {"kernel": conv(3, 3, 3, widths[0])}}
    in_ch = widths[0]
    for gi, out_ch in enumerate(widths[1:], start=1):
        for b in range(2):
            blk = {"bn1": bn(in_ch), "conv1": conv(3, 3, in_ch, out_ch),
                   "bn2": bn(out_ch), "conv2": conv(3, 3, out_ch, out_ch)}
            if in_ch != out_ch:
                blk["proj"] = conv(1, 1, in_ch, out_ch)
            p[f"g{gi}_b{b}"] = blk
            in_ch = out_ch
    p["bn_final"] = bn(in_ch)
    flat = (input_size // 4) ** 2 * in_ch   # 131072 for 64², the reference's
    p["gender"] = {"kernel": normal(generator, (flat, 2), 0.01)}
    p["age"] = {"kernel": normal(generator, (flat, 101), 0.01)}
    return p


def wide_resnet_params_from_h5(path: str, k: int = 8) -> Dict:
    """Import the reference's external WRN-16-8 checkpoint
    (``utkface_test.py:294-302``: yu4u age-gender ``weights.28-3.73.hdf5``,
    a Keras h5 with auto-numbered layers). Keras creation order fixes the
    mapping: conv2d_* = stem, then per block [conv1, conv2, (proj for each
    group's first block)]; batch_normalization_* = per block [bn1, bn2],
    final BN last; dense_1 = gender head, dense_2 = age head."""
    import re

    from ..core.h5_import import load_keras_h5

    w = load_keras_h5(path)

    def numbered(prefix):
        # Keras 1.x/2.x number from "<prefix>_1"; modern Keras names the
        # first instance bare "<prefix>": it sorts first as 0
        pat = re.compile(rf"^{prefix}(?:_(\d+))?$")
        found = {}
        for key in w:
            layer = key.split("/")[0]
            m = pat.match(layer)
            if m:
                found[int(m.group(1)) if m.group(1) else 0] = layer
        return [found[i] for i in sorted(found)]

    convs = numbered("conv2d")
    bns = numbered("batch_normalization")
    denses = numbered("dense")
    if not (len(convs) == 16 and len(bns) == 13 and len(denses) == 2):
        raise ValueError(f"{path}: {len(convs)} convs, {len(bns)} BNs, "
                         f"{len(denses)} dense layers; WRN-16-{k} has 16, 13, 2")

    ci, bi = iter(convs), iter(bns)

    def kern(layer):
        return np.asarray(w[f"{layer}/kernel"], np.float32)

    def bn(layer):
        return {"gamma": np.asarray(w[f"{layer}/gamma"], np.float32),
                "beta": np.asarray(w[f"{layer}/beta"], np.float32),
                "mean": np.asarray(w[f"{layer}/moving_mean"], np.float32),
                "var": np.asarray(w[f"{layer}/moving_variance"], np.float32)}

    p: Dict = {"conv1": {"kernel": kern(next(ci))}}
    for gi in (1, 2, 3):
        for b in range(2):
            blk = {"bn1": bn(next(bi)), "conv1": kern(next(ci)),
                   "bn2": bn(next(bi)), "conv2": kern(next(ci))}
            if b == 0:  # every group widens ⇒ first block projects
                blk["proj"] = kern(next(ci))
            p[f"g{gi}_b{b}"] = blk
    p["bn_final"] = bn(next(bi))
    p["gender"] = {"kernel": kern(denses[0])}
    p["age"] = {"kernel": kern(denses[1])}
    return p
