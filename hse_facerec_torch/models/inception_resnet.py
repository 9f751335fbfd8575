"""Inception-ResNet-v1 (FaceNet) with optional age/gender heads.

Counterpart of ``hse_facerec_tf_tpu/models/inception_resnet.py`` (the
reference's slim definition, ``age_gender_identity/inception_resnet_v1.py``):
valid-padded stem to 35×35×256, 5×block35 (scale 0.17) → reduction-A →
10×block17 (scale 0.10) → reduction-B → 5×block8 (scale 0.20) + a final
scale-1 block8 without activation, global average pool, 128-d bottleneck,
and the multi-head variant's age(101)/gender(2) logits. SAME convs pad as
TF does (the odd pixel at the end); BN eps 1e-3.

Params are numpy pytrees in the reference's layouts; the forward takes them
as tensors (``params.tree_to_torch``). Input keeps the reference's NHWC.
The forwards take the reference's ``precision`` tier; the embedding also
its ``compute_dtype``, to which the input and every param are cast (the
pooled embedding returns to float32 for the bottleneck).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..numerics import precision_scope
from ..params import cast_tree, normal
from .layers import batch_norm, conv2d, dense


def _conv_bn(x, p, *, stride: int = 1, padding: str = "SAME", relu: bool = True):
    x = conv2d(x, p["kernel"], stride=stride, padding=padding)
    if "bn" in p:
        bn = p["bn"]
        x = batch_norm(x, bn["gamma"], bn["beta"], bn["mean"], bn["var"])
    elif "bias" in p:
        x = x + p["bias"].reshape(1, -1, 1, 1)
    return torch.relu(x) if relu else x


def _block(x, p, scale: float, relu: bool = True):
    """block35 (three branches) or block17/block8 (two): the branches
    concatenated, a 1×1 ``up`` conv, ``x + scale·up``."""
    branches = [_conv_bn(x, p["b0"])]
    for prefix in ("b1", "b2"):
        names = sorted(k for k in p if k.startswith(prefix))
        if names:
            h = x
            for name in names:
                h = _conv_bn(h, p[name])
            branches.append(h)
    up = _conv_bn(torch.cat(branches, dim=1), p["up"], relu=False)
    x = x + scale * up
    return torch.relu(x) if relu else x


def inception_resnet_v1(params: Dict, x, *, precision="highest",
                        compute_dtype=torch.float32) -> torch.Tensor:
    """(N, H, W, 3) -> (N, 128) bottleneck embedding (H=W=160 canonically)."""
    with precision_scope(precision):
        return _inception_resnet_v1(cast_tree(params, compute_dtype),
                                    x.to(compute_dtype))


def _inception_resnet_v1(p: Dict, x) -> torch.Tensor:
    x = x.permute(0, 3, 1, 2)
    x = _conv_bn(x, p["conv1a"], stride=2, padding="VALID")
    x = _conv_bn(x, p["conv2a"], padding="VALID")
    x = _conv_bn(x, p["conv2b"])
    x = F.max_pool2d(x, 3, 2)
    x = _conv_bn(x, p["conv3b"], padding="VALID")
    x = _conv_bn(x, p["conv4a"], padding="VALID")
    x = _conv_bn(x, p["conv4b"], stride=2, padding="VALID")

    for i in range(5):
        x = _block(x, p[f"block35_{i}"], 0.17)
    ra = p["reduction_a"]
    b0 = _conv_bn(x, ra["b0"], stride=2, padding="VALID")
    b1 = _conv_bn(_conv_bn(_conv_bn(x, ra["b1a"]), ra["b1b"]),
                  ra["b1c"], stride=2, padding="VALID")
    x = torch.cat([b0, b1, F.max_pool2d(x, 3, 2)], dim=1)

    for i in range(10):
        x = _block(x, p[f"block17_{i}"], 0.10)
    rb = p["reduction_b"]
    b0 = _conv_bn(_conv_bn(x, rb["b0a"]), rb["b0b"], stride=2, padding="VALID")
    b1 = _conv_bn(_conv_bn(x, rb["b1a"]), rb["b1b"], stride=2, padding="VALID")
    b2 = _conv_bn(_conv_bn(_conv_bn(x, rb["b2a"]), rb["b2b"]),
                  rb["b2c"], stride=2, padding="VALID")
    x = torch.cat([b0, b1, b2, F.max_pool2d(x, 3, 2)], dim=1)

    for i in range(5):
        x = _block(x, p[f"block8_{i}"], 0.20)
    x = _block(x, p["block8_final"], 1.0, relu=False)

    emb = torch.mean(x, dim=(2, 3)).to(torch.float32)
    bottleneck = cast_tree(p["bottleneck"], torch.float32)
    return dense(emb, bottleneck["kernel"], bottleneck["bias"])


def inception_resnet_v1_age_gender(params: Dict, x, *, precision="highest"
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-head variant: (age_logits (N, 101), gender_logits (N, 2))."""
    with precision_scope(precision):
        emb = inception_resnet_v1(params, x, precision=precision)
        age = dense(emb, params["age"]["kernel"], params["age"]["bias"])
        gender = dense(emb, params["gender"]["kernel"], params["gender"]["bias"])
    return age, gender


def inception_resnet_v1_params_from_npz(path: str) -> Dict:
    """Import a FaceNet/age-gender slim checkpoint from an .npz of slim
    variable names (``InceptionResnetV1/Conv2d_1a_3x3/weights``,
    ``.../BatchNorm/{beta,moving_mean,moving_variance}``, …), the layout the
    reference restores before its ckpt→pb conversion (``utkface_test.py:
    41-86,186-225``). slim specifics: BN has no gamma (scale=False ⇒ ones);
    the ``Bottleneck`` FC's BatchNorm is folded into its kernel and bias;
    residual ``up`` convs carry biases; ``logits/age``/``logits/gender`` are
    plain FCs."""
    with np.load(path) as z:
        w = {k: np.asarray(z[k], np.float32) for k in z.files}
    R = "InceptionResnetV1"

    def bn(scope):
        beta = w[f"{scope}/BatchNorm/beta"]
        return {"gamma": w.get(f"{scope}/BatchNorm/gamma", np.ones_like(beta)),
                "beta": beta, "mean": w[f"{scope}/BatchNorm/moving_mean"],
                "var": w[f"{scope}/BatchNorm/moving_variance"]}

    def cb(scope):
        return {"kernel": w[f"{scope}/weights"], "bn": bn(scope)}

    def up(scope):
        return {"kernel": w[f"{scope}/weights"], "bias": w[f"{scope}/biases"]}

    p: Dict = {
        "conv1a": cb(f"{R}/Conv2d_1a_3x3"), "conv2a": cb(f"{R}/Conv2d_2a_3x3"),
        "conv2b": cb(f"{R}/Conv2d_2b_3x3"), "conv3b": cb(f"{R}/Conv2d_3b_1x1"),
        "conv4a": cb(f"{R}/Conv2d_4a_3x3"), "conv4b": cb(f"{R}/Conv2d_4b_3x3"),
    }
    for i in range(5):
        s = f"{R}/Repeat/block35_{i + 1}"
        p[f"block35_{i}"] = {
            "b0": cb(f"{s}/Branch_0/Conv2d_1x1"),
            "b1a": cb(f"{s}/Branch_1/Conv2d_0a_1x1"),
            "b1b": cb(f"{s}/Branch_1/Conv2d_0b_3x3"),
            "b2a": cb(f"{s}/Branch_2/Conv2d_0a_1x1"),
            "b2b": cb(f"{s}/Branch_2/Conv2d_0b_3x3"),
            "b2c": cb(f"{s}/Branch_2/Conv2d_0c_3x3"),
            "up": up(f"{s}/Conv2d_1x1"),
        }
    p["reduction_a"] = {
        "b0": cb(f"{R}/Mixed_6a/Branch_0/Conv2d_1a_3x3"),
        "b1a": cb(f"{R}/Mixed_6a/Branch_1/Conv2d_0a_1x1"),
        "b1b": cb(f"{R}/Mixed_6a/Branch_1/Conv2d_0b_3x3"),
        "b1c": cb(f"{R}/Mixed_6a/Branch_1/Conv2d_1a_3x3"),
    }
    for i in range(10):
        s = f"{R}/Repeat_1/block17_{i + 1}"
        p[f"block17_{i}"] = {
            "b0": cb(f"{s}/Branch_0/Conv2d_1x1"),
            "b1a": cb(f"{s}/Branch_1/Conv2d_0a_1x1"),
            "b1b": cb(f"{s}/Branch_1/Conv2d_0b_1x7"),
            "b1c": cb(f"{s}/Branch_1/Conv2d_0c_7x1"),
            "up": up(f"{s}/Conv2d_1x1"),
        }
    p["reduction_b"] = {
        "b0a": cb(f"{R}/Mixed_7a/Branch_0/Conv2d_0a_1x1"),
        "b0b": cb(f"{R}/Mixed_7a/Branch_0/Conv2d_1a_3x3"),
        "b1a": cb(f"{R}/Mixed_7a/Branch_1/Conv2d_0a_1x1"),
        "b1b": cb(f"{R}/Mixed_7a/Branch_1/Conv2d_1a_3x3"),
        "b2a": cb(f"{R}/Mixed_7a/Branch_2/Conv2d_0a_1x1"),
        "b2b": cb(f"{R}/Mixed_7a/Branch_2/Conv2d_0b_3x3"),
        "b2c": cb(f"{R}/Mixed_7a/Branch_2/Conv2d_1a_3x3"),
    }
    scopes = [(j, f"{R}/Repeat_2/block8_{j + 1}") for j in range(5)]
    for i, scope in scopes + [("final", f"{R}/Block8")]:
        p[f"block8_{i}"] = {
            "b0": cb(f"{scope}/Branch_0/Conv2d_1x1"),
            "b1a": cb(f"{scope}/Branch_1/Conv2d_0a_1x1"),
            "b1b": cb(f"{scope}/Branch_1/Conv2d_0b_1x3"),
            "b1c": cb(f"{scope}/Branch_1/Conv2d_0c_3x1"),
            "up": up(f"{scope}/Conv2d_1x1"),
        }
    # Bottleneck FC + its BatchNorm folded (scale=False, eps=1e-3):
    # y = (xW - m) / sqrt(v+eps) * gamma + beta
    kern = w[f"{R}/Bottleneck/weights"]
    bnb = bn(f"{R}/Bottleneck")
    inv = bnb["gamma"] / np.sqrt(bnb["var"] + 1e-3)
    p["bottleneck"] = {"kernel": np.asarray(kern * inv[None, :], np.float32),
                       "bias": np.asarray(bnb["beta"] - bnb["mean"] * inv, np.float32)}
    for head, scope in (("age", "logits/age"), ("gender", "logits/gender")):
        if f"{scope}/weights" in w:
            p[head] = {"kernel": w[f"{scope}/weights"], "bias": w[f"{scope}/biases"]}
    return p


def init_inception_resnet_v1_params(generator: torch.Generator, bottleneck: int = 128,
                                    with_heads: bool = False) -> Dict:
    """He-normal conv+BN layers, N(0, 0.05) ``up`` convs, N(0, 0.02)
    bottleneck, N(0, 0.01) heads: numpy params, normals drawn from
    ``generator``."""
    def cb(kh, kw, cin, cout):
        return {"kernel": normal(generator, (kh, kw, cin, cout),
                                 np.sqrt(2.0 / (kh * kw * cin))),
                "bn": {"gamma": np.ones(cout, np.float32), "beta": np.zeros(cout, np.float32),
                       "mean": np.zeros(cout, np.float32), "var": np.ones(cout, np.float32)}}

    def up(cin, cout):
        return {"kernel": normal(generator, (1, 1, cin, cout), 0.05),
                "bias": np.zeros(cout, np.float32)}

    def fc(din, dout, std):
        return {"kernel": normal(generator, (din, dout), std),
                "bias": np.zeros(dout, np.float32)}

    p: Dict = {
        "conv1a": cb(3, 3, 3, 32), "conv2a": cb(3, 3, 32, 32),
        "conv2b": cb(3, 3, 32, 64), "conv3b": cb(1, 1, 64, 80),
        "conv4a": cb(3, 3, 80, 192), "conv4b": cb(3, 3, 192, 256),
    }
    for i in range(5):
        p[f"block35_{i}"] = {
            "b0": cb(1, 1, 256, 32),
            "b1a": cb(1, 1, 256, 32), "b1b": cb(3, 3, 32, 32),
            "b2a": cb(1, 1, 256, 32), "b2b": cb(3, 3, 32, 32), "b2c": cb(3, 3, 32, 32),
            "up": up(96, 256),
        }
    p["reduction_a"] = {
        "b0": cb(3, 3, 256, 384),
        "b1a": cb(1, 1, 256, 192), "b1b": cb(3, 3, 192, 192), "b1c": cb(3, 3, 192, 256),
    }
    c17 = 256 + 384 + 256  # 896
    for i in range(10):
        p[f"block17_{i}"] = {
            "b0": cb(1, 1, c17, 128),
            "b1a": cb(1, 1, c17, 128), "b1b": cb(1, 7, 128, 128), "b1c": cb(7, 1, 128, 128),
            "up": up(256, c17),
        }
    p["reduction_b"] = {
        "b0a": cb(1, 1, c17, 256), "b0b": cb(3, 3, 256, 384),
        "b1a": cb(1, 1, c17, 256), "b1b": cb(3, 3, 256, 256),
        "b2a": cb(1, 1, c17, 256), "b2b": cb(3, 3, 256, 256), "b2c": cb(3, 3, 256, 256),
    }
    c8 = c17 + 384 + 256 + 256  # 1792
    for i in list(range(5)) + ["final"]:
        p[f"block8_{i}"] = {
            "b0": cb(1, 1, c8, 192),
            "b1a": cb(1, 1, c8, 192), "b1b": cb(1, 3, 192, 192), "b1c": cb(3, 1, 192, 192),
            "up": up(384, c8),
        }
    p["bottleneck"] = fc(c8, bottleneck, 0.02)
    if with_heads:
        p["age"] = fc(bottleneck, 101, 0.01)
        p["gender"] = fc(bottleneck, 2, 0.01)
    return p
