"""Full-int8 MobileNet-V1 serving path: int8 activations, pointwise layers
on the int8 kernel K4.

Counterpart of ``hse_facerec_tf_tpu/models/int8_infer.py`` (which imports
jax, so nothing of it is imported here). The scheme is the reference's:
- every block activation is post-ReLU6, in [0, 6], and quantizes with the
  fixed scale 6/127 (values 0-127, no calibration);
- pointwise weights quantize per output channel (``max|w| / 127``) after
  the BN/affine fold; a pointwise layer is an exact int8 x int8 -> int32
  dot, then ``clip(fma(acc, s_act·s_w, bias), 0, 6)`` and the requant, all
  in K4 (``ops/kernels/pw_conv.py``);
- the depthwise convs and conv1 run on bf16-rounded taps with f32
  accumulation: here an f32 cuDNN conv of the bf16-rounded taps and the
  exact int8 -> f32 input, which is what ``preferred_element_type=f32``
  computes; the activation scale is folded into the depthwise taps;
- the last block's output stays f32 (no requant) for the GAP identity.

Quantization (``quantize_*``) is numpy on the host and returns the JAX
package's arrays bit for bit, without its TPU lane packing (``wp``,
``scale_p``, ``bias_p``). ``params.to_torch`` moves the result to a
device. The public functions take and return NHWC, as the reference's.
Inside, activations are NCHW views of channels-last memory: each pointwise
layer hands K4 the (N·H·W, C) matrix the int8 tensor already is, and K4's
(N·H·W, Cout) output is the next channels-last activation, with no copy.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..numerics import precision_scope
from ..ops.kernels.pw_conv import pw_conv_int8, requant_int8
from .layers import conv2d, dense, depthwise_conv2d
from .mobilenet import MOBILENET_V1_BLOCKS
from .multihead import MultiHeadOutput

# Fixed activation quantization: post-ReLU6 tensors live in [0, 6].
ACT_SCALE = 6.0 / 127.0


def _fold_inference_affine(p: Dict, depthwise: bool) -> Dict:
    """Collapse any param form ({kernel,bn} / {kernel,scale,bias} /
    {kernel,bias}) to inference ``{kernel, bias}`` with the channel affine
    folded into the kernel (reference ``int8_infer.py:52-80``)."""
    kernel = np.asarray(p["kernel"], dtype=np.float32)
    if "bn" in p:
        bn = p["bn"]
        inv = np.asarray(bn["gamma"], np.float32) / np.sqrt(
            np.asarray(bn["var"], np.float32) + 1e-3)
        bias = np.asarray(bn["beta"], np.float32) - np.asarray(
            bn["mean"], np.float32) * inv
    else:
        inv = np.asarray(p.get("scale", 1.0), np.float32)
        bias = np.asarray(p.get("bias", 0.0), np.float32)
        if np.ndim(inv) == 0 and float(np.max(inv)) == 1.0:
            inv = None
    if inv is not None:
        if np.ndim(inv) == 0:
            kernel = kernel * float(inv)
        elif depthwise:
            # (H, W, C, 1): affine is per input channel C
            kernel = kernel * inv.reshape(1, 1, -1, 1)
        else:
            # (H, W, I, O): affine is per output channel O
            kernel = kernel * inv.reshape(1, 1, 1, -1)
    return {"kernel": kernel, "bias": np.broadcast_to(
        np.asarray(bias, np.float32), (kernel.shape[2] if depthwise else
                                       kernel.shape[3],)).copy()}


def quantize_backbone_int8(params: Dict) -> Dict:
    """MobileNet-V1 param pytree (any form) -> int8 serving params, numpy:
    - ``pw{i}``: {"q": (Cin, Cout) int8, "scale": (Cout,) f32 = s_w·s_act,
      "bias": (Cout,) f32};
    - ``dw{i}``: {"kernel": (3, 3, C, 1) f32 with s_act folded in, "bias"};
    - ``conv1``: folded f32 kernel/bias.
    Reference ``int8_infer.py:83-134`` at its default, every block int8: its
    ``bf16_blocks_below`` dial (a bf16 prefix for XLA's TPU int8 conv
    emitter, slower at every cut it measured) is not ported."""
    out: Dict = {}
    out["conv1"] = _fold_inference_affine(params["conv1"], depthwise=False)
    for i, _ in enumerate(MOBILENET_V1_BLOCKS, start=1):
        dw = _fold_inference_affine(params[f"dw{i}"], depthwise=True)
        pw = _fold_inference_affine(params[f"pw{i}"], depthwise=False)
        # int8 input decodes as q·s_act: fold s_act into the depthwise kernel
        out[f"dw{i}"] = {"kernel": dw["kernel"] * ACT_SCALE,
                         "bias": dw["bias"]}
        k = pw["kernel"][0, 0]                      # (Cin, Cout)
        s_w = np.maximum(np.abs(k).max(axis=0), 1e-12) / 127.0
        q = np.clip(np.round(k / s_w[None, :]), -127, 127).astype(np.int8)
        scale = (s_w * ACT_SCALE).astype(np.float32)
        out[f"pw{i}"] = {"q": q, "scale": scale, "bias": pw["bias"]}
    return out


def _numpy_tree(tree):
    return {k: _numpy_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def quantize_multihead_int8(params: Dict) -> Dict:
    """Multi-head param pytree -> int8 serving pytree (heads stay f32)."""
    return {
        "backbone": quantize_backbone_int8(params["backbone"]),
        "feats": _numpy_tree(params["feats"]),
        "age": _numpy_tree(params["age"]),
        "gender": _numpy_tree(params["gender"]),
    }


def is_quantized(params: Dict) -> bool:
    """True for a pytree from ``quantize_multihead_int8`` (reference
    ``heads.py:66-68``: the first pointwise layer holds ``q``)."""
    return "q" in params.get("backbone", {}).get("pw1", {})


def _bf16(x):
    """Round to bf16 and back: the operand values of a bf16 conv."""
    return x.to(torch.bfloat16).to(torch.float32)


def _relu6_bias(y, bias):
    """``relu6(y + bias)`` in place on a fresh conv output."""
    return y.add_(bias[:, None, None]).clamp_(0.0, 6.0)


def _dw_conv_int8(a, kernel, bias, stride: int):
    """Depthwise conv of an int8 activation (N, C, H, W view, channels-last):
    the int8 values widen exactly to f32 and meet the bf16-rounded taps
    (s_act folded in) in an f32 conv; returns ``relu6(y + bias)``."""
    y = depthwise_conv2d(a.to(torch.float32), kernel, stride=stride)
    return _relu6_bias(y, bias)


def _pw_conv_int8(a, pw, requant: bool):
    """Pointwise conv on K4: the channels-last int8 activation is already
    the (N·H·W, C) matrix; the (N·H·W, Cout) result is the next activation."""
    n, c, h, w = a.shape
    out = pw_conv_int8(a.permute(0, 2, 3, 1).reshape(n * h * w, c), pw["q"],
                       pw["scale"], pw["bias"], requant=requant)
    return out.view(n, h, w, -1).permute(0, 3, 1, 2)


def stem_int8(qparams: Dict, x):
    """conv1 of the int8 backbone: (N, H, W, 3) f32 preprocessed -> the
    int8 activation, an (N, C, H/2, W/2) view of channels-last memory.
    conv1 runs on bf16-rounded operands (its input is not ReLU6-bounded)."""
    c1 = qparams["conv1"]
    y = conv2d(_bf16(x).permute(0, 3, 1, 2), c1["kernel"], stride=2)
    return requant_int8(_relu6_bias(y, c1["bias"]))


def block_int8(qparams: Dict, i: int, a):
    """Block ``i`` (1-13) on an int8 activation (N, C, H, W view,
    channels-last): depthwise conv and requant, then the pointwise conv on
    K4. The last block returns its f32 output, not requantized, for the
    GAP identity."""
    stride = MOBILENET_V1_BLOCKS[i - 1][0]
    dw, pw = qparams[f"dw{i}"], qparams[f"pw{i}"]
    a = requant_int8(_dw_conv_int8(a, dw["kernel"], dw["bias"], stride))
    return _pw_conv_int8(a, pw, requant=i < len(MOBILENET_V1_BLOCKS))


def mobilenet_backbone_int8(qparams: Dict, x):
    """(N, H, W, 3) f32 preprocessed -> (N, H/32, W/32, 1024) f32 features.

    ``qparams`` from ``params.to_torch`` (float kernels already
    bf16-rounded): ``stem_int8``, then the 13 blocks on int8 activations.
    The precision dial does not apply to the int8 path (as in the
    reference): its float convs always run "highest"."""
    with precision_scope("highest"):
        a = stem_int8(qparams, x)
        for i in range(1, len(MOBILENET_V1_BLOCKS) + 1):
            a = block_int8(qparams, i, a)
    return a.permute(0, 2, 3, 1)


def multihead_apply_int8(qparams: Dict, x) -> MultiHeadOutput:
    """int8 forward with the output contract of ``multihead_apply``.

    x: (N, H, W, 3) preprocessed f32 (BGR, ImageNet means subtracted)."""
    h = mobilenet_backbone_int8(qparams["backbone"], x)
    identity = torch.mean(h, dim=(1, 2))        # == global_pooling/Mean
    with precision_scope("highest"):
        f = torch.relu(dense(identity, qparams["feats"]["kernel"],
                             qparams["feats"]["bias"]))
        age_logits = dense(f, qparams["age"]["kernel"], qparams["age"]["bias"])
        gender_logit = dense(f, qparams["gender"]["kernel"], qparams["gender"]["bias"])
    return MultiHeadOutput(
        age_probs=torch.softmax(age_logits, dim=-1),
        gender_prob=torch.sigmoid(gender_logit)[:, 0],
        identity=identity,
        feats=f,
    )


def mobilenet_embed_int8(qparams: Dict, x):
    """Face embedding on the int8 backbone: GAP -> (N, 1024) f32."""
    return torch.mean(mobilenet_backbone_int8(qparams, x), dim=(1, 2))
