"""MTCNN P-Net / R-Net / O-Net in PyTorch (conv form).

Counterpart of ``hse_facerec_tf_tpu/models/mtcnn.py``; the network shapes
are listed there. Inputs and outputs keep the reference's NHWC layout at
the function boundary; the nets run NCHW inside. The R-Net and O-Net FC
kernels expect the feature map flattened in NHWC order, so the map is
permuted back before ``flatten`` (an NCHW flatten gives wrong outputs with
no error). Params are ``params.to_torch`` of ``import_mtcnn_params``.
Each net takes the reference's ``precision`` tier (``numerics``) and runs
its convs and FC layers under it. The reference's ``im2col`` form is a TPU
layout workaround and is not here.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core.graphdef import extract_constants, load_graphdef
from ..numerics import precision_scope
from .layers import conv2d, dense, max_pool, prelu


def _conv(x, p, padding="VALID"):
    return conv2d(x, p["kernel"], p["bias"], padding=padding)


def _flatten_nhwc(x):
    return x.permute(0, 2, 3, 1).flatten(1)


def pnet(params: Dict, x, *, precision="highest"):
    """x: (N, H, W, 3) normalized (x-127.5)/128, transposed-feed convention.
    Returns (reg (N, h, w, 4), prob (N, h, w, 2))."""
    with precision_scope(precision):
        x = x.permute(0, 3, 1, 2)
        x = prelu(_conv(x, params["conv1"]), params["prelu1"]["alpha"])
        x = max_pool(x, 2, 2, "SAME")
        x = prelu(_conv(x, params["conv2"]), params["prelu2"]["alpha"])
        x = prelu(_conv(x, params["conv3"]), params["prelu3"]["alpha"])
        cls = _conv(x, params["cls"], "SAME")
        reg = _conv(x, params["reg"], "SAME")
    return (reg.permute(0, 2, 3, 1),
            torch.softmax(cls, dim=1).permute(0, 2, 3, 1))


def rnet(params: Dict, x, *, precision="highest"):
    """x: (N, 24, 24, 3). Returns (reg (N, 4), prob (N, 2))."""
    with precision_scope(precision):
        x = x.permute(0, 3, 1, 2)
        x = prelu(_conv(x, params["conv1"]), params["prelu1"]["alpha"])
        x = max_pool(x, 3, 2, "SAME")
        x = prelu(_conv(x, params["conv2"]), params["prelu2"]["alpha"])
        x = max_pool(x, 3, 2, "VALID")
        x = prelu(_conv(x, params["conv3"]), params["prelu3"]["alpha"])
        x = dense(_flatten_nhwc(x), params["fc"]["kernel"], params["fc"]["bias"])
        x = prelu(x, params["prelu4"]["alpha"])
        cls = dense(x, params["cls"]["kernel"], params["cls"]["bias"])
        reg = dense(x, params["reg"]["kernel"], params["reg"]["bias"])
    return reg, torch.softmax(cls, dim=-1)


def onet(params: Dict, x, *, precision="highest"):
    """x: (N, 48, 48, 3). Returns (reg (N, 4), landmarks (N, 10), prob (N, 2))."""
    with precision_scope(precision):
        x = x.permute(0, 3, 1, 2)
        x = prelu(_conv(x, params["conv1"]), params["prelu1"]["alpha"])
        x = max_pool(x, 3, 2, "SAME")
        x = prelu(_conv(x, params["conv2"]), params["prelu2"]["alpha"])
        x = max_pool(x, 3, 2, "VALID")
        x = prelu(_conv(x, params["conv3"]), params["prelu3"]["alpha"])
        x = max_pool(x, 2, 2, "SAME")
        x = prelu(_conv(x, params["conv4"]), params["prelu4"]["alpha"])
        x = dense(_flatten_nhwc(x), params["fc"]["kernel"], params["fc"]["bias"])
        x = prelu(x, params["prelu5"]["alpha"])
        cls = dense(x, params["cls"]["kernel"], params["cls"]["bias"])
        reg = dense(x, params["reg"]["kernel"], params["reg"]["bias"])
        lmk = dense(x, params["lmk"]["kernel"], params["lmk"]["bias"])
    return reg, lmk, torch.softmax(cls, dim=-1)


def import_mtcnn_params(pb_path: str) -> Dict[str, Dict]:
    """Load {pnet, rnet, onet} numpy param pytrees (reference layouts) from
    the frozen mtcnn.pb; ``params.to_torch`` moves them to a device."""
    consts = extract_constants(load_graphdef(pb_path))

    def cb(prefix, name):  # conv/fc block
        return {
            "kernel": np.asarray(consts[f"{prefix}/{name}/weights"]),
            "bias": np.asarray(consts[f"{prefix}/{name}/biases"]),
        }

    def al(prefix, name):  # prelu alpha
        return {"alpha": np.asarray(consts[f"{prefix}/{name}/alpha"])}

    p = {
        "conv1": cb("pnet", "conv1"), "prelu1": al("pnet", "PReLU1"),
        "conv2": cb("pnet", "conv2"), "prelu2": al("pnet", "PReLU2"),
        "conv3": cb("pnet", "conv3"), "prelu3": al("pnet", "PReLU3"),
        "cls": cb("pnet", "conv4-1"), "reg": cb("pnet", "conv4-2"),
    }
    r = {
        "conv1": cb("rnet", "conv1"), "prelu1": al("rnet", "prelu1"),
        "conv2": cb("rnet", "conv2"), "prelu2": al("rnet", "prelu2"),
        "conv3": cb("rnet", "conv3"), "prelu3": al("rnet", "prelu3"),
        "fc": cb("rnet", "conv4"), "prelu4": al("rnet", "prelu4"),
        "cls": cb("rnet", "conv5-1"), "reg": cb("rnet", "conv5-2"),
    }
    o = {
        "conv1": cb("onet", "conv1"), "prelu1": al("onet", "prelu1"),
        "conv2": cb("onet", "conv2"), "prelu2": al("onet", "prelu2"),
        "conv3": cb("onet", "conv3"), "prelu3": al("onet", "prelu3"),
        "conv4": cb("onet", "conv4"), "prelu4": al("onet", "prelu4"),
        "fc": cb("onet", "conv5"), "prelu5": al("onet", "prelu5"),
        "cls": cb("onet", "conv6-1"), "reg": cb("onet", "conv6-2"),
        "lmk": cb("onet", "conv6-3"),
    }
    return {"pnet": p, "rnet": r, "onet": o}
