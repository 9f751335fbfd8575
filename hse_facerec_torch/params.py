"""Bridge between the reference's numpy parameter pytrees and torch tensors.

The JAX package keeps weights in TF layouts: conv kernels HWIO, depthwise
kernels (H, W, C, mult), dense kernels (in, out). The port's layers take
PyTorch's layouts: OIHW, (C·mult, 1, H, W) and (out, in) for ``F.linear``.
A layer dict is ``{"kernel", "bias"}``, ``{"kernel", "bn": {gamma, beta,
mean, var}}`` (a training backbone) or ``{"alpha"}`` (PReLU); a layer whose
name starts with ``dw`` holds a depthwise kernel. A quantized int8 backbone
(``models/int8_infer.py::quantize_*``, whose ``pw1`` holds ``q``) takes the
int8 layouts. ``to_numpy`` is the inverse for float layers: a checkpoint of
either package loads into the other.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def conv_weight(kernel: np.ndarray) -> np.ndarray:
    """HWIO -> OIHW."""
    return np.ascontiguousarray(np.transpose(kernel, (3, 2, 0, 1)))


def depthwise_weight(kernel: np.ndarray) -> np.ndarray:
    """(H, W, C, mult) -> (C·mult, 1, H, W), the grouped-conv form."""
    h, w, c, m = kernel.shape
    return conv_weight(np.reshape(kernel, (h, w, 1, c * m)))


def dense_weight(kernel: np.ndarray) -> np.ndarray:
    """(in, out) -> (out, in)."""
    return np.ascontiguousarray(np.transpose(kernel))


def _tensor(a, device) -> torch.Tensor:
    # a copy, never a view of the caller's array: training updates in place
    return torch.from_numpy(np.array(a, np.float32)).to(device)


def _layer(name: str, p: Dict, device) -> Dict[str, torch.Tensor]:
    unknown = set(p) - {"kernel", "bias", "alpha", "bn"}
    if unknown:
        # folded-BN "scale" entries: the port takes {"kernel", "bias"} instead
        raise ValueError(f"layer {name!r}: unsupported entries {sorted(unknown)}")
    out = {}
    for key, value in p.items():
        if key == "bn":
            out[key] = {k: _tensor(v, device) for k, v in value.items()}
            continue
        a = np.asarray(value, np.float32)
        if key == "kernel":
            if a.ndim == 4:
                a = depthwise_weight(a) if name.startswith("dw") else conv_weight(a)
            elif a.ndim == 2:
                a = dense_weight(a)
            else:
                raise ValueError(f"layer {name!r}: kernel of rank {a.ndim}")
        out[key] = _tensor(a, device)
    return out


def to_torch(params: Dict, device) -> Dict:
    """Convert a reference param pytree (nested dicts of numpy arrays, layer
    dicts at the leaves) to torch tensors on ``device``. A quantized
    backbone, from the port or from the JAX package, goes through
    ``_int8_backbone``."""
    if "q" in params.get("pw1", {}):
        return _int8_backbone(params, device)
    out = {}
    for name, p in params.items():
        if all(isinstance(v, dict) for v in p.values()):
            out[name] = to_torch(p, device)
        else:
            out[name] = _layer(name, p, device)
    return out


def cast_tree(tree: Dict, dtype) -> Dict:
    """A nested dict of tensors with every leaf cast to ``dtype``."""
    return {k: cast_tree(v, dtype) if isinstance(v, dict) else v.to(dtype)
            for k, v in tree.items()}


def normal(generator: torch.Generator, shape, std) -> np.ndarray:
    """float32 normals of ``shape`` times ``std``, drawn from ``generator``
    (on its device) and returned on the host: the init functions' seeded
    weights, in the reference's layouts."""
    return (torch.randn(tuple(shape), generator=generator, device=generator.device)
            .cpu().numpy() * np.float32(std))


def tree_to_torch(tree: Dict, device, layer: str = "") -> Dict:
    """Any nested dict of numpy arrays (the backbones of ``models/{arcface,
    bknet,inception_resnet,mobilenet_v2,ssrnet,vgg16,wide_resnet}.py``,
    whose pytrees mix layer dicts, BN dicts and bare kernels) -> float32
    tensors on ``device``, by rank: a 4-D kernel HWIO -> OIHW, or (H, W, C,
    1) -> (C, 1, H, W) where its key or its layer's name starts with
    ``dw``; a 2-D kernel (in, out) -> (out, in); anything else as it is."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out[key] = tree_to_torch(value, device, key)
            continue
        a = np.asarray(value, np.float32)
        if a.ndim == 4:
            dw = key.startswith("dw") or layer.startswith("dw")
            a = depthwise_weight(a) if dw else conv_weight(a)
        elif a.ndim == 2:
            a = dense_weight(a)
        out[key] = _tensor(a, device)
    return out


def _numpy_leaf(layer: str, key: str, value) -> np.ndarray:
    if not isinstance(value, torch.Tensor):
        return np.asarray(value)           # already in the reference's layout
    a = value.detach().cpu().numpy()
    if key == "kernel" and a.ndim == 4:
        if layer.startswith("dw"):         # (C, 1, H, W) -> (H, W, C, 1)
            return np.ascontiguousarray(np.transpose(a, (2, 3, 0, 1)))
        return np.ascontiguousarray(np.transpose(a, (2, 3, 1, 0)))  # OIHW -> HWIO
    if key == "kernel" and a.ndim == 2:    # (out, in) -> (in, out)
        return np.ascontiguousarray(a.T)
    return a


def to_numpy(tree: Dict, layer: str = "") -> Dict:
    """The inverse of ``to_torch`` for float layers: a tree of torch tensors
    (and, untouched, numpy arrays) -> numpy arrays in the reference's keys
    and layouts (HWIO, (H, W, C, 1), (in, out))."""
    return {k: to_numpy(v, k) if isinstance(v, dict) else _numpy_leaf(layer, k, v)
            for k, v in tree.items()}


# the JAX package's TPU lane packing of a pointwise layer; K4 needs none
_TPU_PACKED = {"wp", "scale_p", "bias_p"}


def _int8_backbone(qparams: Dict, device) -> Dict:
    """Quantized backbone layers: a pointwise layer becomes {"q": (Cout,
    Cin) int8, "scale", "bias"}, the (N, K) weight K4 takes (the JAX
    package's TPU-packed keys are ignored); the float kernels of conv1 and
    the depthwise layers are rounded to bf16 once here, since the int8 path
    only ever reads them so, and laid out channels-last as the activations
    they meet (so the conv does not copy them on every call)."""
    out = {}
    for name, p in qparams.items():
        if name.startswith("pw"):
            unknown = set(p) - {"q", "scale", "bias"} - _TPU_PACKED
            if "q" not in p or unknown:
                raise ValueError(f"layer {name!r}: a quantized backbone's pointwise "
                                 f"layer holds q, scale and bias, got {sorted(p)}")
            q = np.ascontiguousarray(np.asarray(p["q"], np.int8).T)
            out[name] = {"q": torch.from_numpy(q).to(device)}
            for key in ("scale", "bias"):
                out[name][key] = torch.from_numpy(
                    np.ascontiguousarray(p[key], np.float32)).to(device)
        else:
            layer = _layer(name, p, device)
            layer["kernel"] = layer["kernel"].to(torch.bfloat16).to(torch.float32) \
                .contiguous(memory_format=torch.channels_last)
            out[name] = layer
    return out
