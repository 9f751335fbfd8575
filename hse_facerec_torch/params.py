"""Bridge from the reference's numpy parameter pytrees to torch tensors.

The JAX package keeps weights in TF layouts: conv kernels HWIO, depthwise
kernels (H, W, C, mult), dense kernels (in, out). The port's layers take
PyTorch's layouts: OIHW, (C·mult, 1, H, W) and (out, in) for ``F.linear``.
A layer dict is ``{"kernel", "bias"}`` or ``{"alpha"}`` (PReLU); a layer
whose name starts with ``dw`` holds a depthwise kernel.
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


def _layer(name: str, p: Dict, device) -> Dict[str, torch.Tensor]:
    unknown = set(p) - {"kernel", "bias", "alpha"}
    if unknown:
        # BN or scale entries: the port takes folded inference params only
        raise ValueError(f"layer {name!r}: unsupported entries {sorted(unknown)}")
    out = {}
    for key, value in p.items():
        a = np.asarray(value, np.float32)
        if key == "kernel":
            if a.ndim == 4:
                a = depthwise_weight(a) if name.startswith("dw") else conv_weight(a)
            elif a.ndim == 2:
                a = dense_weight(a)
            else:
                raise ValueError(f"layer {name!r}: kernel of rank {a.ndim}")
        out[key] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return out


def to_torch(params: Dict, device) -> Dict:
    """Convert a reference param pytree (nested dicts of numpy arrays, layer
    dicts at the leaves) to torch tensors on ``device``."""
    out = {}
    for name, p in params.items():
        if all(isinstance(v, dict) for v in p.values()):
            out[name] = to_torch(p, device)
        else:
            out[name] = _layer(name, p, device)
    return out
