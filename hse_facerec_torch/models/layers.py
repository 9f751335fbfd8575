"""NN building blocks with TF-compatible numerics, on NCHW tensors.

Counterpart of ``hse_facerec_tf_tpu/models/layers.py``. Weights come in
PyTorch layouts (``params.py``). TF's SAME padding puts the odd extra pixel
bottom/right and MaxPool pads with -inf; both are explicit ``F.pad`` calls
here, since ``padding='same'`` and symmetric padding do not match TF (an
even split is passed to the conv as its own padding).

``conv2d``, ``depthwise_conv2d`` and ``dense`` take the reference's
``precision``; their default, None, dispatches under the enclosing
forward's tier (``numerics.precision_scope(None)``: "highest" where no
forward runs).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..numerics import precision_scope


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    out = -(-size // s)
    pad = max((out - 1) * s + k - size, 0)
    return pad // 2, pad - pad // 2


def _pad_same(x, kh: int, kw: int, stride: int, value: float = 0.0):
    top, bottom = _same_pads(x.shape[2], kh, stride)
    left, right = _same_pads(x.shape[3], kw, stride)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom), value=value)
    return x


def bottom_right_edge(shape, weight_shape, stride: int) -> bool:
    """True where ``conv2d``'s SAME padding of an input of ``shape`` (N, C,
    H, W) is one zero row at the bottom and one zero column at the right,
    nothing else: the ``F.pad(x, (0, 1, 0, 1))`` of a 3x3 stride-2 conv on
    an even size."""
    return all(_same_pads(n, k, stride) == (0, 1)
               for n, k in zip(shape[2:], weight_shape[2:]))


def conv2d(x, weight, bias=None, *, stride: int = 1, padding: str = "SAME",
           precision=None, groups: int = 1):
    """NCHW conv with an OIHW weight, TF-compatible SAME padding. Symmetric
    pads go to the conv itself, so only an odd edge (stride 2 on an even
    size) pays an ``F.pad`` copy."""
    pads = (0, 0)
    if padding == "SAME":
        top, bottom = _same_pads(x.shape[2], weight.shape[2], stride)
        left, right = _same_pads(x.shape[3], weight.shape[3], stride)
        if top == bottom and left == right:
            pads = (top, left)
        else:
            x = F.pad(x, (left, right, top, bottom))
    with precision_scope(precision):
        return F.conv2d(x, weight, bias, stride=stride, padding=pads, groups=groups)


def depthwise_conv2d(x, weight, bias=None, *, stride: int = 1,
                     padding: str = "SAME", precision=None):
    """Depthwise conv; ``weight`` is (C·mult, 1, H, W)."""
    return conv2d(x, weight, bias, stride=stride, padding=padding,
                  precision=precision, groups=x.shape[1])


def dense(x, weight, bias=None, *, precision=None):
    """``x @ kernel + bias`` with ``weight`` in (out, in) layout."""
    with precision_scope(precision):
        return F.linear(x, weight, bias)


def prelu(x, alpha):
    """relu(x) - alpha * relu(-x), alpha per channel (dim 1) — the frozen
    MTCNN graph's decomposition."""
    alpha = alpha.reshape((1, -1) + (1,) * (x.dim() - 2))
    return torch.relu(x) - alpha * torch.relu(-x)


def relu6(x):
    return torch.clamp(x, 0.0, 6.0)


def relu6_train(x):
    """ReLU6 with the reference's gradient at its bounds: ``jnp.clip`` is a
    maximum then a minimum, and JAX splits a tie's gradient evenly, so an
    input of exactly 0 or 6 passes half the gradient (``torch.clamp``
    passes all of it). Ties are common in training: a dead channel's BN
    output is exactly ``beta``, 0 at init."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, zero), zero + 6.0)


def max_pool(x, k: int, stride: int, padding: str = "SAME"):
    """TF MaxPool: SAME pads with -inf (never averages padding in)."""
    if padding == "SAME":
        x = _pad_same(x, k, k, stride, value=float("-inf"))
    return F.max_pool2d(x, k, stride)


def global_avg_pool(x):
    """(N, C, H, W) -> (N, C)."""
    return torch.mean(x, dim=(2, 3))


def batch_norm(x, scale, offset, mean, var, *, eps: float = 1e-3):
    """BN over channel dim 1 with the given moments (Keras default eps
    1e-3), written out as the reference writes it:
    ``inv = scale·rsqrt(var + eps)``, ``x·inv + (offset - mean·inv)``."""
    inv = scale * torch.rsqrt(var + eps)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return x * inv.reshape(shape) + (offset - mean * inv).reshape(shape)
