"""Numerics mode of the port.

Parity mode is plain fp32: a float32 matmul on the card already runs in full
fp32 by default, but cuDNN convolutions default to TF32, which keeps about
three decimal digits and flips the detector's .5 pixel roundings and its
threshold decisions. ``set_parity_numerics`` turns TF32 off for both.
"""

from __future__ import annotations

import numpy as np
import torch


def set_parity_numerics() -> None:
    """fp32 everywhere: no TF32 in cuBLAS matmuls or cuDNN convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def div_const(x, d: float):
    """``x / d`` for a host constant ``d``, computed as the reference
    computes it: inside ``jax.jit`` XLA rewrites a division by a constant
    into a multiply by the float32 reciprocal of float32(d). A true division
    differs in the last bit, which flips ``fix`` truncations of box corners
    and moves crop sample positions. The explicit multiply also gives the
    same bits on the CPU and on CUDA."""
    return x * float(np.float32(1.0) / np.float32(d))


def fma(a, b, c):
    """``a * b + c`` rounded once to float32, as XLA computes the multiply-
    adds it fuses inside ``jax.jit`` (box regression, landmarks, crop
    sample positions). The float32 product is exact in float64, so the one
    float64 add leaves a single rounding to float32, apart from a double
    rounding that needs a tie at float64 precision."""
    return (a.double() * b.double() + c.double()).float()


def top_k(x, k: int):
    """(values, indices) of the k largest along the last axis, ties by
    lowest index first, as ``lax.top_k`` breaks them: a stable descending
    sort, since ``torch.topk`` promises no tie order on CUDA."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]
