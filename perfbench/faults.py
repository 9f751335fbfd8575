"""Faults planted in the program's IResNet forward
(``hse_facerec_torch.models.arcface``), each of the kind that a fused or
folded BN/PReLU pass could bring: the comparison of the ArcFace cells has
to come out not correct under every one. The CPU tests plant them at a
tiny size; ``python -m perfbench.calibrate --faults ...`` reads them on the
card at the cell's own size."""

from __future__ import annotations

import contextlib
from unittest import mock

import torch

BN_EPS = 2e-5


def _bn(inv_of=torch.rsqrt, mean=True, beta=True):
    """The port's BN, ``(x - mean) * (gamma * inv_of(var + eps)) + beta``,
    with the mean or the beta left out on request."""
    def bn(x, p, eps: float = BN_EPS):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        scale = p["gamma"] * inv_of(p["var"] + eps)
        h = x - p["mean"].reshape(shape) if mean else x
        h = h * scale.reshape(shape)
        return h + p["beta"].reshape(shape) if beta else h
    return bn


def _prelu_flipped(x, alpha):
    """Each channel gets another channel's slope."""
    return torch.where(x >= 0, x, x * alpha.flip(0).reshape(1, -1, 1, 1))


# name -> (the arcface module's function replaced, its replacement)
FAULTS = {
    "bn_dropped": ("_bn", lambda x, p, eps=BN_EPS: x),
    "bn_var_unrooted": ("_bn", _bn(inv_of=lambda v: 1.0 / v)),
    "bn_mean_dropped": ("_bn", _bn(mean=False)),
    "bn_beta_dropped": ("_bn", _bn(beta=False)),
    "prelu_slopes_flipped": ("_prelu", _prelu_flipped),
}


@contextlib.contextmanager
def planted(name: str):
    """The program runs with fault ``name`` inside the block."""
    from hse_facerec_torch.models import arcface

    attr, fn = FAULTS[name]
    with mock.patch.object(arcface, attr, fn):
        yield
