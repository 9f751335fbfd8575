"""Plain reference of the ArcFace IResNet embedder (Deng et al.,
arXiv:1801.07698; InsightFace ``fresnet`` unit_v3), in float32 PyTorch.

Input: RGB uint8 face crops (N, 112, 112, 3), as the benchmark hands them
to the program. Scaled ``(x - 127.5) / 127.5``; conv0 3x3 -> BN -> PReLU;
per unit BN -> conv 3x3 -> BN -> PReLU -> conv 3x3 (the unit's stride) ->
BN, plus the shortcut (a 1x1 conv and BN where the shape changes); BN ->
``pre_fc1`` on the NHWC-flattened map -> BN1d (``fc1``); rows L2-normalised.
BN eps 2e-5, 3x3 convs padded 1 on every side. Weights come as the
benchmark made them: HWIO convs, (in, out) dense, BN dicts. Nothing here
imports the program."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference.common import fp32_mode, tf32

BN_EPS = 2e-5


def _t(a, device):
    if isinstance(a, torch.Tensor):
        return a
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def _tree(params: Dict, device) -> Dict:
    """The weights on ``device`` once, in their own layouts."""
    return {k: _tree(v, device) if isinstance(v, dict) else _t(v, device)
            for k, v in params.items()}


def _conv_w(a, device):
    return _t(a, device).permute(3, 2, 0, 1).contiguous()      # HWIO -> OIHW


def _bn(x, p, device):
    g, b = _t(p["gamma"], device), _t(p["beta"], device)
    m, v = _t(p["mean"], device), _t(p["var"], device)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return (x - m.reshape(shape)) / torch.sqrt(v.reshape(shape) + BN_EPS) \
        * g.reshape(shape) + b.reshape(shape)


def _fit_bn(x, p, device):
    """BN whose moments are first set from ``x``: the mean over every axis
    but the channel's, and the variance times the factor ``p`` holds."""
    dims = [0] + list(range(2, x.dim()))
    p["mean"] = x.mean(dim=dims)
    p["var"] = x.var(dim=dims, unbiased=False) * _t(p["var"], device)
    return _bn(x, p, device)


def _prelu(x, alpha, device):
    a = _t(alpha, device).reshape(1, -1, 1, 1)
    return torch.where(x >= 0, x, a * x)


def _conv(x, w, stride, device):
    w = _conv_w(w, device)
    return F.conv2d(tf32(x), tf32(w), stride=stride, padding=(w.shape[-1] - 1) // 2)


def _units(params: Dict):
    stage = 1
    while f"stage{stage}_unit1" in params:
        unit = 1
        while f"stage{stage}_unit{unit}" in params:
            yield params[f"stage{stage}_unit{unit}"], 2 if unit == 1 else 1
            unit += 1
        stage += 1


@torch.no_grad()
def embed(params: Dict, crops: np.ndarray, device, cfg: Dict, fp32: str = "ieee",
          block: int = 64) -> torch.Tensor:
    """(N, 112, 112, 3) uint8 -> (N, D) float32 unit rows, on ``device``,
    in blocks of ``block`` crops, with float32 convs and matmuls at
    ``fp32`` ("ieee", or "tf32" for the control). ``cfg`` (the
    configuration) fixes nothing here that the weights do not."""
    tp = _tree(params, device)
    with fp32_mode(fp32):
        return torch.cat([_forward(tp, crops[i:i + block], device)
                          for i in range(0, len(crops), block)])


@torch.no_grad()
def fit_moments(params: Dict, crops: np.ndarray, device) -> Dict:
    """``params`` with every BN's mean and variance set, in the order the
    forward meets them, from what reaches that BN on ``crops`` in IEEE
    float32: the variance leaf comes in as a factor and leaves as the
    measured variance times it. The other leaves are returned as given."""
    tp = _tree(params, device)
    with fp32_mode("ieee"):
        _forward(tp, crops, device, bn=_fit_bn)

    def host(src, fitted):
        return {k: host(v, fitted[k]) if isinstance(v, dict)
                else (fitted[k].cpu().numpy() if k in ("mean", "var") else v)
                for k, v in src.items()}

    return host(params, tp)


def _forward(params: Dict, crops: np.ndarray, device, bn=_bn) -> torch.Tensor:
    x = torch.as_tensor(crops, device=device).to(torch.float32)
    x = ((x - 127.5) / 127.5).permute(0, 3, 1, 2)
    h = _prelu(bn(_conv(x, params["conv0"], 1, device), params["bn0"], device),
               params["relu0_alpha"], device)
    for p, stride in _units(params):
        r = bn(h, p["bn1"], device)
        r = _conv(r, p["conv1"], 1, device)
        r = _prelu(bn(r, p["bn2"], device), p["relu1_alpha"], device)
        r = bn(_conv(r, p["conv2"], stride, device), p["bn3"], device)
        sc = (bn(_conv(h, p["conv1sc"], stride, device), p["sc"], device)
              if "conv1sc" in p else h)
        h = r + sc
    h = bn(h, params["bn1"], device)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    h = tf32(h) @ tf32(_t(params["pre_fc1"]["kernel"], device)) \
        + _t(params["pre_fc1"]["bias"], device)
    h = bn(h, params["fc1"], device)
    return h / torch.linalg.vector_norm(h, dim=1, keepdim=True).clamp_min(1e-12)
