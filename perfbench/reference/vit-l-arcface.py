"""Plain reference of InsightFace's ViT face embedder (``arcface_torch``,
``backbones/vit.py``, ``get_model("vit_l")``), in float32 PyTorch.

Input: RGB uint8 face crops (N, 112, 112, 3), as the benchmark hands them
to the program. Scaled ``(x / 255 - 0.5) / 0.5``; a P x P stride-P patch
conv with bias, flattened to tokens in row-major patch order, plus
``pos_embed``; per block ``x + proj(attn(LN1(x)))`` then
``x + fc2(ReLU6(fc1(LN2(x))))``, attention per head as the source computes
it: ``(q @ k^T) * D^-0.5``, softmax over the keys, ``@ v``, heads
concatenated per token; a final LN, the tokens flattened in (token,
channel) order, ``Linear -> BN1d -> Linear -> BN1d``; rows L2-normalised
(the extractor's step, not the source module's). LN eps 1e-5, BN eps 2e-5.

Weights come as the benchmark made them (``perfbench/vit.py``): HWIO patch
conv, (in, out) dense, ``W_qkv`` as (C, 3, H, D), whose H must agree with
the configuration's ``num_heads``. Departures from the source: none in the
arithmetic; dropout, drop-path and patch masking are training-only and not
run; the L2 norm is added. Nothing here imports the program."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference.common import fp32_mode, tf32

LN_EPS = 1e-5
BN_EPS = 2e-5


def _tree(params: Dict, device) -> Dict:
    """The weights on ``device`` once, in their own layouts."""
    return {k: _tree(v, device) if isinstance(v, dict)
            else torch.as_tensor(np.asarray(v, np.float32), device=device)
            for k, v in params.items()}


def _dense(x, p):
    w = p["kernel"].reshape(p["kernel"].shape[0], -1)
    y = tf32(x) @ tf32(w)
    return y + p["bias"] if "bias" in p else y


def _ln(x, p):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + LN_EPS) * p["gamma"] + p["beta"]


def _bn(x, p):
    return (x - p["mean"]) / torch.sqrt(p["var"] + BN_EPS) * p["gamma"] + p["beta"]


def _fit_bn(x, p):
    """BN whose moments are first set from ``x``: the batch mean, and the
    batch variance times the factor ``p`` holds."""
    p["mean"] = x.mean(dim=0)
    p["var"] = x.var(dim=0, unbiased=False) * p["var"]
    return _bn(x, p)


def _attention(h, p, heads: int, peaks: Optional[list]):
    n, t, c = h.shape
    qkv = _dense(h, p).reshape(n, t, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]                     # (N, H, T, D)
    a = torch.softmax((tf32(q) @ tf32(k).transpose(-2, -1)) * (c // heads) ** -0.5, dim=-1)
    if peaks is not None:
        peaks.append(a.amax(dim=-1).mean())
    return (tf32(a) @ tf32(v)).transpose(1, 2).reshape(n, t, c)


def _forward(params: Dict, crops, device, heads: int, bn: Callable = _bn,
             peaks: Optional[list] = None) -> torch.Tensor:
    x = torch.as_tensor(crops, device=device).to(torch.float32)
    x = (x / 255.0 - 0.5) / 0.5
    w = params["patch_embed"]["kernel"].permute(3, 2, 0, 1)      # HWIO -> OIHW
    x = F.conv2d(tf32(x.permute(0, 3, 1, 2)), tf32(w), params["patch_embed"]["bias"],
                 stride=w.shape[-1])
    x = x.flatten(2).transpose(1, 2) + params["pos_embed"]
    i = 0
    while f"block{i}" in params:
        p = params[f"block{i}"]
        x = x + _dense(_attention(_ln(x, p["norm1"]), p["qkv"], heads, peaks), p["proj"])
        x = x + _dense(torch.clamp(_dense(_ln(x, p["norm2"]), p["fc1"]), 0.0, 6.0), p["fc2"])
        i += 1
    x = _ln(x, params["norm"]).reshape(x.shape[0], -1)
    x = bn(_dense(x, params["fc1"]), params["bn1"])
    return bn(_dense(x, params["fc2"]), params["bn2"])


def _heads(params: Dict, cfg: Dict) -> int:
    heads = params["block0"]["qkv"]["kernel"].shape[2]
    if heads != cfg["num_heads"]:
        raise ValueError(f"W_qkv holds {heads} heads, the configuration {cfg['num_heads']}")
    return heads


@torch.no_grad()
def embed(params: Dict, crops: np.ndarray, device, cfg: Dict, fp32: str = "ieee",
          block: int = 32) -> torch.Tensor:
    """(N, 112, 112, 3) uint8 -> (N, E) float32 unit rows on ``device``, in
    blocks of ``block`` crops (a block's attention maps are 32 x 8 x 144² f32,
    21 MB), with float32 convs and matmuls at ``fp32`` ("ieee", or "tf32"
    for the control)."""
    heads = _heads(params, cfg)
    tp = _tree(params, device)
    with fp32_mode(fp32):
        out = torch.cat([_forward(tp, crops[i:i + block], device, heads)
                         for i in range(0, len(crops), block)])
    return out / torch.linalg.vector_norm(out, dim=1, keepdim=True).clamp_min(1e-12)


@torch.no_grad()
def fit_moments(params: Dict, crops: np.ndarray, device, cfg: Dict) -> Dict:
    """``params`` with both BN1d's mean and variance set from what reaches
    them on ``crops`` (all in one batch) in IEEE float32: the variance leaf
    comes in as a factor and leaves as the measured variance times it. The
    other leaves are returned as given."""
    heads = _heads(params, cfg)
    tp = _tree(params, device)
    with fp32_mode("ieee"):
        _forward(tp, crops, device, heads, bn=_fit_bn)
    out = dict(params)
    for name in ("bn1", "bn2"):
        out[name] = {**params[name], "mean": tp[name]["mean"].cpu().numpy(),
                     "var": tp[name]["var"].cpu().numpy()}
    return out


@torch.no_grad()
def attention_peak(params: Dict, crops: np.ndarray, device, cfg: Dict) -> float:
    """The largest attention weight of a query row, averaged over every
    row, head, block and crop: 1/T for uniform attention, 1 for one-hot."""
    peaks: list = []
    tp = _tree(params, device)
    with fp32_mode("ieee"):
        _forward(tp, crops, device, _heads(params, cfg), peaks=peaks)
    return float(torch.stack(peaks).mean())
