"""The ViT face embedder of InsightFace's ``arcface_torch``
(``recognition/arcface_torch/backbones/vit.py``, ``get_model("vit_l")``,
trained with partial-FC ArcFace on WebFace42M), at inference.

The JAX package has no counterpart; the equations are the source's:

- input RGB 0-255 NHWC, scaled ``(x / 255 - 0.5) / 0.5``;
- a P×P stride-P patch conv with bias (9 on 112²: 12×12 = 144 tokens in
  row-major patch order, the last 112 mod 9 pixel rows and columns unread),
  plus a learned ``pos_embed`` (T, C); no class token;
- ``depth`` pre-norm blocks: ``h = LN₁(x)``; ``qkv = h·W_qkv`` (no bias),
  per head ``softmax(q·kᵀ · D^-½)·v`` over the keys (K5,
  ``ops/kernels/attention.py``); ``x += o·W_o + b_o``;
  ``x += ReLU6(LN₂(x)·W₁ + b₁)·W₂ + b₂``;
- a final LN, the tokens flattened in (token, channel) order, then
  ``Linear(T·C → C, no bias) → BN1d → Linear(C → E, no bias) → BN1d``
  (eps 2e-5); the extractor L2-normalises the rows.

LayerNorm eps 1e-5 and the ReLU6 are the source's class defaults
(``nn.LayerNorm``, ``act_layer=nn.ReLU6``). Dropout, drop-path and patch
masking are training-only and absent. Params are numpy pytrees in the
port's layouts: HWIO patch conv, (in, out) dense, and ``W_qkv`` as (C, 3,
H, D), so that the head count comes with the weights (``to_torch`` places
them as the forward takes them). The forward takes the reference's ``precision``
tier and ``compute_dtype``: every GEMM and the patch conv cast their
operands to ``compute_dtype`` and their output back to float32; LayerNorm,
attention, the residual stream and the head's BNs stay float32.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..numerics import precision_scope
from ..ops.kernels.attention import attention
from ..params import conv_weight, normal

LN_EPS = 1e-5
BN_EPS = 2e-5
VIT_L = {"input_size": 112, "patch_size": 9, "embed_dim": 768, "depth": 24,
         "num_heads": 8, "mlp_ratio": 4, "embedding_dim": 512}


def _linear(x, p, dt):
    """``x·W (+ b)``: the operands in ``dt``, the result float32; ``W``
    placed (out..., in)."""
    w = p["kernel"].flatten(0, -2)
    if dt == torch.float32:
        return F.linear(x, w, p.get("bias"))
    y = F.linear(x.to(dt), w.to(dt)).to(torch.float32)
    return y + p["bias"] if "bias" in p else y


def _layer_norm(x, p):
    return F.layer_norm(x, x.shape[-1:], p["gamma"], p["beta"], LN_EPS)


def _bn(x, p):
    return (x - p["mean"]) * (p["gamma"] * torch.rsqrt(p["var"] + BN_EPS)) + p["beta"]


def _tokens(params: Dict, x, dt):
    """(N, H, W, 3) 0-255 -> (N, T, C): scaled, patch-embedded, positions
    added."""
    x = x.to(torch.float32).div(255.0).sub(0.5).div(0.5).permute(0, 3, 1, 2)
    w = params["patch_embed"]["kernel"]
    t = F.conv2d(x.to(dt), w.to(dt), stride=w.shape[-1]).to(torch.float32)
    t = t + params["patch_embed"]["bias"].reshape(1, -1, 1, 1)
    return t.flatten(2).transpose(1, 2) + params["pos_embed"]


def _block(x, p: Dict, dt):
    heads = p["qkv"]["kernel"].shape[1]
    x = x + _linear(attention(_linear(_layer_norm(x, p["norm1"]), p["qkv"], dt), heads),
                    p["proj"], dt)
    h = F.relu6(_linear(_layer_norm(x, p["norm2"]), p["fc1"], dt), inplace=True)
    return x + _linear(h, p["fc2"], dt)


def _head(params: Dict, x, dt):
    """Final LN, the (token, channel) flatten, then FC-BN-FC-BN."""
    x = _layer_norm(x, params["norm"]).reshape(x.shape[0], -1)
    x = _bn(_linear(x, params["fc1"], dt), params["bn1"])
    return _bn(_linear(x, params["fc2"], dt), params["bn2"])


def num_blocks(params: Dict) -> int:
    n = 0
    while f"block{n}" in params:
        n += 1
    return n


def vit_embed(params: Dict, x, *, precision="highest",
              compute_dtype=torch.float32) -> torch.Tensor:
    """(N, H, W, 3) RGB 0-255 -> (N, E) embedding before the L2 norm, with
    ``params`` as ``to_torch`` places them."""
    dt = compute_dtype
    with precision_scope(precision):
        h = _tokens(params, x, dt)
        for i in range(num_blocks(params)):
            h = _block(h, params[f"block{i}"], dt)
        return _head(params, h, dt)


def to_torch(params: Dict, device) -> Dict:
    """The numpy tree as the forward takes it, float32 on ``device``: the
    patch conv OIHW, dense kernels with the input axis last ((out, in),
    ``W_qkv`` (3, H, D, C)), the rest as it is."""
    def place(tree, layer=""):
        out = {}
        for key, value in tree.items():
            if isinstance(value, dict):
                out[key] = place(value, key)
                continue
            a = np.asarray(value, np.float32)
            if key == "kernel":
                a = conv_weight(a) if layer == "patch_embed" else np.moveaxis(a, 0, -1)
            out[key] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return out

    return place(params)


def init_vit_params(generator: torch.Generator, input_size: int = 112, patch_size: int = 9,
                    embed_dim: int = 768, depth: int = 24, num_heads: int = 8,
                    mlp_ratio: int = 4, embedding_dim: int = 512) -> Dict:
    """Seeded params in the source's initialisation (every Linear, the
    patch conv and ``pos_embed`` N(0, 0.02²), biases 0, LN and BN at
    identity), numpy, in the port's layouts."""
    c, hidden = embed_dim, embed_dim * mlp_ratio
    tokens = (input_size // patch_size) ** 2

    def dense(n_in, n_out, bias=True):
        p = {"kernel": normal(generator, (n_in,) + tuple(np.atleast_1d(n_out)), 0.02)}
        if bias:
            p["bias"] = np.zeros(n_out, np.float32)
        return p

    def ln(ch):
        return {"gamma": np.ones(ch, np.float32), "beta": np.zeros(ch, np.float32)}

    def bn(ch):
        return {**ln(ch), "mean": np.zeros(ch, np.float32), "var": np.ones(ch, np.float32)}

    params: Dict = {
        "patch_embed": {"kernel": normal(generator, (patch_size, patch_size, 3, c), 0.02),
                        "bias": np.zeros(c, np.float32)},
        "pos_embed": normal(generator, (tokens, c), 0.02)}
    for i in range(depth):
        params[f"block{i}"] = {"norm1": ln(c),
                               "qkv": dense(c, (3, num_heads, c // num_heads), bias=False),
                               "proj": dense(c, c), "norm2": ln(c),
                               "fc1": dense(c, hidden), "fc2": dense(hidden, c)}
    params["norm"] = ln(c)
    params["fc1"] = dense(tokens * c, c, bias=False)
    params["bn1"] = bn(c)
    params["fc2"] = dense(c, embedding_dim, bias=False)
    params["bn2"] = bn(embedding_dim)
    return params
