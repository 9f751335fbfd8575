"""The Swin Transformer (Liu et al., ICCV 2021, arXiv:2103.14030;
``microsoft/Swin-Transformer``, ``models/swin_transformer.py``), Swin-T
(``configs/swin/swin_tiny_patch4_window7_224.yaml``), as face recognition
runs it (SwinFace, ``lxq1000/SwinFace``): on the 112² aligned crop with a
2×2 patch stem, which keeps the published 56×56 token grid, at inference.

The JAX package has no counterpart; the equations are the source's:

- input RGB 0-255 NHWC, scaled ``(x / 255 - 0.5) / 0.5``;
- a P×P stride-P patch conv with bias, then LN (``patch_norm``), giving the
  (N, R, R, C) map; no absolute position embedding;
- stage s: R = 56 / 2^s, C = 96 · 2^s, H = 3 · 2^s heads of 32. Block i:
  ``x += proj(WA(qkv(LN₁(x))))``, ``x += fc₂(GELU(fc₁(LN₂(x))))`` (exact
  GELU), ``WA`` windowed attention over 7 x 7 windows (K8,
  ``ops/kernels/attention.py::window_attention``) with the relative-position
  bias, over windows shifted by 3 (the map rolled by -3, a -100 mask
  between the rolled map's regions) when i is odd and R > 7; at R = 7 the
  window is the whole map and the shift 0, as the source sets it;
- after stages 1-3, patch merging: ``x[0::2, 0::2]``, ``x[1::2, 0::2]``,
  ``x[0::2, 1::2]``, ``x[1::2, 1::2]`` concatenated, LN(4C), Linear(4C →
  2C, no bias);
- the head: a final LN, the mean over the tokens, then ``Linear(C → C, no
  bias) → BN1d → Linear(C → E, no bias) → BN1d`` (eps 2e-5), the FC-BN-FC-BN
  form of ``models/vit.py``'s head on Swin's pooled token; the extractor
  L2-normalises the rows.

LayerNorm eps 1e-5. Dropout and drop-path are training-only and absent.
The block's LN₁ and qkv GEMM run on the map as it lies, since both are per
token: on a card K8 gathers each window from the rolled coordinates and
writes each row back in place, so no roll, partition or reverse copy
remains; the CPU takes ``window_attention_plain``, the source's order.
Params are numpy pytrees in the port's layouts: HWIO patch conv, (in, out)
dense, ``W_qkv`` as (C, 3, H, D) with a (3·H·D) bias, and each block's
(2·7−1)² x H bias table (``to_torch`` places them as the forward takes them,
the table gathered once into the (H, 49, 49) bias). The forward takes the
reference's ``precision`` tier and ``compute_dtype`` as ``models/vit.py``
does: the GEMMs and the patch conv in ``compute_dtype``, LayerNorm,
attention, the residual stream and the head's BNs float32.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..numerics import precision_scope
from ..ops.kernels.attention import relative_position_index, window_attention
from ..params import conv_weight, normal
from .vit import _bn, _layer_norm, _linear, num_blocks

SWIN_T = {"input_size": 112, "patch_size": 2, "embed_dim": 96, "depths": (2, 2, 6, 2),
          "num_heads": (3, 6, 12, 24), "window_size": 7, "mlp_ratio": 4,
          "embedding_dim": 512}


def _stem(params: Dict, x, dt):
    """(N, H, W, 3) 0-255 -> (N, R, R, C): scaled, patch-embedded, LN."""
    x = x.to(torch.float32).div(255.0).sub(0.5).div(0.5).permute(0, 3, 1, 2)
    w = params["patch_embed"]["kernel"]
    t = F.conv2d(x.to(dt), w.to(dt), stride=w.shape[-1]).to(torch.float32)
    t = t + params["patch_embed"]["bias"].reshape(1, -1, 1, 1)
    return _layer_norm(t.permute(0, 2, 3, 1), params["patch_norm"])


def _block(x, p: Dict, i: int, dt):
    """Block ``i`` of a stage on the (N, R, R, C) map."""
    heads, window = p["qkv"]["kernel"].shape[1], window_size(p)
    shift = shift_of(i, x.shape[1], window)
    qkv = _linear(_layer_norm(x, p["norm1"]), p["qkv"], dt)
    x = x + _linear(window_attention(qkv, heads, window, shift, p["attn_bias"]),
                    p["proj"], dt)
    h = F.gelu(_linear(_layer_norm(x, p["norm2"]), p["fc1"], dt))
    return x + _linear(h, p["fc2"], dt)


def _merge(x, p: Dict, dt):
    """Patch merging: the 2x2 gather in the source's order, LN(4C), then
    Linear(4C -> 2C, no bias)."""
    x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                  dim=-1)
    return _linear(_layer_norm(x, p["norm"]), p["reduction"], dt)


def _head(params: Dict, x, dt):
    """Final LN, the mean over the tokens, then FC-BN-FC-BN."""
    x = _layer_norm(x, params["norm"]).mean(dim=(1, 2))
    x = _bn(_linear(x, params["fc1"], dt), params["bn1"])
    return _bn(_linear(x, params["fc2"], dt), params["bn2"])


def window_size(block: Dict) -> int:
    """The window side of a placed block, from its (H, w², w²) bias."""
    return int(round(block["attn_bias"].shape[-1] ** 0.5))


def shift_of(i: int, size: int, window: int) -> int:
    """Block ``i``'s shift on a ``size`` x ``size`` map: half the window on
    odd blocks while the map holds more than one window, else 0."""
    return window // 2 if i % 2 and size > window else 0


def num_stages(params: Dict) -> int:
    n = 0
    while f"stage{n}" in params:
        n += 1
    return n


def swin_embed(params: Dict, x, *, precision="highest",
               compute_dtype=torch.float32) -> torch.Tensor:
    """(N, H, W, 3) RGB 0-255 -> (N, E) embedding before the L2 norm, with
    ``params`` as ``to_torch`` places them."""
    dt = compute_dtype
    with precision_scope(precision):
        h = _stem(params, x, dt)
        for s in range(num_stages(params)):
            stage = params[f"stage{s}"]
            for i in range(num_blocks(stage)):
                h = _block(h, stage[f"block{i}"], i, dt)
            if "merge" in stage:
                h = _merge(h, stage["merge"], dt)
        return _head(params, h, dt)


def to_torch(params: Dict, device) -> Dict:
    """The numpy tree as the forward takes it, float32 on ``device``: the
    patch conv OIHW, dense kernels with the input axis last ((out, in),
    ``W_qkv`` (3, H, D, C)), each block's (169, H) table gathered once into
    its (H, 49, 49) ``attn_bias``; the rest as it is."""
    def place(tree, layer=""):
        out = {}
        for key, value in tree.items():
            if isinstance(value, dict):
                out[key] = place(value, key)
                continue
            a = np.asarray(value, np.float32)
            if key == "rel_bias_table":
                window = (int(round(a.shape[0] ** 0.5)) + 1) // 2
                index = relative_position_index(window).reshape(-1).numpy()
                key, a = "attn_bias", a[index].reshape(window ** 2, window ** 2, -1)
                a = np.moveaxis(a, -1, 0)
            elif key == "kernel":
                a = conv_weight(a) if layer == "patch_embed" else np.moveaxis(a, 0, -1)
            out[key] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return out

    return place(params)


def init_swin_params(generator: torch.Generator, input_size: int = 112, patch_size: int = 2,
                     embed_dim: int = 96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24),
                     window_size: int = 7, mlp_ratio: int = 4,
                     embedding_dim: int = 512) -> Dict:
    """Seeded params in the source's initialisation (every Linear, the
    patch conv and each bias table N(0, 0.02²), biases 0, LN and BN at
    identity), numpy, in the port's layouts."""
    def dense(n_in, n_out, bias=True):
        p = {"kernel": normal(generator, (n_in,) + tuple(np.atleast_1d(n_out)), 0.02)}
        if bias:
            p["bias"] = np.zeros(int(np.prod(n_out)), np.float32)
        return p

    def ln(ch):
        return {"gamma": np.ones(ch, np.float32), "beta": np.zeros(ch, np.float32)}

    def bn(ch):
        return {**ln(ch), "mean": np.zeros(ch, np.float32), "var": np.ones(ch, np.float32)}

    c = embed_dim
    params: Dict = {
        "patch_embed": {"kernel": normal(generator, (patch_size, patch_size, 3, c), 0.02),
                        "bias": np.zeros(c, np.float32)},
        "patch_norm": ln(c)}
    for s, (depth, heads) in enumerate(zip(depths, num_heads)):
        stage: Dict = {}
        for i in range(depth):
            stage[f"block{i}"] = {
                "norm1": ln(c), "qkv": dense(c, (3, heads, c // heads)),
                "rel_bias_table": normal(generator, ((2 * window_size - 1) ** 2, heads), 0.02),
                "proj": dense(c, c), "norm2": ln(c),
                "fc1": dense(c, c * mlp_ratio), "fc2": dense(c * mlp_ratio, c)}
        if s < len(depths) - 1:
            stage["merge"] = {"norm": ln(4 * c), "reduction": dense(4 * c, 2 * c, bias=False)}
            c *= 2
        params[f"stage{s}"] = stage
    params["norm"] = ln(c)
    params["fc1"] = dense(c, c, bias=False)
    params["bn1"] = bn(c)
    params["fc2"] = dense(c, embedding_dim, bias=False)
    params["bn2"] = bn(embedding_dim)
    return params
