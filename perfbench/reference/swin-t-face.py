"""Plain reference of a Swin-T face embedder: the Swin Transformer
(arXiv:2103.14030; ``microsoft/Swin-Transformer``,
``models/swin_transformer.py``, Swin-T) with SwinFace's 2x2 patch stem on
the 112 x 112 crop, in float32 PyTorch.

Input: RGB uint8 face crops (N, 112, 112, 3), as the benchmark hands them
to the program. Scaled ``(x / 255 - 0.5) / 0.5``; a P x P stride-P patch
conv with bias and LN; per stage its blocks, as the source's
``SwinTransformerBlock`` computes them: ``shortcut = x``; ``LN1``; the map
rolled by ``-shift`` (shifted blocks); cut into 7 x 7 windows
(``window_partition``); per window ``qkv`` with bias, ``q * D^-0.5``,
``q @ k^T`` plus the relative-position bias gathered from the block's
(2*7-1)^2 x H table by the source's ``relative_position_index``, plus, in
shifted blocks, the source's ``attn_mask`` (-100 between the regions of
its ``img_mask`` slices); softmax; ``@ v``; ``proj``; the windows put back
(``window_reverse``) and rolled by ``+shift``; ``x = shortcut + x``; then
``x + fc2(GELU(fc1(LN2(x))))``. A block is shifted by 3 when its index in
the stage is odd and the map is larger than one window. After stages 1-3
patch merging (``x0 .. x3`` concatenated, LN(4C), Linear(4C -> 2C, no
bias)). Then a final LN, the mean over the tokens, ``Linear -> BN1d ->
Linear -> BN1d``; rows L2-normalised (the extractor's step). LN eps 1e-5,
BN eps 2e-5.

Weights come as the benchmark made them (``perfbench/swin.py``): HWIO
patch conv, (in, out) dense, ``W_qkv`` as (C, 3, H, D) with a (3 H D)
bias, each block's table as (169, H). Departures from the source: the
2x2 stem (SwinFace's, for the 112 x 112 crop) and the FC-BN-FC-BN head
(the configuration's ``assumed``); dropout and drop-path are training-only
and not run; the L2 norm is added. Nothing here imports the program."""

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


def relative_position_index(window: int) -> torch.Tensor:
    """The source's ``relative_position_index``, (window^2, window^2)."""
    coords = torch.stack(torch.meshgrid([torch.arange(window), torch.arange(window)],
                                        indexing="ij"))
    coords_flatten = torch.flatten(coords, 1)
    relative = (coords_flatten[:, :, None] - coords_flatten[:, None, :]).permute(1, 2, 0)
    relative = relative.contiguous()
    relative[:, :, 0] += window - 1
    relative[:, :, 1] += window - 1
    relative[:, :, 0] *= 2 * window - 1
    return relative.sum(-1)


def _partition(x, window: int):
    """The source's ``window_partition``: (N, R, R, C) -> (N nW, w, w, C)."""
    n, r, _, c = x.shape
    x = x.view(n, r // window, window, r // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, window, window, c)


def _reverse(windows, window: int, r: int):
    """The source's ``window_reverse``: (N nW, w, w, C) -> (N, R, R, C)."""
    n = windows.shape[0] // (r // window) ** 2
    x = windows.view(n, r // window, r // window, window, window, -1)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(n, r, r, -1)


def attn_mask(r: int, window: int, shift: int, device) -> torch.Tensor:
    """The source's ``attn_mask`` of a shifted block on an R x R map:
    (nW, w^2, w^2), -100 between tokens of different ``img_mask`` regions."""
    img_mask = torch.zeros((1, r, r, 1), device=device)
    slices = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    cnt = 0
    for hs in slices:
        for ws in slices:
            img_mask[:, hs, ws, :] = cnt
            cnt += 1
    mask_windows = _partition(img_mask, window).view(-1, window * window)
    mask = mask_windows.unsqueeze(1) - mask_windows.unsqueeze(2)
    return mask.masked_fill(mask != 0, float(-100.0)).masked_fill(mask == 0, float(0.0))


def _window_attention(x, p, heads: int, window: int, shift: int,
                      peaks: Optional[list]):
    """LN1's output (N, R, R, C) -> the attention branch's output, before
    the residual add, in the source's order."""
    n, r, _, c = x.shape
    if shift:
        x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
    t = window * window
    xw = _partition(x, window).view(-1, t, c)
    qkv = _dense(xw, p["qkv"]).reshape(-1, t, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]                      # (N nW, H, T, D)
    q = q * (c // heads) ** -0.5
    a = tf32(q) @ tf32(k).transpose(-2, -1)
    index = relative_position_index(window).to(x.device)
    bias = p["rel_bias_table"][index.view(-1)].view(t, t, -1).permute(2, 0, 1).contiguous()
    a = a + bias.unsqueeze(0)
    if shift:
        mask = attn_mask(r, window, shift, x.device)
        nw = mask.shape[0]
        a = a.view(-1, nw, heads, t, t) + mask.unsqueeze(1).unsqueeze(0)
        a = a.view(-1, heads, t, t)
    a = torch.softmax(a, dim=-1)
    if peaks is not None:
        peaks.append(a.amax(dim=-1).mean())
    o = (tf32(a) @ tf32(v)).transpose(1, 2).reshape(-1, t, c)
    o = _reverse(_dense(o, p["proj"]).view(-1, window, window, c), window, r)
    if shift:
        o = torch.roll(o, shifts=(shift, shift), dims=(1, 2))
    return o


def _merge(x, p):
    x0, x1 = x[:, 0::2, 0::2, :], x[:, 1::2, 0::2, :]
    x2, x3 = x[:, 0::2, 1::2, :], x[:, 1::2, 1::2, :]
    return _dense(_ln(torch.cat([x0, x1, x2, x3], -1), p["norm"]), p["reduction"])


def _forward(params: Dict, crops, device, cfg: Dict, bn: Callable = _bn,
             peaks: Optional[list] = None) -> torch.Tensor:
    window = cfg["window_size"]
    x = torch.as_tensor(crops, device=device).to(torch.float32)
    x = (x / 255.0 - 0.5) / 0.5
    w = params["patch_embed"]["kernel"].permute(3, 2, 0, 1)      # HWIO -> OIHW
    x = F.conv2d(tf32(x.permute(0, 3, 1, 2)), tf32(w), params["patch_embed"]["bias"],
                 stride=w.shape[-1])
    x = _ln(x.permute(0, 2, 3, 1), params["patch_norm"])          # (N, R, R, C)
    for s, (depth, heads) in enumerate(zip(cfg["depths"], cfg["num_heads"])):
        stage = params[f"stage{s}"]
        for i in range(depth):
            p = stage[f"block{i}"]
            r = x.shape[1]
            shift = window // 2 if i % 2 and r > window else 0
            x = x + _window_attention(_ln(x, p["norm1"]), p, heads, window, shift, peaks)
            x = x + _dense(F.gelu(_dense(_ln(x, p["norm2"]), p["fc1"])), p["fc2"])
        if "merge" in stage:
            x = _merge(x, stage["merge"])
    x = _ln(x, params["norm"]).mean(dim=(1, 2))
    x = bn(_dense(x, params["fc1"]), params["bn1"])
    return bn(_dense(x, params["fc2"]), params["bn2"])


def _check(params: Dict, cfg: Dict) -> None:
    for s, heads in enumerate(cfg["num_heads"]):
        got = params[f"stage{s}"]["block0"]["qkv"]["kernel"].shape[2]
        if got != heads:
            raise ValueError(f"stage {s}'s W_qkv holds {got} heads, the configuration {heads}")


@torch.no_grad()
def embed(params: Dict, crops: np.ndarray, device, cfg: Dict, fp32: str = "ieee",
          block: int = 32) -> torch.Tensor:
    """(N, 112, 112, 3) uint8 -> (N, E) float32 unit rows on ``device``, in
    blocks of ``block`` crops (a block's stage-1 MLP hidden is 32 x 3136 x
    384 f32, 154 MB), with float32 convs and matmuls at ``fp32`` ("ieee",
    or "tf32" for the control)."""
    _check(params, cfg)
    tp = _tree(params, device)
    with fp32_mode(fp32):
        out = torch.cat([_forward(tp, crops[i:i + block], device, cfg)
                         for i in range(0, len(crops), block)])
    return out / torch.linalg.vector_norm(out, dim=1, keepdim=True).clamp_min(1e-12)


@torch.no_grad()
def fit_moments(params: Dict, crops: np.ndarray, device, cfg: Dict) -> Dict:
    """``params`` with both BN1d's mean and variance set from what reaches
    them on ``crops`` (all in one batch) in IEEE float32: the variance leaf
    comes in as a factor and leaves as the measured variance times it. The
    other leaves are returned as given."""
    _check(params, cfg)
    tp = _tree(params, device)
    with fp32_mode("ieee"):
        _forward(tp, crops, device, cfg, bn=_fit_bn)
    out = dict(params)
    for name in ("bn1", "bn2"):
        out[name] = {**params[name], "mean": tp[name]["mean"].cpu().numpy(),
                     "var": tp[name]["var"].cpu().numpy()}
    return out


@torch.no_grad()
def attention_peak(params: Dict, crops: np.ndarray, device, cfg: Dict) -> float:
    """The largest attention weight of a query row, averaged over every
    row, window, head, block and crop: 1/49 for uniform attention, 1 for
    one-hot."""
    peaks: list = []
    tp = _tree(params, device)
    with fp32_mode("ieee"):
        _forward(tp, crops, device, cfg, peaks=peaks)
    return float(torch.stack(peaks).mean())
