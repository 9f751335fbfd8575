"""Resize ops of the analyze path: the cv2 INTER_AREA scale pyramid and the
per-box bilinear crop+resize.

Counterpart of ``hse_facerec_tf_tpu/ops/resize.py``. Each 1-D resampling is
a small weight matrix applied as a matmul, as in the reference.
``crop_resize_bilinear`` is the plain PyTorch version of the CUDA crop
kernel (``ops/kernels/crop.py``): the CPU path and the kernel's oracle.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..numerics import div_const, fma


@functools.lru_cache(maxsize=256)
def _area_weights_cv2(src: int, dst: int) -> np.ndarray:
    """cv2.INTER_AREA 1-D weights: pixel-area overlap averaging.

    Each target cell i covers source interval [i*s, (i+1)*s), s = src/dst;
    source pixels contribute proportionally to their overlap. For upscale
    (s < 1) this degenerates to nearest — same as cv2's area path."""
    w = np.zeros((dst, src), dtype=np.float32)
    s = src / dst
    for i in range(dst):
        lo = i * s
        hi = (i + 1) * s
        j0 = int(np.floor(lo))
        j1 = min(int(np.ceil(hi)), src)
        for j in range(j0, j1):
            overlap = min(hi, j + 1) - max(lo, j)
            if overlap > 0:
                w[i, j] = overlap / s
    return w


def resize_pyramid(img, out_hws: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """cv2 INTER_AREA resize of one (H, W, C) image to several sizes: the
    row passes of all levels stack into one (Σoh, H) matmul, the column
    passes run per level."""
    h, w, c = img.shape
    dev = img.device
    stacked = torch.from_numpy(
        np.concatenate([_area_weights_cv2(h, oh) for oh, _ in out_hws])).to(dev)
    x = img.to(torch.float32)
    rows = (stacked @ x.reshape(h, w * c)).reshape(-1, w, c)
    outs = []
    off = 0
    for oh, ow in out_hws:
        mw = torch.from_numpy(_area_weights_cv2(w, ow)).to(dev)
        outs.append(torch.einsum("pw,owc->opc", mw, rows[off:off + oh]))
        off += oh
    return outs


def _hat_weights(coord, size: int, clamp: bool):
    """w[n, i, j] = max(0, 1 - |j - coord[n, i]|): the two bilinear taps per
    sample. ``clamp`` pulls coords into [0, size-1] first (border
    replicate); without it out-of-range samples weigh zero everywhere (the
    reference's black crop buffers)."""
    if clamp:
        coord = torch.clamp(coord, 0.0, size - 1.0)
    j = torch.arange(size, dtype=torch.float32, device=coord.device)
    return torch.clamp(1.0 - torch.abs(j[None, None, :] - coord[..., None]),
                       min=0.0)


def _crop_weights(boxes, H: int, W: int, out_size: int, supersample: int,
                  outside: str):
    """Per-box row/column hat-weight matrices ((N, out, H), (N, out, W))."""
    s = supersample * out_size
    boxes = boxes.to(torch.float32)
    y1, x1, y2, x2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    idx = div_const(torch.arange(s, dtype=torch.float32, device=boxes.device)
                    + 0.5, s)
    ys = fma(idx[None, :], (y2 - y1)[:, None], y1[:, None]) - 0.5  # (N, s)
    xs = fma(idx[None, :], (x2 - x1)[:, None], x1[:, None]) - 0.5
    clamp = outside == "clamp"
    R = _hat_weights(ys, H, clamp)                                # (N, s, H)
    C = _hat_weights(xs, W, clamp)                                # (N, s, W)
    if supersample > 1:
        # fold the s×s box filter into the weight matrices
        R = R.reshape(R.shape[0], out_size, supersample, H).mean(dim=2)
        C = C.reshape(C.shape[0], out_size, supersample, W).mean(dim=2)
    return R, C


def crop_resize_bilinear(img, boxes, out_size: int, supersample: int = 2,
                         outside: str = "clamp"):
    """Batched crop + resize with supersampled bilinear sampling.

    img: (H, W, C) float32; boxes: (N, 4) [y1, x1, y2, x2] pixel coords.
    Returns (N, out_size, out_size, C). The (s·out)² bilinear sample grid
    (cv2 half-pixel convention) is averaged s×s, approximating INTER_AREA.
    ``outside``: 'clamp' replicates border pixels; 'zero' reads
    out-of-image pixels as black."""
    img = img.to(torch.float32)
    H, W, C = img.shape
    R, Cw = _crop_weights(boxes, H, W, out_size, supersample, outside)
    rows = (R @ img.reshape(H, W * C)).reshape(R.shape[0], out_size, W, C)
    return torch.einsum("niwc,njw->nijc", rows, Cw)
