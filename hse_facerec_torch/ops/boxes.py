"""Box math for the MTCNN cascade, on fixed-size masked tensors.

Counterpart of ``hse_facerec_tf_tpu/ops/boxes.py``. Boxes are (..., N, 4)
[x1, y1, x2, y2] in the reference's 1-indexed convention (+1 widths); a
leading lane dimension batches images, each lane computed as on its own.
Top-k selections keep the lowest index first on ties (``numerics.top_k``).
"""

from __future__ import annotations

import torch

from ..numerics import div_const, fma, top_k

STRIDE = 2
CELLSIZE = 12


def bbreg(boxes, reg):
    """Calibrate boxes by regression offsets (reference ``bbreg`` :354-367)."""
    w = boxes[..., 2] - boxes[..., 0] + 1.0
    h = boxes[..., 3] - boxes[..., 1] + 1.0
    return torch.stack([
        fma(reg[..., 0], w, boxes[..., 0]),
        fma(reg[..., 1], h, boxes[..., 1]),
        fma(reg[..., 2], w, boxes[..., 2]),
        fma(reg[..., 3], h, boxes[..., 3]),
    ], dim=-1)


def bbreg_stage1(boxes, reg):
    """Stage-1 refinement: widths WITHOUT the +1 (reference :526-531)."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return torch.stack([
        fma(reg[..., 0], w, boxes[..., 0]),
        fma(reg[..., 1], h, boxes[..., 1]),
        fma(reg[..., 2], w, boxes[..., 2]),
        fma(reg[..., 3], h, boxes[..., 3]),
    ], dim=-1)


def rerec(boxes):
    """Expand boxes to squares around their centers (reference :467-476)."""
    h = boxes[..., 3] - boxes[..., 1]
    w = boxes[..., 2] - boxes[..., 0]
    l = torch.maximum(w, h)
    x1 = boxes[..., 0] + w * 0.5 - l * 0.5
    y1 = boxes[..., 1] + h * 0.5 - l * 0.5
    return torch.stack([x1, y1, x1 + l, y1 + l], dim=-1)


def fix(x):
    """Truncate toward zero (np.fix)."""
    return torch.trunc(x)


def take_rows(a, idx):
    """``a[..., idx, :]`` per lane: a (..., N, *rest) gathered by idx
    (..., k) along the box axis -> (..., k, *rest)."""
    lead = idx.dim() - 1
    idx = idx.reshape(idx.shape + (1,) * (a.dim() - idx.dim()))
    return torch.take_along_dim(a, idx, dim=lead)


def generate_boxes(prob_map, reg_map, scale: float, threshold: float,
                   max_boxes: int):
    """P-Net heatmaps (..., gx, gy) and reg maps (..., gx, gy, 4), in the
    transposed-feed orientation (first spatial axis = image x) -> (boxes
    (..., K, 4), scores (..., K), reg (..., K, 4), valid (..., K)), K =
    max_boxes: each lane's top-K cells by score, cells below ``threshold``
    masked invalid, zero-padded when the map has fewer than K cells."""
    gx, gy = prob_map.shape[-2:]
    lead = prob_map.shape[:-2]
    flat_scores = prob_map.reshape(*lead, gx * gy)
    k = min(max_boxes, gx * gy)
    top_scores, top_idx = top_k(flat_scores, k)
    ii = (top_idx // gy).to(torch.float32)
    jj = (top_idx % gy).to(torch.float32)
    x1 = fix(div_const(STRIDE * ii + 1.0, scale))
    y1 = fix(div_const(STRIDE * jj + 1.0, scale))
    x2 = fix(div_const(STRIDE * ii + CELLSIZE, scale))
    y2 = fix(div_const(STRIDE * jj + CELLSIZE, scale))
    boxes = torch.stack([x1, y1, x2, y2], dim=-1)
    # reference quirk (facial_analysis.py:381-386): when exactly ONE cell
    # of an image passes the threshold, its reg maps are flipud'd before the
    # gather — reproduced bug-for-bug for parity, lane by lane.
    n_above = torch.sum(flat_scores >= threshold, dim=-1)
    reg_plain = take_rows(reg_map.reshape(*lead, gx * gy, 4), top_idx)
    reg_flip = take_rows(torch.flip(reg_map, dims=(-3,)).reshape(*lead, gx * gy, 4),
                         top_idx)
    reg = torch.where((n_above == 1)[..., None, None], reg_flip, reg_plain)
    valid = top_scores >= threshold
    if k < max_boxes:
        pad = max_boxes - k
        boxes = torch.cat([boxes, boxes.new_zeros((*lead, pad, 4))], dim=-2)
        top_scores = torch.cat([top_scores, top_scores.new_zeros((*lead, pad))], dim=-1)
        reg = torch.cat([reg, reg.new_zeros((*lead, pad, 4))], dim=-2)
        valid = torch.cat([valid, valid.new_zeros((*lead, pad))], dim=-1)
    return boxes, top_scores, reg, valid


def select_top(boxes, scores, valid, extra, k: int):
    """Keep each lane's top-k valid entries by score; ``extra`` (a (..., N,
    ...) tensor) is gathered alongside. Returns (boxes, scores, valid,
    extra), k entries a lane."""
    masked = torch.where(valid, scores, torch.full_like(scores, -torch.inf))
    top_scores, idx = top_k(masked, k)
    new_valid = torch.isfinite(top_scores)
    return (take_rows(boxes, idx), torch.where(new_valid, top_scores, 0.0),
            new_valid, take_rows(extra, idx))
