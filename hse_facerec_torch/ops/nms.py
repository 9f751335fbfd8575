"""Masked greedy non-maximum suppression on fixed-size tensors.

Counterpart of ``hse_facerec_tf_tpu/ops/nms.py``: the reference's greedy
MTCNN NMS (``facial_analysis.py:397-428``) as a keep-mask over padded boxes,
solved as a Jacobi fixpoint over a pairwise-overlap matrix, over a leading
lane dimension too. The loop reads its ``changed`` flag on the host once
per round. ``nms_numpy`` is the greedy form itself, on the host.
"""

from __future__ import annotations

import numpy as np
import torch


def pairwise_overlap(boxes, method: str = "union"):
    """(..., N, 4) [x1, y1, x2, y2] -> (..., N, N) overlap ratios (+1 widths)."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1 + 1.0) * (y2 - y1 + 1.0)
    xx1 = torch.maximum(x1[..., :, None], x1[..., None, :])
    yy1 = torch.maximum(y1[..., :, None], y1[..., None, :])
    xx2 = torch.minimum(x2[..., :, None], x2[..., None, :])
    yy2 = torch.minimum(y2[..., :, None], y2[..., None, :])
    w = torch.clamp(xx2 - xx1 + 1.0, min=0.0)
    h = torch.clamp(yy2 - yy1 + 1.0, min=0.0)
    inter = w * h
    if method == "min":
        denom = torch.minimum(area[..., :, None], area[..., None, :])
    else:
        denom = area[..., :, None] + area[..., None, :] - inter
    return inter / torch.clamp(denom, min=1e-10)


def nms_mask(boxes, scores, valid, threshold: float, method: str = "union"):
    """Greedy NMS over padded boxes (..., N, 4) -> keep (..., N) bool, a
    subset of valid, each lane on its own.

    In (score desc, index asc) order the greedy result satisfies
    keep[i] = valid[i] and no higher-ranked kept j overlaps i past the
    threshold; Jacobi iteration from keep = valid reaches it in at most
    longest-suppression-chain rounds. The rounds go on until no lane
    changes; a lane that has converged is a fixpoint and stays, so each
    lane's mask is its single-image mask."""
    n = boxes.shape[-2]
    overlap = pairwise_overlap(boxes, method)
    # rank in (score desc, index asc) order; invalid entries rank last
    key = torch.where(valid, -scores, torch.full_like(scores, torch.inf))
    order = torch.argsort(key, dim=-1, stable=True)
    rank = torch.empty_like(order).scatter_(
        -1, order, torch.arange(n, device=boxes.device).expand_as(order))
    # suppressor[..., j, i]: j outranks i and overlaps it past the threshold
    suppressor = (overlap > threshold) & (rank[..., :, None] < rank[..., None, :])
    keep = valid
    while True:
        keep2 = valid & ~torch.any(suppressor & keep[..., :, None], dim=-2)
        if not bool(torch.any(keep2 != keep)):
            return keep2
        keep = keep2


def nms_numpy(boxes: np.ndarray, scores: np.ndarray, threshold: float,
              method: str = "union") -> np.ndarray:
    """Host-side exact greedy NMS (dynamic shapes), the golden of the
    reference's MTCNN loop: the highest score left is kept and removes the
    boxes overlapping it by more than ``threshold``. Returns the kept
    indices in pick order."""
    if len(boxes) == 0:
        return np.zeros((0,), dtype=np.int64)
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    area = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = np.argsort(scores)
    pick = []
    while order.size > 0:
        i = order[-1]
        pick.append(i)
        rest = order[:-1]
        xx1 = np.maximum(x1[i], x1[rest])
        yy1 = np.maximum(y1[i], y1[rest])
        xx2 = np.minimum(x2[i], x2[rest])
        yy2 = np.minimum(y2[i], y2[rest])
        w = np.maximum(0.0, xx2 - xx1 + 1)
        h = np.maximum(0.0, yy2 - yy1 + 1)
        inter = w * h
        if method == "min":
            o = inter / np.minimum(area[i], area[rest])
        else:
            o = inter / (area[i] + area[rest] - inter)
        order = rest[o <= threshold]
    return np.asarray(pick, dtype=np.int64)
