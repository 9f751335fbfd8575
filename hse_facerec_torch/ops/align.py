"""Batched 5-landmark similarity-transform face alignment.

Counterpart of ``hse_facerec_tf_tpu/ops/align.py``: the reference's
InsightFace alignment (``age_gender_identity/insightface.py:25-74``: a
skimage ``SimilarityTransform`` estimate, then ``cv2.warpAffine`` to the
112×112 / 112×96 ArcFace landmark template). Both steps are closed-form
and run batched over faces on the image's device in plain torch, in
elementwise float32 operations that round alike on the card and on the
CPU: Umeyama's least-squares similarity (what skimage computes) in the
closed form of its 2×2 SVD, and an inverse-affine bilinear gather with
zeros outside the image (cv2's ``borderValue=0``). The augmentation warp K3 does not fit
here: it rounds its taps to bf16.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..numerics import div_const
from ..pipelines.detector import resolve_device

# ArcFace 112×96 template (reference :38-45); x += 8 for 112×112 (:44-45).
ARCFACE_TEMPLATE_96 = np.array([
    [30.2946, 51.6963],
    [65.5318, 51.5014],
    [48.0252, 71.7366],
    [33.5493, 92.3655],
    [62.7299, 92.2041]], dtype=np.float32)


def arcface_template(width: int = 112) -> np.ndarray:
    t = ARCFACE_TEMPLATE_96.copy()
    if width == 112:
        t[:, 0] += 8.0
    return t


def _sum_points(x):
    """Σ over the point axis (-2), added point by point: the same float32
    additions on every device (a reduction kernel's order is its own)."""
    total = x[..., 0, :]
    for k in range(1, x.shape[-2]):
        total = total + x[..., k, :]
    return total


def estimate_similarity(src, dst):
    """Umeyama similarity estimates mapping ``src`` -> ``dst``: (..., K, 2)
    point sets (``dst`` broadcasts, e.g. one (K, 2) template) -> (..., 2, 3)
    affines [sR | t] minimizing Σ ||dst - (sR·src + t)||², R a rotation
    (the reference's reflection handling: ``u·diag(1, d)·vt`` with ``d =
    sign(det u · det vt)`` is always a proper rotation).

    The reference takes R and ``Σ s·diag`` from a 2×2 SVD of the
    covariance [[a, b], [c, d]]; in closed form the rotation maximizing
    ``trace(Rᵀ·cov)`` is cos θ = p/n, sin θ = q/n with p = a + d, q = c - b,
    n = √(p² + q²), and ``Σ s·diag`` is n. Only +, -, ×, ÷ and √ remain,
    each correctly rounded, so the card and the CPU give the same bits (a
    division by the point count is a multiply by its float32 reciprocal,
    ``numerics.div_const``: torch divides by a scalar so on the card and
    exactly on the CPU).
    Points all equal (cov = 0, n = 0) give scale 0 (the variance is clamped
    at 1e-12) and the template's mean as the shift: ``[0 | mu_dst]``, a
    singular map whose warp is NaN, as the reference's is."""
    src = src.to(torch.float32)
    dst = dst.to(torch.float32)
    k = src.shape[-2]
    mu_s = div_const(_sum_points(src), k)
    mu_d = div_const(_sum_points(dst), k)
    sc = src - mu_s[..., None, :]
    dc = dst - mu_d[..., None, :]
    cov = [[div_const(_sum_points(dc[..., i:i + 1] * sc[..., j:j + 1])[..., 0], k)
            for j in (0, 1)] for i in (0, 1)]
    p = cov[0][0] + cov[1][1]
    q = cov[1][0] - cov[0][1]
    n = torch.sqrt(p * p + q * q)
    degenerate = n == 0
    safe = torch.where(degenerate, torch.ones_like(n), n)
    cos = torch.where(degenerate, torch.ones_like(n), p / safe)
    sin = torch.where(degenerate, torch.zeros_like(n), q / safe)
    var_s = _sum_points(sc * sc)
    var_s = div_const(var_s[..., 0] + var_s[..., 1], k)
    scale = n / torch.clamp(var_s, min=1e-12)
    tx = mu_d[..., 0] - scale * (cos * mu_s[..., 0] - sin * mu_s[..., 1])
    ty = mu_d[..., 1] - scale * (sin * mu_s[..., 0] + cos * mu_s[..., 1])
    row0 = torch.stack([scale * cos, -(scale * sin), tx], dim=-1)
    row1 = torch.stack([scale * sin, scale * cos, ty], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def warp_affine(img, m, out_hw: Tuple[int, int]):
    """``cv2.warpAffine`` semantics for (N, 2, 3) affines ``m`` mapping src
    -> dst: each (out_h, out_w) output samples (H, W, C) ``img`` at m⁻¹·(x,
    y, 1), bilinear in float32, taps outside the image read 0 (a zero ring,
    so border pixels blend partially with black, as cv2's BORDER_CONSTANT
    does). Returns (N, out_h, out_w, C) on ``img``'s device."""
    H, W = img.shape[0], img.shape[1]
    oh, ow = out_hw
    img = img.to(torch.float32)
    m = m.to(torch.float32)
    a, t = m[:, :, :2], m[:, :, 2]
    det = a[:, 0, 0] * a[:, 1, 1] - a[:, 0, 1] * a[:, 1, 0]
    inv_a = torch.stack([torch.stack([a[:, 1, 1], -a[:, 0, 1]], dim=-1),
                         torch.stack([-a[:, 1, 0], a[:, 0, 0]], dim=-1)], dim=1) \
        / det[:, None, None]
    inv_t = -(inv_a[:, :, 0] * t[:, 0, None] + inv_a[:, :, 1] * t[:, 1, None])

    ys = torch.arange(oh, dtype=torch.float32, device=img.device)
    xs = torch.arange(ow, dtype=torch.float32, device=img.device)
    gx, gy = torch.meshgrid(xs, ys, indexing="xy")                 # (oh, ow)

    def coord(i):
        return (inv_a[:, i, 0, None, None] * gx + inv_a[:, i, 1, None, None] * gy
                + inv_t[:, i, None, None])

    sx, sy = coord(0), coord(1)
    x0, y0 = torch.floor(sx), torch.floor(sy)
    wx, wy = sx - x0, sy - y0
    img_p = F.pad(img, (0, 0, 1, 1, 1, 1))                          # the zero ring

    def at(yi, xi):
        yi = torch.clamp(yi.long() + 1, 0, H + 1)
        xi = torch.clamp(xi.long() + 1, 0, W + 1)
        return img_p[yi, xi]

    return (at(y0, x0) * ((1 - wx) * (1 - wy))[..., None]
            + at(y0, x0 + 1) * (wx * (1 - wy))[..., None]
            + at(y0 + 1, x0) * ((1 - wx) * wy)[..., None]
            + at(y0 + 1, x0 + 1) * (wx * wy)[..., None])


def align_faces(img, landmarks, out_size: int = 112, device="cuda"):
    """Align each face to the ArcFace template on ``device``.

    img: (H, W, 3) image (numpy or a tensor); landmarks: (N, 5, 2) [x, y]
    points (e.g. ``landmarks_from_detector`` of the detector's). Returns
    (N, out_size, out_size, 3) float32."""
    device = resolve_device(device)
    img = torch.as_tensor(img, device=device)
    landmarks = torch.as_tensor(landmarks, dtype=torch.float32, device=device)
    template = torch.from_numpy(arcface_template(out_size)).to(device)
    return warp_affine(img, estimate_similarity(landmarks, template), (out_size, out_size))


def landmarks_from_detector(points: np.ndarray) -> np.ndarray:
    """Detector landmark layout (N, 10) [x0..x4, y0..y4] -> (N, 5, 2)."""
    points = np.asarray(points)
    return np.stack([points[:, 0:5], points[:, 5:10]], axis=-1)
