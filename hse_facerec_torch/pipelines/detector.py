"""MTCNN face-detection cascade in PyTorch.

Counterpart of ``hse_facerec_tf_tpu/pipelines/detector.py``, with the same
conventions: transposed-feed orientation, 1-indexed box math, ``np.fix``
truncation, zero-padded out-of-image crops, thresholds [0.6, 0.7, 0.9],
pyramid factor 0.709, NMS 0.5/0.7 'Union' and 0.7 'Min'. Every stage keeps
the reference's fixed box caps (``caps_for``), so the stage-2 and stage-3
crops always cover ``max_stage2`` and ``max_stage3`` boxes, valid or not,
and outputs compare slot for slot with the JAX package. The stage-2/3 crops
go through the CUDA kernel K1 on a CUDA device and through its plain twin
on the CPU (``ops/kernels/crop.py``).

The cascade runs on one image or on a batch of same-size images
(``detect_batch_core``, the JAX package's vmapped ``detect_batch_fn``): a
leading lane dimension through every stage, one P-Net call per pyramid
level and one K1 launch per crop stage for the whole batch.

Host API: ``MTCNNDetector.detect(img)`` takes an RGB numpy image and returns
(boxes (n, 5) [x1, y1, x2, y2, score], landmarks (10, n));
``detect_batch(images)`` does the same for each image of a batch.
"""

from __future__ import annotations

import warnings
from typing import List, Tuple

import numpy as np
import torch

from ..models import mtcnn as nets
from ..numerics import fma, fp32_precision
from ..ops import boxes as B
from ..ops.kernels.crop import crop_resize
from ..ops.nms import nms_mask
from ..ops.preprocess import normalize_mtcnn
from ..ops.resize import resize_pyramid
from ..params import to_torch


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and
    absent, so nothing quietly runs on the CPU instead."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device


def to_host(tensors) -> List[np.ndarray]:
    """Device tensors -> numpy arrays in one device-to-host copy: every
    tensor goes into one flat float32 buffer (bool and integer values below
    2^24 are exact there) and comes back in its own shape and dtype."""
    tensors = list(tensors)
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    flat = flat.cpu().numpy()
    out, off = [], 0
    for t in tensors:
        n = t.numel()
        dtype = {torch.bool: np.bool_, torch.int32: np.int32,
                 torch.int64: np.int64}.get(t.dtype, np.float32)
        out.append(flat[off:off + n].astype(dtype).reshape(tuple(t.shape)))
        off += n
    return out


def pyramid_scales(h: int, w: int, minsize: int, factor: float = 0.709) -> List[float]:
    """Static scale pyramid (reference :489-497)."""
    m = 12.0 / minsize
    minl = min(h, w) * m
    scales = []
    k = 0
    while minl >= 12:
        scales.append(m * (factor ** k))
        minl *= factor
        k += 1
    return scales


class MTCNNDetector:
    """Three-stage MTCNN on one device.

    Args:
      params: {'pnet','rnet','onet'} numpy pytrees in the reference's
        layouts (``models/mtcnn.py::import_mtcnn_params``).
      device: where the cascade runs ('cuda', 'cpu', ...).
      minsize, thresholds, factor: cascade constants (reference :37,481-483).
      max_level_boxes, max_stage2, max_stage3: fixed box caps per stage.
      supersample: sub-samples per axis of the stage-2/3 crops.
      max_escalations: cap-doubling retries when a cap dropped candidates.
      precision: the tier of the P/R/O-Net forwards (``numerics``;
        "highest" by default, where the reference defaults to HIGH, which
        is f32-exact only on its chip). The pyramid resize always runs
        "highest": its pixels are rounded to integers on .5 boundaries
        that TF32 error would flip. The stage-2/3 crops (K1) are exact
        float32 multiply-adds at every tier.
    """

    def __init__(self, params, device="cuda", minsize: int = 40,
                 thresholds=(0.6, 0.7, 0.9), factor: float = 0.709,
                 max_level_boxes: int = 384, max_stage2: int = 128,
                 max_stage3: int = 64, supersample: int = 2,
                 precision="highest", max_escalations: int = 2):
        fp32_precision(precision)                 # refuse an unknown tier now
        self.device = resolve_device(device)
        self.params = to_torch(params, self.device)
        self.minsize = minsize
        self.thresholds = thresholds
        self.factor = factor
        self.max_level_boxes = max_level_boxes
        self.max_stage2 = max_stage2
        self.max_stage3 = max_stage3
        self.supersample = supersample
        self.precision = precision
        self.max_escalations = max_escalations
        self.last_truncated = False

    def caps_for(self, h: int, w: int, tier: int = 0) -> Tuple[int, int, int]:
        """(max_level_boxes, max_stage2, max_stage3) for an (h, w) image:
        the caps scale with the area above 640x480 (clamped at 16x) and
        double per escalation ``tier``, each under an absolute ceiling
        (8192 / 2048 / 1024) that keeps the O(N²) NMS matrices bounded."""
        scale = min(16.0, max(1.0, (h * w) / (640.0 * 480.0))) * (2.0 ** tier)
        if scale == 1.0:
            return self.max_level_boxes, self.max_stage2, self.max_stage3
        # explicit ctor values above a ceiling are respected (never reduced)
        up = lambda v, ceil: min(max(ceil, v), int(np.ceil(v * scale / 32.0) * 32))
        return (up(self.max_level_boxes, 8192), up(self.max_stage2, 2048),
                up(self.max_stage3, 1024))

    # ---------- stage 1 ----------
    # The stages take one image (H, W, C) or a batch (L, H, W, C); every
    # per-image tensor then carries the same leading lane dimension, and
    # each lane is computed as it would be on its own.

    def _stage1(self, img_f, h, w, scales, max_level, max_s2):
        """All pyramid levels + per-level NMS + global NMS + refine. Also
        returns ``truncated``, a bool tensor per image: True when a cap
        dropped candidates that the reference's unbounded lists would have
        kept."""
        th1 = self.thresholds[0]
        lead = img_f.shape[:-3]
        truncated = torch.zeros(lead, dtype=torch.bool, device=self.device)
        all_boxes, all_scores, all_regs, all_valid = [], [], [], []
        sizes = [(int(np.ceil(h * s)), int(np.ceil(w * s))) for s in scales]
        levels = resize_pyramid(img_f, sizes)
        for scale, level in zip(scales, levels):
            # the reference resizes the uint8 image (facial_analysis.py:505),
            # so level pixels are rounded to integers before normalization
            level = normalize_mtcnn(torch.clamp(torch.round(level), 0.0, 255.0))
            # transposed-feed convention: first spatial axis = image x
            level_t = level.transpose(-3, -2)
            reg_map, prob_map = nets.pnet(self.params["pnet"],
                                          level_t if lead else level_t[None],
                                          precision=self.precision)
            reg_map = reg_map.reshape(*lead, *reg_map.shape[1:])
            prob_map = prob_map[..., 1].reshape(*lead, *prob_map.shape[1:3])
            kmax = min(max_level, prob_map.shape[-2] * prob_map.shape[-1])
            truncated |= torch.sum(prob_map > th1, dim=(-2, -1)) > kmax
            boxes, scores, regs, valid = B.generate_boxes(
                prob_map, reg_map, scale, th1, kmax)
            keep = nms_mask(boxes, scores, valid, 0.5, "union")
            all_boxes.append(boxes)
            all_scores.append(scores)
            all_regs.append(regs)
            all_valid.append(valid & keep)
        boxes = torch.cat(all_boxes, dim=-2)
        scores = torch.cat(all_scores, dim=-1)
        regs = torch.cat(all_regs, dim=-2)
        valid = torch.cat(all_valid, dim=-1)
        # bound the global-NMS candidate set (its overlap matrix is O(N²))
        max_global = min(boxes.shape[-2], 4 * max_s2)
        truncated |= torch.sum(valid, dim=-1) > max_global
        boxes, scores, valid, regs = B.select_top(boxes, scores, valid, regs,
                                                  max_global)
        keep = nms_mask(boxes, scores, valid, 0.7, "union")
        truncated |= torch.sum(valid & keep, dim=-1) > max_s2
        boxes, scores, valid, regs = B.select_top(boxes, scores, valid & keep,
                                                  regs, max_s2)
        boxes = B.bbreg_stage1(boxes, regs)
        boxes = B.fix(B.rerec(boxes))
        return boxes, scores, valid, truncated

    # ---------- stages 2 & 3 ----------

    def _crop_batch(self, img_f, boxes, out_size):
        """1-indexed [x1,y1,x2,y2] (..., K, 4) -> zero-padded crops
        (L·K, out, out, 3), transposed-feed: one K1 launch for every
        image."""
        # 0-indexed half-open crop rect: rows [y1-1, y2), cols [x1-1, x2)
        rect = torch.stack([boxes[..., 1] - 1.0, boxes[..., 0] - 1.0,
                            boxes[..., 3], boxes[..., 2]], dim=-1)
        crops = crop_resize(img_f, rect, out_size, self.supersample, "zero")
        crops = crops.reshape(-1, out_size, out_size, crops.shape[-1])
        return normalize_mtcnn(crops).permute(0, 2, 1, 3)  # swap spatial axes

    def _stage2(self, img_f, boxes, valid, max_s3):
        th2 = self.thresholds[1]
        lead = boxes.shape[:-1]
        crops = self._crop_batch(img_f, boxes, 24)
        regs, probs = nets.rnet(self.params["rnet"], crops, precision=self.precision)
        regs, scores = regs.reshape(*lead, 4), probs[:, 1].reshape(lead)
        valid = valid & (scores > th2)
        keep = nms_mask(boxes, scores, valid, 0.7, "union")
        truncated = torch.sum(valid & keep, dim=-1) > max_s3
        boxes, scores, valid, regs = B.select_top(boxes, scores, valid & keep,
                                                  regs, max_s3)
        boxes = B.bbreg(boxes, regs)
        boxes = B.fix(B.rerec(boxes))
        return boxes, scores, valid, truncated

    def _stage3(self, img_f, boxes, valid):
        th3 = self.thresholds[2]
        lead = boxes.shape[:-1]
        crops = self._crop_batch(img_f, boxes, 48)
        regs, lmks, probs = nets.onet(self.params["onet"], crops,
                                      precision=self.precision)
        regs, lmks = regs.reshape(*lead, 4), lmks.reshape(*lead, 10)
        scores = probs[:, 1].reshape(lead)
        valid = valid & (scores > th3)
        w = boxes[..., 2] - boxes[..., 0] + 1.0
        h = boxes[..., 3] - boxes[..., 1] + 1.0
        points_x = fma(w[..., None], lmks[..., 0:5], boxes[..., 0:1]) - 1.0
        points_y = fma(h[..., None], lmks[..., 5:10], boxes[..., 1:2]) - 1.0
        points = torch.cat([points_x, points_y], dim=-1)
        boxes = B.bbreg(boxes, regs)
        keep = nms_mask(boxes, scores, valid, 0.7, "min")
        return boxes, scores, points, valid & keep

    # ---------- full pipeline ----------

    @torch.no_grad()
    def detect_core(self, img, tier: int = 0):
        """The padded cascade on one image tensor (H, W, 3), or a batch
        (L, H, W, 3), on the detector's device: (boxes (n, 4), scores (n,),
        points (n, 10), valid (n,), truncated ()), each with a leading L
        for a batch, n = the stage-3 cap of ``tier``."""
        h, w = img.shape[-3], img.shape[-2]
        lead = img.shape[:-3]
        img_f = img.to(torch.float32).contiguous()
        max_level, max_s2, max_s3 = self.caps_for(h, w, tier)
        scales = pyramid_scales(h, w, self.minsize, self.factor)
        if not scales:
            z = lambda *s: torch.zeros((*lead, *s), device=self.device)
            return (z(max_s3, 4), z(max_s3), z(max_s3, 10), z(max_s3).bool(),
                    z().bool())
        boxes, scores, valid, trunc1 = self._stage1(img_f, h, w, scales,
                                                    max_level, max_s2)
        boxes, scores, valid, trunc2 = self._stage2(img_f, boxes, valid, max_s3)
        boxes, scores, points, valid = self._stage3(img_f, boxes, valid)
        return boxes, scores, points, valid, trunc1 | trunc2

    def detect_batch_core(self, imgs, tier: int = 0):
        """``detect_core`` over a batch (L, H, W, 3): P-Net runs each pyramid
        level once for all L images, stages 2 and 3 crop every image's boxes
        in one K1 launch each, and R-Net and O-Net run on the L·K crops.
        ``truncated`` is per image, (L,)."""
        if imgs.dim() != 4:
            raise ValueError(f"detect_batch_core takes (L, H, W, 3), got {tuple(imgs.shape)}")
        return self.detect_core(imgs, tier)

    def upload(self, img: np.ndarray) -> torch.Tensor:
        """Host RGB image -> tensor on the detector's device."""
        return torch.from_numpy(np.ascontiguousarray(img)).to(self.device)

    def _warn_truncated(self, truncated: bool, caps=None) -> None:
        self.last_truncated = truncated
        if truncated:
            lvl, s2, s3 = caps or (self.max_level_boxes, self.max_stage2,
                                   self.max_stage3)
            warnings.warn(
                "MTCNN box budget saturated: some candidates were dropped "
                f"(effective caps: level={lvl}, stage2={s2}, stage3={s3}). "
                "The reference cascade is unbounded — raise max_escalations "
                "or max_stage2/max_stage3 for crowd photos.",
                RuntimeWarning, stacklevel=3)

    def detect(self, img: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """RGB (H, W, 3) image -> (boxes (n, 5), landmarks (10, n)).

        When a box cap saturates, retries at doubled-cap tiers up to
        ``max_escalations``; sets ``last_truncated`` and warns only if the
        top tier still truncates."""
        h, w = img.shape[:2]
        dev = self.upload(img)
        for tier in range(self.max_escalations + 1):
            boxes, scores, points, valid, truncated = to_host(
                self.detect_core(dev, tier))
            if (not truncated or tier == self.max_escalations
                    or self.caps_for(h, w, tier + 1) == self.caps_for(h, w, tier)):
                break
        self._warn_truncated(bool(truncated), self.caps_for(h, w, tier))
        out = np.concatenate([boxes[valid], scores[valid][:, None]], axis=1)
        return out, points[valid].T

    def detect_batch(self, images: np.ndarray):
        """(N, H, W, 3) uniform-size RGB batch -> a list of (boxes (n_i, 5),
        landmarks (10, n_i)) per image. One upload; escalates cap tiers on
        truncation like ``detect``, the whole batch re-running at the
        higher tier."""
        images = np.asarray(images)
        h, w = images.shape[1], images.shape[2]
        dev = self.upload(images)
        for tier in range(self.max_escalations + 1):
            boxes, scores, points, valid, truncated = to_host(
                self.detect_batch_core(dev, tier))
            if (not truncated.any() or tier == self.max_escalations
                    or self.caps_for(h, w, tier + 1) == self.caps_for(h, w, tier)):
                break
        self._warn_truncated(bool(truncated.any()), self.caps_for(h, w, tier))
        return [(np.concatenate([b[v], s[v][:, None]], axis=1), p[v].T)
                for b, s, p, v in zip(boxes, scores, points, valid)]

    @classmethod
    def from_pb(cls, pb_path: str, **kwargs) -> "MTCNNDetector":
        return cls(nets.import_mtcnn_params(pb_path), **kwargs)
